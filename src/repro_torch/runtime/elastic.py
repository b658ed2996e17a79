"""Elastic re-meshing over device slots (the port's ``repro.runtime.elastic``,
fleet half).

A replica whose slots fail is rebuilt on the survivors of its own
sub-mesh: the model axis keeps its width and the data axis shrinks.
:func:`plan_mesh` is the reference's arithmetic; :func:`replacement_mesh`
works on :class:`~repro_torch.launch.mesh.SubMesh` slot grids.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.mesh import SubMesh

__all__ = ["plan_mesh", "replacement_mesh"]


def plan_mesh(n_devices: int, model_parallel: int,
              multi_pod_threshold: int = 256) -> Tuple[Tuple[int, ...],
                                                       Tuple[str, ...]]:
    """Largest usable (pod?, data, model) mesh for ``n_devices``.

    Keeps the model axis fixed; data axis = largest whole multiple; excess
    devices idle.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"need at least model_parallel={model_parallel} devices")
    data = n_devices // model_parallel
    if data * model_parallel > multi_pod_threshold and data % 2 == 0:
        return ((data * model_parallel // multi_pod_threshold,
                 multi_pod_threshold // model_parallel, model_parallel),
                ("pod", "data", "model"))
    return ((data, model_parallel), ("data", "model"))


def replacement_mesh(mesh: SubMesh, exclude: Sequence[int] = (),
                     model_parallel: Optional[int] = None) -> SubMesh:
    """Largest healthy sub-mesh rebuilt from a failed one's own slots.

    Keeps the model axis width, drops the excluded (poisoned) slot ids and
    shrinks the data axis to the largest **divisor of the original data
    width** that fits the survivors (excess slots idle): the reference's
    rule, which lets existing planes move onto the replacement unchanged.
    Raises ``ValueError`` when fewer than ``model_parallel`` healthy slots
    remain (the replica is dead).
    """
    mp = (model_parallel if model_parallel is not None
          else mesh.shape.get("model", 1))
    bad = set(exclude)
    devs = [d for d in mesh.devices.flat if d.id not in bad]
    if len(devs) < mp:
        raise ValueError(
            f"only {len(devs)} healthy devices remain; need at least "
            f"model_parallel={mp}")
    old_data = mesh.shape.get("data", 1)
    data = max(len(devs) // mp, 1)
    while old_data % data:
        data -= 1
    grid = np.asarray(devs[:data * mp], dtype=object).reshape(data, mp)
    return SubMesh(grid, ("data", "model"))
