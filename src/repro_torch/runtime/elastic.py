"""Elastic re-meshing and resharding (the port of
``repro.runtime.elastic``).

Checkpoints store whole (global) leaves (``runtime.checkpoint``), so
scaling is: (1) pick a new mesh from the surviving slots, keeping the model
axis intact (the data axis is the elastic one): :func:`make_elastic_mesh`;
(2) start a rank per position of it and resolve the same rules there; (3)
hand each rank its slice on restore (``checkpoint.restore(...,
shardings=)``) or from a host tree (:func:`reshard`). The data pipeline is
step-indexed, so the token stream is unchanged under re-sharding.

A replica whose slots fail is rebuilt on the survivors of its own
sub-mesh (:func:`replacement_mesh`: the data axis shrinks to a divisor of
its old width). :func:`plan_mesh` is the reference's arithmetic; both
meshes are :class:`~repro_torch.launch.mesh.SubMesh` slot grids.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import SubMesh, visible_devices
from repro_torch.parallel.sharding import local_slices
from repro_torch.tree import tree_map

__all__ = ["plan_mesh", "make_elastic_mesh", "reshard", "replacement_mesh"]


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


def make_elastic_mesh(model_parallel: int,
                      devices: Optional[Sequence] = None,
                      exclude: Sequence[int] = ()) -> SubMesh:
    """The largest healthy mesh: the slots (default
    :func:`~repro_torch.launch.mesh.visible_devices`) but the ids in
    ``exclude``, shaped by :func:`plan_mesh` (excess slots idle). The
    ranks of the new mesh are then started, one a slot
    (``parallel.comm.launch``)."""
    devs = list(devices if devices is not None else visible_devices())
    bad = set(exclude)
    healthy = [d for d in devs if d.id not in bad]
    shape, axes = plan_mesh(len(healthy), model_parallel)
    grid = np.asarray(healthy[:math.prod(shape)], dtype=object)
    return SubMesh(grid.reshape(shape), axes)


def reshard(tree, specs, mesh):
    """A whole ``tree`` (tensors or numpy arrays) as this rank's slices on
    ``mesh`` (a ``RankMesh``) by the matching tree of specs, copied onto
    the mesh's device (the reference's ``device_put`` onto new
    shardings)."""
    def one(x, spec):
        t = torch.as_tensor(x)
        return t[local_slices(tuple(spec), tuple(t.shape), mesh)].clone().to(
            mesh.device)
    return tree_map(one, tree, specs)


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
