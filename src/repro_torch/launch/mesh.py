"""Device slots and replica sub-meshes (the port's ``repro.launch.mesh``).

The reference carves JAX devices into disjoint ``("data", "model")``
meshes, one per serving replica, and its CPU tests get several devices from
``XLA_FLAGS=--xla_force_host_platform_device_count=N``. torch has one CPU
device and a machine may have one card, so the port carves **slots**:
numbered entries ``(id, torch.device)``, each playing the part of one JAX
device id. :func:`visible_devices` gives one slot per CUDA device;
:func:`virtual_devices` gives ``n`` slots on one physical device (the
counterpart of the forced host device count, and nothing more).

A :class:`SubMesh` is a ``(data, model)`` grid of slots. The fleet runs its
replicas as threads of one process, and a tensor-parallel replica is a
process group of its own, so :func:`carve_submeshes` serves ``model == 1``
only (ROADMAP A12.2c).

Sharded serving runs one ``torch.distributed`` rank per mesh position:
:func:`make_mesh`, :func:`make_serve_mesh` and
:func:`make_production_mesh` build a
:class:`~repro_torch.parallel.comm.RankMesh` over the initialized world
(``repro_torch.parallel.comm.launch`` starts the ranks).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Slot", "SubMesh", "visible_devices", "virtual_devices",
           "carve_submeshes", "batch_axes", "make_mesh", "make_serve_mesh",
           "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Slot:
    """One numbered device slot: the fleet's unit of placement and of
    failure (a poisoned slot id is excluded on rebuild)."""
    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True, eq=False)
class SubMesh:
    """A ``(data, model)`` grid of slots.

    ``devices`` is the ``(data, model)`` object array of :class:`Slot`;
    ``shape`` maps axis name to width (``dict(mesh.shape)`` as in JAX).
    With ``model == 1`` the engine runs on the first slot's ``device``: the
    deterministic layout replicates every batch-indexed activation over the
    data axis (the reference's ``shard_batch=False``), so each data slot
    would compute the same program, and the port computes it once.
    """
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def ids(self) -> List[int]:
        return [s.id for s in self.devices.flat]

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0].device


def visible_devices() -> List[Slot]:
    """One slot per visible CUDA device, ids ``0..n-1``; raises without
    CUDA (the port never falls back to the CPU unasked)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the fleet carves the visible cards by default; "
            "pass devices=virtual_devices('cpu', n) to run on the CPU")
    return [Slot(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def virtual_devices(device, n: int) -> List[Slot]:
    """``n`` slots, ids ``0..n-1``, all on the one physical ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return [Slot(i, dev) for i in range(int(n))]


def carve_submeshes(replicas: int, *, model_parallel: Optional[int] = None,
                    devices: Optional[Sequence[Slot]] = None,
                    exclude=()) -> List[SubMesh]:
    """Partition the slots into ``replicas`` disjoint serving sub-meshes.

    Args:
      replicas: number of sub-meshes R. Must divide the slot count.
      model_parallel: model axis width of each sub-mesh; default all of the
        replica's slots (the reference's pure tensor parallelism). Must
        divide the slots per replica; only 1 is served (a tensor-parallel
        replica is a process group: ROADMAP A12.2c).
      devices: the slots to carve (default :func:`visible_devices`), in
        contiguous runs per replica.
      exclude: slot ids to drop before carving (known-bad slots); the
        remaining count must still divide evenly.

    Returns R sub-meshes of shape ``(per // model_parallel,
    model_parallel)``, ``per = slots // replicas``, with disjoint slots.
    """
    devs = list(devices) if devices is not None else visible_devices()
    if exclude:
        bad = set(exclude)
        devs = [d for d in devs if d.id not in bad]
    n = len(devs)
    if replicas < 1 or n % replicas:
        raise ValueError(f"replicas={replicas} does not divide the "
                         f"{n} visible devices")
    per = n // replicas
    mp = model_parallel if model_parallel is not None else per
    if mp < 1 or per % mp:
        raise ValueError(f"model_parallel={mp} does not divide the "
                         f"{per} devices per replica")
    if mp > 1:
        raise NotImplementedError(
            f"model_parallel={mp}: a tensor-parallel replica is a process "
            "group of its own, and the fleet runs its replicas as threads "
            "of one process (ROADMAP A12.2c); pass model_parallel=1")
    return [SubMesh(np.asarray(devs[r * per:(r + 1) * per], dtype=object)
                    .reshape(per // mp, mp))
            for r in range(replicas)]


def batch_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_mesh(shape, axes, *, device=None):
    """A mesh of the world's ranks (``parallel.comm.RankMesh``): rank ``r``
    at row-major position ``r`` of ``shape``. Raises unless the world has
    exactly ``prod(shape)`` ranks (one rank needs no process group)."""
    from repro_torch.parallel.comm import RankMesh
    return RankMesh(tuple(shape), tuple(axes), device=device)


def make_serve_mesh(model_parallel: Optional[int] = None, *, device=None):
    """The ``(data, model)`` serving mesh over every rank of the world:
    ``model_parallel`` (default: all ranks, pure tensor parallelism) must
    divide the world size; the rest is the data axis."""
    import torch.distributed as dist
    n = (dist.get_world_size() if dist.is_available()
         and dist.is_initialized() else 1)
    mp = model_parallel if model_parallel is not None else n
    if mp < 1 or n % mp:
        raise ValueError(f"model_parallel={mp} does not divide the "
                         f"{n} visible devices")
    return make_mesh((n // mp, mp), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production topology over the world's ranks:
    ``(data=16, model=16)``, with a leading ``pod=2`` axis for two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
