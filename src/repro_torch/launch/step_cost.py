"""The cost of a real port step, recorded as it runs: the port's
counterpart of ``repro.launch.hlo_cost``.

The reference compiles a step and reads its cost from the HLO text. The
port runs eagerly, so it records the step instead (:func:`record`):

* **FLOPs**: every dot that reaches ATen's dispatcher (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``dot``, ``mv``) contributes 2 x result
  elements x contracting size, as ``hlo_cost`` counts an HLO ``dot``;
  element-wise FLOPs are ignored. A call of a hand-written kernel's
  wrapper counts its own product, ``2 x Bt x M x N x K`` (B1-B5 and
  their partials entries over a cut of K; the entries that close a cut,
  B1's flush and B5's combine, none; B2 its two contractions over the
  live keys), and nothing inside it: on the
  CPU the wrapper runs its plain twin, whose limb products are the
  kernel's arithmetic, not the model's.
* **Dot bytes**: the two operands and the result of each of those dots.
* **Kernel calls**: each wrapper call that launches on the card, by its
  ``LAUNCHES`` entry, with its shape and its bound from
  :mod:`repro_torch.launch.roofline` (a CPU tensor runs the twin; the
  entry and the shape are the ones the card would launch).
* **Collectives**: every ``RankMesh`` collective by op, payload and group
  size (``parallel.comm.comm_listener``), and their ring traffic.

Dispatch modes are per thread: record the thread that runs the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline as rl
from repro_torch.parallel.comm import comm_listener

__all__ = ["KernelCall", "StepCost", "record"]

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default, _aten.dot.default, _aten.mv.default}
# ops whose two matrix operands follow a bias / accumulator argument
_WITH_INPUT = {_aten.addmm.default, _aten.baddbmm.default}


@dataclasses.dataclass
class KernelCall:
    entry: str                   # the ``LAUNCHES`` key it counts under
    shape: Tuple[int, ...]       # (Bt, M, K, N); B2 (N, T, D, keys, table)
    flops: float
    bound_ms: float
    bound_by: str


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    dot_bytes: float = 0.0
    n_dots: int = 0
    kernels: List[KernelCall] = dataclasses.field(default_factory=list)
    collectives: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k in self.kernels:
            out[k.entry] = out.get(k.entry, 0) + 1
        return out

    @property
    def kernel_bound_ms(self) -> float:
        """The step's kernels back to back at their bounds."""
        return sum(k.bound_ms for k in self.kernels)

    def traffic(self) -> rl.CollectiveStats:
        return rl.collective_traffic(self.collectives)

    def to_json(self) -> dict:
        coll = self.traffic()
        return {"flops": self.flops, "dot_bytes": self.dot_bytes,
                "n_dots": self.n_dots, "launches": self.launches,
                "kernel_bound_ms": self.kernel_bound_ms,
                "collective_bytes": coll.bytes_per_device,
                "collective_per_op": coll.per_op,
                "collective_counts": coll.counts}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_cost(func, args, out) -> Tuple[float, float]:
    a, b = args[1:3] if func in _WITH_INPUT else args[:2]
    k = a.shape[-1]
    return 2.0 * out.numel() * k, float(_nbytes(a) + _nbytes(b)
                                        + _nbytes(out))


class _Dots(TorchDispatchMode):
    def __init__(self, cost: StepCost, inside: threading.local):
        super().__init__()
        self.cost, self.inside = cost, inside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS and not getattr(self.inside, "depth", 0):
            flops, nbytes = _dot_cost(func, args, out)
            self.cost.flops += flops
            self.cost.dot_bytes += nbytes
            self.cost.n_dots += 1
        return out


def _mm_shape(x, w) -> Tuple[int, int, int, int]:
    Bt, M, K = x.shape if x.dim() == 3 else (1, *x.shape)
    return Bt, M, K, w.shape[-1]


def _b1(x_codes, w_codes, *a, schedule="output", **kw):
    entry = ("mgs_matmul_exact_fused" if schedule == "output"
             else "mgs_matmul_exact_fused_stationary")
    shape = _mm_shape(x_codes, w_codes)
    if not (shape[0] and shape[1] and shape[3] and shape[2]):
        return None
    return entry, shape, rl.b1_bound(*shape)


def _partials(x_codes, w_codes, *a, block_k=128, flush_period=None,
              k_total=None, schedule="output", **kw):
    from repro_torch.kernels.mgs_matmul import partial_segments
    entry = ("mgs_matmul_exact_partials" if schedule == "output"
             else "mgs_matmul_stationary_partials")
    shape = _mm_shape(x_codes, w_codes)
    if not (shape[0] and shape[1] and shape[3]):
        return None
    _, nseg = partial_segments(shape[2] if k_total is None else k_total,
                               block_k, flush_period)
    return entry, shape, rl.b1_partials_bound(*shape, nseg)


def _stored(*vs) -> int:
    """The elements a closing entry's scale and bias hold as stored."""
    return sum(torch.as_tensor(v).numel() for v in vs if v is not None)


def _flush(partials, *a, scale=None, bias=None, **kw):
    nseg, _, Bt, M, N = partials.shape
    if not (Bt and M and N):
        return None
    return ("mgs_matmul_exact_flush", (Bt, M, 0, N),
            rl.b1_flush_bound(Bt, M, N, nseg, _stored(scale, bias)))


def _b4(x_limbs, w_limbs, *a, **kw):
    Bt, M, K = ((x_limbs.shape[0],) + tuple(x_limbs.shape[2:])
                if x_limbs.dim() == 4 else (1, *x_limbs.shape[1:]))
    shape = (Bt, M, K, w_limbs.shape[-1])
    if not all(shape):
        return None
    return "mgs_matmul_exact", shape, rl.b4_bound(*shape)


def _b4_partials(x_limbs, w_limbs, fmt=None, *a, block_k=128,
                 flush_period=None, k_total=None, **kw):
    from repro_torch.kernels.mgs_matmul import partial_segments
    Bt, M, K = ((x_limbs.shape[0],) + tuple(x_limbs.shape[2:])
                if x_limbs.dim() == 4 else (1, *x_limbs.shape[1:]))
    shape = (Bt, M, K, w_limbs.shape[-1])
    if not (Bt and M and shape[3] and K):
        return None
    _, nseg = partial_segments(K if k_total is None else k_total, block_k,
                               flush_period)
    return ("mgs_matmul_exact_limb_partials", shape,
            rl.b4_partials_bound(*shape, nseg))


def _b5(x, w, *a, **kw):
    shape = _mm_shape(x, w)
    if not all(shape):
        return None
    return "mgs_matmul_dmac", shape, rl.dmac_bound(*shape)


def _b5_partials(xc, wc, fmt, *a, **kw):
    shape = _mm_shape(xc, wc)
    if not (shape[0] and shape[1] and shape[3]):
        return None
    return ("mgs_matmul_dmac_partials", shape,
            rl.dmac_partials_bound(*shape, fmt.n_bins))


def _b5_combine(bins, *a, scale=None, bias=None, **kw):
    Bt, M, N, nb = bins.shape
    if not (Bt and M and N):
        return None
    return ("mgs_matmul_dmac_combine", (Bt, M, 0, N),
            rl.dmac_combine_bound(Bt, M, N, nb, _stored(scale, bias)))


def _b2(q_codes, k_pool, v_pool, bt, live, qk_scale, *a, **kw):
    N, T, D = q_codes.shape
    if not N:
        return None
    chunk = k_pool.shape[1]
    keys = int(((live.to(torch.int64) + chunk - 1) // chunk * chunk).sum())
    shape = (N, T, D, keys, bt.numel())
    return "mgs_flash_attention", shape, rl.b2_bound(
        *shape, scale_rows=qk_scale.shape[1])


# the wrappers that launch a kernel on the card: module, name, shape reader
_ENTRIES = (("repro_torch.kernels.mgs_matmul", "mgs_matmul_exact_fused", _b1),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_exact_partials",
             _partials),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_exact_flush",
             _flush),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_exact", _b4),
            ("repro_torch.kernels.mgs_matmul",
             "mgs_matmul_exact_limb_partials", _b4_partials),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_dmac_partials",
             _b5_partials),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_dmac_combine",
             _b5_combine),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_dmac_codes", _b5),
            ("repro_torch.kernels.mgs_matmul", "mgs_matmul_dmac", _b5),
            ("repro_torch.kernels.mgs_attention", "mgs_flash_blocks", _b2))


def _kernel_flops(entry: str, shape) -> float:
    if entry == "mgs_flash_attention":
        N, T, D, keys, _ = shape
        return 2 * 2.0 * T * D * keys
    if entry in ("mgs_matmul_exact_flush", "mgs_matmul_dmac_combine"):
        return 0.0
    Bt, M, K, N = shape
    return 2.0 * Bt * M * N * K


def _wrap(fn, reader, cost: StepCost, inside: threading.local):
    def call(*args, **kwargs):
        depth = getattr(inside, "depth", 0)
        got = None if depth else reader(*args, **kwargs)
        inside.depth = depth + 1
        try:
            return fn(*args, **kwargs)
        finally:
            inside.depth = depth
            if got is not None:
                entry, shape, (ms, by) = got
                flops = _kernel_flops(entry, shape)
                cost.flops += flops
                cost.kernels.append(KernelCall(
                    entry, tuple(int(s) for s in shape), flops, ms, by))
    call.__wrapped__ = fn
    return call


@contextlib.contextmanager
def record(cost: Optional[StepCost] = None):
    """Record the dots, kernel calls and collectives of the code run in
    the block (this thread) into a :class:`StepCost`, which it yields.

    Each kernel wrapper is replaced where the port's modules bound it
    (its own module and every module that imported it by name) for the
    block's length, and restored after."""
    import importlib
    cost = StepCost() if cost is None else cost
    inside = threading.local()
    originals = {name: getattr(importlib.import_module(mod), name)
                 for mod, name, _ in _ENTRIES}
    wrapped = {name: _wrap(originals[name], reader, cost, inside)
               for _, name, reader in _ENTRIES}
    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("repro_torch"):
            continue
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                setattr(mod, name, wrapped[name])
                patched.append((mod, name, fn))
    try:
        with comm_listener(lambda kind, nb, g: cost.collectives.append(
                (kind, nb, g))), _Dots(cost, inside):
            yield cost
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
