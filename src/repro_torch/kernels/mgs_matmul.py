"""The exact limb-fused FP8 matmul: the B1 and B3 kernel wrappers and
their twins.

``mgs_matmul_exact_fused`` is the port of the TPU kernels
``repro.kernels.mgs_matmul._exact_fused_kernel`` (B1,
``schedule="output"``) and ``_exact_fused_stationary_kernel`` (B3,
``schedule="weight"`` / ``"activation"``): operands arrive as packed FP8
codes (1 byte per element), each code is
decoded to the fixed-point integer ``ix = sm << max(e, 1)`` and split
into 3 balanced base-128 int8 limbs, the 9 limb-pair products accumulate
exactly into 5 int32 class sums (a + b), and every ``flush_period``
K-steps of ``block_k`` the classes are added to a float32 wide
accumulator in ascending class order. The epilogue is
``act(acc * 2^-2(bias+mbits) * scale + bias)``, every step a separate
rounding.

The stationary schedules only change the loop order: one operand's
decoded limb stripe stays resident in shared memory while the other
operand's tiles sweep past it, so every schedule gives the same bits.
Which shapes take a stationary schedule is the admission rule: a stripe
over the whole padded K (``ws_stripe_bytes``) larger than
``WS_STRIPE_BUDGET_BYTES`` raises here, and ``kernels.ops`` falls back to
``"output"`` with a warning first. On the card B3 runs B1's loop with the
cached operand's limb fragments resident for each block's part of K
(:func:`stationary_plan`), split across blocks as B1's decode splits are.

On a CUDA tensor the wrapper launches the hand-written kernels in
``csrc/mgs_matmul.cu``; on a CPU tensor it runs the plain PyTorch twins
:func:`mgs_matmul_exact_fused_plain` and
:func:`mgs_matmul_stationary_plain`, which repeat the kernels' arithmetic
op for op (``_accumulate_classes`` / ``_flush_classes``).
On the card B1, B3 and B4 run their limb products on the int8 tensor
cores, staged through an asynchronous copy ring; B1 and B4 at decode
(``M <= 16``, :func:`split_plan`) and B3 wherever its resident stripe or
the SMs ask for it (:func:`stationary_plan`) cut K across blocks: no split
crosses a flush boundary, the splits add their int32 class partials into a
workspace kept per device and stream, and the last split of each output
tile flushes the segments in ascending order. Integer sums do not depend
on their order, so this gives the twins' bits.
The twin upcasts limbs to float64 for its integer products: every product
and partial sum is an integer far below 2**53, so the float64 matmul is
exact on the CPU and on the card alike (PyTorch has no int32 matmul on
CUDA, and wraps int8 matmuls on the CPU).

Two more kernels share this module:

* ``mgs_matmul_exact`` (B4, the port of ``_exact_kernel``): the same exact
  sum from *pre-decomposed* int8 limb planes, 3 bytes per element (a
  prepared weight's ``limbs``). It runs B1's body with a staging step that
  copies limb bytes instead of decoding codes, so at equal ``block_k`` and
  ``flush_period`` it gives B1's bits. No epilogue in the kernel.
* ``mgs_matmul_dmac_codes`` (B5, the port of ``_dmac_kernel``): the
  paper's Fig. 8 numerics over packed codes. Each exact product is
  rounded back into the format (:func:`_round_decompose_e4m3`, subnormal
  gating optional), its signed mantissa added to one of ``fmt.n_bins``
  int32 exponent-bin sums, and each output combined once from zero in
  ascending bin order (``csrc/mgs_dmac.cu``, one table lookup per
  product). Its twin :func:`mgs_matmul_dmac_codes_plain` decodes the
  codes and runs :func:`mgs_matmul_dmac_plain`, which walks K and N in
  chunks, so no full ``M x K x N`` product tensor is ever held.
  ``mgs_matmul_dmac`` is the same kernel over format-exact float values
  (encoded first on the card).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import (E4M3, FPFormat, decode_bits,
                                      decode_sm_e, decompose, encode_bits,
                                      pow2)
from repro_torch.core.mgs import combine_bins
from . import _cuda

__all__ = ["ACTIVATIONS", "SCHEDULES", "WS_STRIPE_BUDGET_BYTES",
           "limb_decompose", "worst_case_flush_period", "flush_steps",
           "tile_shape", "exact_tile", "SplitPlan", "split_plan",
           "split_ranges", "StationaryPlan", "stationary_plan",
           "stationary_block", "ws_stripe_bytes",
           "check_stripe", "mgs_matmul_exact_fused",
           "mgs_matmul_exact_fused_plain", "mgs_matmul_stationary_plain",
           "mgs_matmul_exact", "mgs_matmul_exact_plain", "mgs_matmul_dmac",
           "mgs_matmul_dmac_plain", "mgs_matmul_dmac_codes",
           "mgs_matmul_dmac_codes_plain", "dmac_table", "dmac_table_plain",
           "out_scale", "partial_segments", "mgs_matmul_exact_partials",
           "mgs_matmul_exact_partials_plain", "mgs_matmul_exact_flush",
           "mgs_matmul_exact_flush_plain", "mgs_matmul_exact_limb_partials",
           "mgs_matmul_exact_limb_partials_plain", "mgs_matmul_dmac_partials",
           "mgs_matmul_dmac_partials_plain", "mgs_matmul_dmac_combine",
           "mgs_matmul_dmac_combine_plain"]

_LIMB_BASE = 7
_N_LIMBS = 3
_N_CLASSES = 2 * _N_LIMBS - 1
_KERNEL_FMTS = {"e4m3": 0, "e3m4": 1}
_DMAC_FMTS = {"e4m3": 0, "e5m2": 1, "e3m4": 2}
_ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
# float32(sqrt(2 / pi)), the tanh-gelu constant of jax.nn.gelu
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))
# twin rows / columns per pass (bounds its float64 limb planes)
_PLAIN_N_CHUNK = 16384
# dmac twin: output columns per pass and products per pass (bounds its
# float32 temporaries)
_DMAC_N_CHUNK = 4096
_DMAC_PRODUCTS = 1 << 24
# B5's device rounding tables, (device index, format, gate) -> (128, 128)
_DMAC_TABLES: dict = {}
_DMAC_TABLES_LOCK = threading.Lock()
SCHEDULES = ("output", "weight", "activation")
# the widest edge of tile_shape()
_MAX_EDGE = 64
#: The stationary schedules' admission rule (``csrc/mgs_matmul.cu``
#: ``kStripeBudget``): a whole-K limb stripe (:func:`ws_stripe_bytes`) over
#: :func:`tile_shape`'s edge larger than this takes ``"output"`` instead.
#: Its value is the opt-in limit per block less a 256-entry table and a
#: 32-deep staged tile (3 limbs x 32 x 64 bytes), the layout B3 had before
#: its K split, kept so that every shape keeps its schedule. The
#: reference's 8 MB is a TPU VMEM figure.
WS_STRIPE_BUDGET_BYTES = _cuda.SMEM_LIMIT - 256 * 4 - 3 * 32 * _MAX_EDGE
# B1, B3 and B4 on the card (csrc/mgs_matmul.cu): rows up to which the
# decode tiles and B1's split-K apply; the SMs of an H100; the blocks of one
# wave split-K fills (2 per SM); the least 32-element K units a split takes
_DECODE_ROWS = 16
_SMS = 132
_SPLIT_TARGET = 2 * _SMS
_SPLIT_MIN_RUN = 4
# B3's layout (csrc/mgs_matmul.cu Layout): K elements per ring stage, bytes
# past each staged row, ring stages, the code->limbs table and its 32
# replicas (bytes); the dynamic shared memory a block may take (the opt-in
# less room for static shared memory), and each of two blocks on one SM
# ((228 KB - 2 x 1 KB reserved) / 2, less the same room)
_RING_K = 64
_RING_PAD = 16
_STAT_STAGES = 4
_LUT_BYTES = 4 * 256 * 33
_STATIC_RESERVE = 256
_STAT_BYTES = _cuda.SMEM_LIMIT - _STATIC_RESERVE
_PAIR_BYTES = (233472 - 2 * 1024) // 2 - _STATIC_RESERVE
# split-K workspace and tile counters, (device index, stream) -> tensors
_SPLIT_WS: dict = {}
_SPLIT_WS_LOCK = threading.Lock()


def _relu(r):
    return torch.where(r > 0, r, torch.zeros_like(r))


class _Tanh(torch.autograd.Function):
    """``tanh`` whose gradient is ``g * (1 - y * y)`` rounded op by op (ATen's
    ``tanh_backward`` fuses it on AVX2 / AVX512 CPUs, not on others)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1.0 - y * y)


def _gelu(r):
    r3 = r * r * r
    return r * (0.5 * (1.0 + _Tanh.apply(_SQRT_2_OVER_PI
                                         * (r + 0.044715 * r3))))


def _silu(r):
    return r * (1.0 / (1.0 + torch.exp(-r)))


# Epilogue activations, written op for op as the CUDA kernel computes them
# (csrc/mgs_matmul.cu::activate), so fused and unfused agree on the card.
ACTIVATIONS = {"none": lambda r: r, "relu": _relu, "gelu": _gelu,
               "silu": _silu}


def out_scale(fmt: FPFormat) -> float:
    """``2^-2(bias+mbits)``: the fixed-point scale of an ix * ix product."""
    return 2.0 ** (-2 * (fmt.bias + fmt.mbits))


def _limb_split(ix: torch.Tensor) -> List[torch.Tensor]:
    """Split int32 fixed-point values into 3 balanced base-128 int8 limbs."""
    half, mod = 1 << (_LIMB_BASE - 1), 1 << _LIMB_BASE
    limbs, rem = [], ix.to(torch.int32)
    for _ in range(_N_LIMBS - 1):
        c = ((rem + half) & (mod - 1)) - half
        limbs.append(c.to(torch.int8))
        rem = (rem - c) >> _LIMB_BASE
    limbs.append(rem.to(torch.int8))
    return limbs


def _fixed_point(sm: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``sm << max(e, 1)`` as int32."""
    return sm * pow2(torch.clamp_min(e, 1)).to(torch.int32)


def limb_decompose(v: torch.Tensor, fmt: FPFormat = E4M3) -> torch.Tensor:
    """Format-exact values -> ``(3, ...)`` int8 balanced limbs of ix."""
    sm, e = decompose(v, fmt)
    return torch.stack(_limb_split(_fixed_point(sm, e)))


def _decode_limbs(codes: torch.Tensor, fmt: FPFormat) -> List[torch.Tensor]:
    """Packed codes (uint8) -> 3 balanced int8 limbs."""
    sm, e = decode_sm_e(codes, fmt)
    return _limb_split(_fixed_point(sm, e))


def worst_case_flush_period(block_k: int) -> int:
    """Deterministic no-overflow flush period for the int32 class sums."""
    per_step = block_k * _N_LIMBS * (1 << (_LIMB_BASE - 1)) ** 2
    return max(1, (2**31 - 1) // per_step)


def flush_steps(flush_period: Optional[int], block_k: int,
                nsteps: int) -> int:
    """The runtime flush period, clamped to ``[1, nsteps]`` (``None`` =
    :func:`worst_case_flush_period`). Bit-affecting: each flush rounds
    the exact class sums into the float32 wide accumulator."""
    if flush_period is None:
        flush_period = worst_case_flush_period(block_k)
    return int(min(max(int(flush_period), 1), max(nsteps, 1)))


def tile_shape(M: int) -> Tuple[int, int]:
    """The tile the stationary admission rule counts for ``M`` rows
    (:func:`stationary_block`; ``csrc/mgs_matmul.cu::launch_stationary_fmt``
    refuses by the same edges): 4 rows at decode, 16, else 64. B3's own
    tile is :func:`exact_tile`."""
    return (4, 64) if M <= 4 else (16, 64) if M <= 16 else (64, 64)


def exact_tile(M: int) -> Tuple[int, int]:
    """B1's, B3's and B4's ``(rows, columns)`` output tile on the card
    (``csrc/mgs_matmul.cu::launch_exact_fmt``): 8 or 16 rows by 128
    columns at decode, else 64 x 64."""
    return (8, 128) if M <= 8 else (16, 128) if M <= 16 else (64, 64)


class SplitPlan(NamedTuple):
    """How B1 / B4 cut K across blocks; units of 32 K elements."""
    splits: int       # blocks along K per output tile (1: one walks all K)
    per_segment: int  # splits inside each flush segment
    run: int          # units a split takes
    segment: int      # units of one flush segment (fp * block_k / 32)


def split_plan(Bt: int, M: int, K: int, N: int, block_k: int,
               flush_period: Optional[int]) -> SplitPlan:
    """The card's K split for one B1 / B4 call
    (``csrc/mgs_matmul.cu::split_plan``, line for line).

    At decode (``M <= 16``), where the output tiles of 128 columns number
    fewer than two per SM (132 SMs), every flush segment of
    ``flush_period * block_k`` elements is cut into ``per_segment`` runs of
    ``run`` units (at least 4): as many blocks as one wave of two per SM
    holds, none crossing a flush boundary. Otherwise one block walks all
    of K."""
    fp = flush_steps(flush_period, block_k, -(-K // block_k))
    units, seg = -(-K // 32), fp * (block_k // 32)
    direct = SplitPlan(1, 1, units, seg)
    tiles = Bt * -(-N // exact_tile(M)[1])
    if M > _DECODE_ROWS or tiles >= _SPLIT_TARGET:
        return direct
    nseg = -(-units // seg)
    span = min(units, seg)
    per = max(1, _SPLIT_TARGET // (tiles * nseg))
    run = max(-(-span // per), _SPLIT_MIN_RUN)
    per = -(-span // run)
    if nseg * per == 1:
        return direct
    return SplitPlan(nseg * per, per, run, seg)


def split_ranges(plan, K: int) -> List[Tuple[int, int]]:
    """``(k0, k1)`` of each split of a :class:`SplitPlan` or
    :class:`StationaryPlan`, in launch order (empty where a ragged last
    segment runs out)."""
    if plan.splits == 1:
        return [(0, K)]
    out = []
    for s in range(plan.splits):
        seg, p = divmod(s, plan.per_segment)
        k0 = min(K, 32 * (seg * plan.segment + p * plan.run))
        k1 = min(K, 32 * (seg * plan.segment + p * plan.run + plan.run),
                 32 * (seg + 1) * plan.segment)
        out.append((k0, max(k0, k1)))
    return out


class StationaryPlan(NamedTuple):
    """How B3 cuts K across blocks and sweeps; K in units of 32 elements."""
    splits: int           # blocks along K per output tile
    per_segment: int      # splits inside each flush segment
    run: int              # units a split takes (all of K for one split)
    segment: int          # units of one flush segment
    groups: int           # blocks along the swept operand's tiles
    tiles_per_group: int  # swept tiles a block takes
    lines: int            # lines (x rows / w columns) of the resident stripe
    smem_bytes: int       # dynamic shared memory of a block


def _stationary_layout(M: int, N: int, schedule: str):
    """B3's ``Layout`` at the tile for ``M`` rows: bytes of ring, stage
    fragments and table; the resident lines (the mma A side whole, the B
    side only its live lines); the blocks an SM must hold."""
    bm, bn = exact_tile(M)
    swap = M <= _DECODE_ROWS          # w is mma's A side at decode
    la, lb = (bn, bm) if swap else (bm, bn)
    cache_w = schedule == "weight"
    res_a = cache_w == swap
    # the ring stages only the streamed operand
    stage = (bm * (_RING_K + _RING_PAD) if cache_w
             else _RING_K * (bn + _RING_PAD))
    frag = 3 * (_RING_K // 4) * (lb if res_a else la)      # words
    fixed = _STAT_STAGES * stage + 4 * frag + _LUT_BYTES
    lines = la if res_a else min(N if cache_w else M, lb)
    return fixed, lines, 2 if swap else 1


def stationary_plan(Bt: int, M: int, K: int, N: int, block_k: int,
                    flush_period: Optional[int],
                    schedule: str) -> StationaryPlan:
    """B3's K split and sweep on the card for one call
    (``csrc/mgs_matmul.cu::stationary_plan``, line for line).

    Each block keeps its part of the cached operand's limb stripe
    (``96 * run * lines`` bytes) beside its ring, stage fragments and
    table, in half an SM at decode (two blocks an SM) and in the opt-in at
    prefill; so each flush segment is cut into enough runs that the stripe
    fits, and into more while the blocks (two or one per SM) do not fill
    the 132 SMs, none crossing a flush boundary. The blocks beside one
    cached tile then share the swept operand's tiles in contiguous runs of
    ``tiles_per_group``, as many groups as fill the SMs."""
    fp = flush_steps(flush_period, block_k, -(-K // block_k))
    fixed, lines, minb = _stationary_layout(M, N, schedule)
    bm, bn = exact_tile(M)
    mt, nt = -(-M // bm), -(-N // bn)
    cached, sweep = (nt, mt) if schedule == "weight" else (mt, nt)
    budget = _PAIR_BYTES if minb == 2 else _STAT_BYTES
    target = minb * _SMS
    units, seg = -(-K // 32), fp * (block_k // 32)
    cap = max(1, (budget - fixed) // (96 * lines))
    nseg = -(-units // seg)
    span = min(units, seg)
    per = max(-(-span // cap), target // (Bt * cached * sweep * nseg))
    run = max(-(-span // per), min(cap, _SPLIT_MIN_RUN))
    per = -(-span // run)
    split = (1, 1, units, seg) if nseg * per == 1 else (nseg * per, per,
                                                        run, seg)
    items = Bt * cached * split[0]
    groups = min(sweep, -(-target // items))
    pg = -(-sweep // groups)
    return StationaryPlan(*split, -(-sweep // pg), pg, lines,
                          fixed + 96 * split[2] * lines)


def stationary_block(schedule: str, M: int) -> int:
    """The non-K edge of the cached stripe on the card: the tile's columns
    for ``"weight"``, its rows for ``"activation"``."""
    rows, cols = tile_shape(M)
    return cols if schedule == "weight" else rows


def ws_stripe_bytes(K: int, block: int, block_k: int) -> int:
    """Bytes of a K-resident decoded limb stripe: 3 int8 limb planes x the
    padded ``Kp`` x ``block`` (the reference's formula, shared by the
    hard check and the ops-side fallback so the two never disagree)."""
    Kp = -(-K // block_k) * block_k
    return _N_LIMBS * Kp * block


def check_stripe(schedule: str, M: int, K: int, block_k: int) -> None:
    """Raise ``ValueError`` when a stationary schedule's stripe exceeds
    :data:`WS_STRIPE_BUDGET_BYTES` (read at call time)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    if schedule == "output":
        return
    block = stationary_block(schedule, M)
    stripe = ws_stripe_bytes(K, block, block_k)
    budget = WS_STRIPE_BUDGET_BYTES
    if stripe > budget:
        raise ValueError(
            f"{schedule}-stationary schedule needs a {stripe} B K-resident "
            f"limb stripe (3 x Kp={-(-K // block_k) * block_k} x {block}) > "
            f"{budget} B shared-memory budget; use schedule='output' for "
            "this shape")


def _round_decompose_e4m3(p: torch.Tensor, fmt: FPFormat,
                          gate_subnormal: bool):
    """RNE round-to-``fmt`` + ``(sm, e)`` via exponent-field extraction
    (``repro.kernels.mgs_matmul._round_decompose_e4m3``)."""
    ap = p.abs()
    eu = ((ap.view(torch.int32) >> 23) - 127).clamp(fmt.emin_unbiased,
                                                    fmt.emax_unbiased)
    q = pow2(eu - fmt.mbits)
    r = torch.round(ap / q) * q
    r = torch.clamp_max(r, fmt.max_finite)
    if gate_subnormal:
        r = torch.where(ap < fmt.min_subnormal, torch.zeros_like(r), r)
    r = torch.where(ap == 0, torch.zeros_like(r), r) * torch.sign(p)
    ar = r.abs()
    eu2 = ((ar.view(torch.int32) >> 23) - 127).clamp(fmt.emin_unbiased,
                                                     fmt.emax_unbiased)
    is_sub = ar < 2.0 ** fmt.emin_unbiased
    e = torch.where(is_sub, torch.zeros_like(eu2), eu2 + fmt.bias)
    sc = pow2(-(torch.clamp_min(e, 1) - (fmt.bias + fmt.mbits)))
    sm = torch.round(r * sc).to(torch.int32)
    return sm, e


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def _accumulate_classes(acc, lx, lw):
    """9 limb-pair products accumulated per weight class a+b (exact)."""
    for a in range(_N_LIMBS):
        for b in range(_N_LIMBS):
            acc[a + b] = acc[a + b] + torch.matmul(lx[a], lw[b])


def _class_int32(c: torch.Tensor) -> torch.Tensor:
    """Exact float64 integer class sum -> int32, wrapping like the
    kernel's int32 registers."""
    return c.to(torch.int64).to(torch.int32)


def _flush_classes(acc, acc_f: torch.Tensor) -> torch.Tensor:
    """The wide-accumulator add, ascending class order: ``acc`` holds the 5
    class sums of one flush segment (exact float64 sums, or the int32
    partials of :func:`mgs_matmul_exact_partials`)."""
    tot = acc_f
    for c in range(_N_CLASSES):
        tot = tot + _class_int32(acc[c]).to(torch.float32) * float(
            2 ** (_LIMB_BASE * c))
    return tot


def _limbs64(codes: torch.Tensor, fmt: FPFormat) -> List[torch.Tensor]:
    return [l.to(torch.float64) for l in _decode_limbs(codes, fmt)]


def _segment_classes(lx, lw, k0: int, k1: int) -> List[torch.Tensor]:
    """The exact class sums of K elements ``[k0, k1)`` of decoded limb
    planes ``lx`` (3 x (B, M, K)) and ``lw`` (3 x (B, K, N)), as float64
    integers."""
    acc = [torch.zeros(lx[0].shape[:-1] + lw[0].shape[-1:],
                       dtype=torch.float64, device=lx[0].device)
           ] * _N_CLASSES
    _accumulate_classes(acc, [l[..., k0:k1] for l in lx],
                        [l[..., k0:k1, :] for l in lw])
    return acc


def _walk(lx, lw, block_k: int, fp: int, acc_f: torch.Tensor):
    """The K loop: exact class sums over ``fp`` K-steps of ``block_k``
    (:func:`_segment_classes`), each segment flushed into ``acc_f`` in
    ascending class order (:func:`_flush_classes`). Returns the new
    ``acc_f``."""
    K = lx[0].shape[-1]
    for s0 in range(0, -(-K // block_k), fp):
        k0, k1 = s0 * block_k, min(K, (s0 + fp) * block_k)
        acc_f = _flush_classes(_segment_classes(lx, lw, k0, k1), acc_f)
    return acc_f


def _as_3d(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 3 else t.reshape((1,) + tuple(t.shape))


def _epilogue(r, scale, bias, activation):
    if scale is not None:
        r = r * scale
    if bias is not None:
        r = r + bias
    return ACTIVATIONS[activation](r)


def _rows(v, Bt: int, N: int, device) -> Optional[torch.Tensor]:
    """A scale or bias broadcastable to (Bt, 1, N), as a float32 view."""
    if v is None:
        return None
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.dim() > 3:
        raise ValueError(f"scale/bias rank {t.dim()} > 3")
    t = t.reshape((1,) * (3 - t.dim()) + tuple(t.shape)).contiguous()
    return t.expand(Bt, 1, N)


def _check_operands(x_codes, w_codes, activation, block_k):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    if x_codes.dtype != torch.uint8 or w_codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {x_codes.dtype}, "
                        f"{w_codes.dtype}")
    if x_codes.dim() not in (2, 3) or w_codes.dim() not in (2, 3):
        raise ValueError(f"x (M, K) / (Bt, M, K) and w (K, N) / (Bt, K, N) "
                         f"expected, got {tuple(x_codes.shape)}, "
                         f"{tuple(w_codes.shape)}")
    if x_codes.shape[-1] != w_codes.shape[-2]:
        raise ValueError(f"contraction mismatch {tuple(x_codes.shape)} @ "
                         f"{tuple(w_codes.shape)}")
    if block_k <= 0:
        raise ValueError(f"block_k must be positive, got {block_k}")


def mgs_matmul_exact_fused_plain(x_codes, w_codes, fmt: FPFormat = E4M3, *,
                                 scale=None, bias=None,
                                 activation: str = "none",
                                 block_k: int = 128,
                                 flush_period: Optional[int] = None):
    """Plain PyTorch twin of the B1 kernel (same arguments, same bits)."""
    _check_operands(x_codes, w_codes, activation, block_k)
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    xc, wc = _as_3d(x_codes), _as_3d(w_codes)
    Bt = max(xc.shape[0], wc.shape[0])
    M, K = xc.shape[1:]
    N = wc.shape[-1]
    fp = flush_steps(flush_period, block_k, -(-K // block_k))
    lx = _limbs64(xc, fmt)
    acc_f = torch.zeros((Bt, M, N), dtype=torch.float32, device=xc.device)
    for n0 in range(0, N, _PLAIN_N_CHUNK):
        n1 = min(N, n0 + _PLAIN_N_CHUNK)
        acc_f[..., n0:n1] = _walk(lx, _limbs64(wc[..., n0:n1], fmt), block_k,
                                  fp, acc_f[..., n0:n1])
    out = _epilogue(acc_f * out_scale(fmt), _rows(scale, Bt, N, xc.device),
                    _rows(bias, Bt, N, xc.device), activation)
    return out[0] if squeeze else out


def mgs_matmul_stationary_plain(x_codes, w_codes, fmt: FPFormat = E4M3, *,
                                schedule: str, scale=None, bias=None,
                                activation: str = "none",
                                block_k: int = 128,
                                flush_period: Optional[int] = None):
    """Plain twin of the B3 kernel under a stationary ``schedule``.

    Walks the stationary order: each chunk of the cached operand (columns
    of ``w`` for ``"weight"``, rows of ``x`` for ``"activation"``) is
    decoded once into its K-resident limb planes, then the other
    operand's chunks sweep over it. Raises like the kernel on a stripe
    over :data:`WS_STRIPE_BUDGET_BYTES`. The same bits as the B1 twin.
    """
    _check_operands(x_codes, w_codes, activation, block_k)
    if schedule not in ("weight", "activation"):
        raise ValueError(f"stationary schedule expected, got {schedule!r}")
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    xc, wc = _as_3d(x_codes), _as_3d(w_codes)
    Bt = max(xc.shape[0], wc.shape[0])
    M, K = xc.shape[1:]
    N = wc.shape[-1]
    check_stripe(schedule, M, K, block_k)
    fp = flush_steps(flush_period, block_k, -(-K // block_k))
    acc_f = torch.zeros((Bt, M, N), dtype=torch.float32, device=xc.device)
    C = _PLAIN_N_CHUNK
    if schedule == "weight":
        for n0 in range(0, N, C):
            lw = _limbs64(wc[..., n0:n0 + C], fmt)
            for m0 in range(0, M, C):
                part = acc_f[:, m0:m0 + C, n0:n0 + C]
                part[...] = _walk(_limbs64(xc[:, m0:m0 + C], fmt), lw,
                                  block_k, fp, part)
    else:
        for m0 in range(0, M, C):
            lx = _limbs64(xc[:, m0:m0 + C], fmt)
            for n0 in range(0, N, C):
                part = acc_f[:, m0:m0 + C, n0:n0 + C]
                part[...] = _walk(lx, _limbs64(wc[..., n0:n0 + C], fmt),
                                  block_k, fp, part)
    out = _epilogue(acc_f * out_scale(fmt), _rows(scale, Bt, N, xc.device),
                    _rows(bias, Bt, N, xc.device), activation)
    return out[0] if squeeze else out


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8)
# the split-K workspace, its length, the tile counters, their length
_WS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] * 2


def _kernel(stationary: bool):
    lib = _cuda.load("mgs_matmul")
    fn = (lib.mgs_matmul_exact_fused_stationary if stationary
          else lib.mgs_matmul_exact_fused)
    if fn.argtypes is None:
        fn.argtypes = (_ARGTYPES + ([ctypes.c_int] if stationary else [])
                       + _WS_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _split_workspace(dev, plan, Bt: int, M: int, N: int) -> list:
    """The split-K workspace arguments of one B1 / B3 / B4 launch under
    ``plan`` (a :class:`SplitPlan` or :class:`StationaryPlan`): null for one
    split, else int32 workspace (segments x 5 classes x Bt x M x N) and one
    counter per output tile, zeroed once, kept per (device, stream) and
    grown as needed; the kernel leaves both zero again."""
    if plan.splits == 1:
        return [None, 0, None, 0]
    ws_len = plan.splits // plan.per_segment * _N_CLASSES * Bt * M * N
    bm, bn = exact_tile(M)
    cnt_len = Bt * -(-M // bm) * -(-N // bn)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    # a workspace shared by two streams would mix their partial sums with
    # no error: one per stream, updated under the lock (the replica fleet
    # launches from several threads, each on a stream of its own)
    with _SPLIT_WS_LOCK:
        ws, cnt = _SPLIT_WS.get(key, (None, None))
        if ws is None or ws.numel() < ws_len:
            ws = torch.zeros(ws_len, dtype=torch.int32, device=dev)
        if cnt is None or cnt.numel() < cnt_len:
            cnt = torch.zeros(cnt_len, dtype=torch.int32, device=dev)
        _SPLIT_WS[key] = (ws, cnt)
    return [ws.data_ptr(), ws.numel(), cnt.data_ptr(), cnt.numel()]


def mgs_matmul_exact_fused(x_codes, w_codes, fmt: FPFormat = E4M3, *,
                           scale=None, bias=None, activation: str = "none",
                           block_k: int = 128,
                           flush_period: Optional[int] = None,
                           schedule: str = "output"):
    """Exact limb-fused matmul over packed FP8 codes (B1, or B3 under a
    stationary ``schedule``).

    Args:
      x_codes: ``(M, K)`` or ``(Bt, M, K)`` uint8 codes
        (:func:`repro_torch.core.formats.encode_bits`).
      w_codes: ``(K, N)`` or ``(Bt, K, N)`` uint8 codes; a 2-D weight is
        shared by every slice of a 3-D ``x``.
      fmt: operand format (E4M3 or E3M4).
      scale / bias: optional float32 epilogue rows broadcastable to
        ``(Bt, 1, N)`` — one per slice or shared.
      activation: one of :data:`ACTIVATIONS`.
      block_k: the K-step the flush period counts (a multiple of 32 on
        the card).
      flush_period: runtime K-steps between flushes (``None`` = the
        worst-case bound, one flush at the end for any practical K).
      schedule: ``"output"`` (B1), ``"weight"`` or ``"activation"`` (B3,
        one operand's K-resident limb stripe cached while the other's
        tiles sweep past it). The same bits under every schedule; a
        stationary stripe over :data:`WS_STRIPE_BUDGET_BYTES` raises
        ``ValueError``.

    Returns:
      float32 ``(M, N)`` / ``(Bt, M, N)``. A CPU tensor runs the twin; a
      CUDA tensor launches ``csrc/mgs_matmul.cu`` or raises.
    """
    check_stripe(schedule, x_codes.shape[-2], x_codes.shape[-1], block_k)
    if x_codes.device.type == "cpu":
        if schedule == "output":
            return mgs_matmul_exact_fused_plain(
                x_codes, w_codes, fmt, scale=scale, bias=bias,
                activation=activation, block_k=block_k,
                flush_period=flush_period)
        return mgs_matmul_stationary_plain(
            x_codes, w_codes, fmt, schedule=schedule, scale=scale,
            bias=bias, activation=activation, block_k=block_k,
            flush_period=flush_period)
    if x_codes.device.type != "cuda" or w_codes.device != x_codes.device:
        raise ValueError(f"codes on {x_codes.device} / {w_codes.device}: "
                         "the kernel runs on one CUDA device")
    _check_operands(x_codes, w_codes, activation, block_k)
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the exact kernel takes E4M3/E3M4, got {fmt.name}")
    if block_k % 32:
        raise ValueError(f"block_k={block_k} must be a multiple of 32 on "
                         "the card (the kernels step through K 32 deep)")
    squeeze = x_codes.dim() == 2 and w_codes.dim() == 2
    xc, wc = _as_3d(x_codes).contiguous(), _as_3d(w_codes).contiguous()
    if wc.shape[0] not in (1, xc.shape[0]):
        raise ValueError(f"slice counts {xc.shape[0]} vs {wc.shape[0]}")
    Bt, M, K = xc.shape
    N = wc.shape[-1]
    dev = xc.device
    out = torch.empty((Bt, M, N), dtype=torch.float32, device=dev)
    if Bt and M and N:
        if K == 0:
            out.zero_()
            out = _epilogue(out, _rows(scale, Bt, N, dev),
                            _rows(bias, Bt, N, dev), activation)
        else:
            sc, bi = _rows(scale, Bt, N, dev), _rows(bias, Bt, N, dev)
            fp = flush_steps(flush_period, block_k, -(-K // block_k))
            stationary = schedule != "output"
            name = ("mgs_matmul_exact_fused_stationary" if stationary
                    else "mgs_matmul_exact_fused")
            plan = (stationary_plan(Bt, M, K, N, block_k, fp, schedule)
                    if stationary else split_plan(Bt, M, K, N, block_k, fp))
            err = _kernel(stationary)(
                xc.data_ptr(), wc.data_ptr(),
                None if sc is None else sc.data_ptr(),
                None if bi is None else bi.data_ptr(), out.data_ptr(),
                Bt, M, K, N, M * K, K * N if wc.shape[0] == Bt else 0,
                0 if sc is None else sc.stride(0),
                0 if sc is None else sc.stride(2),
                0 if bi is None else bi.stride(0),
                0 if bi is None else bi.stride(2),
                _KERNEL_FMTS[fmt.name], _ACT_CODES[activation], block_k, fp,
                *([int(schedule == "weight")] if stationary else []),
                *_split_workspace(dev, plan, Bt, M, N), _cuda.stream_ptr(dev))
            _cuda.check(err, name)
            _cuda.count_launch(name)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# B1 over a cut of K: class partials, then the flush
# ---------------------------------------------------------------------------


def partial_segments(k_total: int, block_k: int,
                     flush_period: Optional[int]) -> Tuple[int, int]:
    """``(segment length in K elements, segments)`` of a B1 call over the
    whole ``k_total``: the flush period clamped as that call clamps it
    (:func:`flush_steps` over ``ceil(k_total / block_k)`` K-steps)."""
    fp = flush_steps(flush_period, block_k, -(-k_total // block_k))
    seg_len = fp * block_k
    return seg_len, max(1, -(-k_total // seg_len))


def _check_cut(K: int, k_offset: int, k_total: Optional[int]) -> int:
    k_total = K if k_total is None else int(k_total)
    if k_offset < 0 or k_offset + K > k_total:
        raise ValueError(f"K range [{k_offset}, {k_offset + K}) outside "
                         f"the global K {k_total}")
    return k_total


def _fill_segments(out, lx, lw, k_offset: int, K: int, seg_len: int,
                   m0: int = 0, n0: int = 0):
    """Each flush segment's class sums over the float64 limb lists ``lx``
    ``(Bt, M', K)`` / ``lw`` ``(Bt, K, N')``, a cut of K elements ``[k_offset,
    k_offset + K)`` of the whole, into ``out[s, c, :, m0:m0 + M', n0:n0 +
    N']`` (the segments the cut touches)."""
    m1, n1 = m0 + lx[0].shape[-2], n0 + lw[0].shape[-1]
    for s in range(k_offset // seg_len, (k_offset + K - 1) // seg_len + 1):
        acc = _segment_classes(lx, lw, max(s * seg_len - k_offset, 0),
                               min((s + 1) * seg_len - k_offset, K))
        for c in range(_N_CLASSES):
            out[s, c, :, m0:m1, n0:n1] = _class_int32(acc[c])


def mgs_matmul_exact_partials_plain(x_codes, w_codes, fmt: FPFormat = E4M3,
                                    *, block_k: int = 128,
                                    flush_period: Optional[int] = None,
                                    k_offset: int = 0,
                                    k_total: Optional[int] = None,
                                    schedule: str = "output"):
    """Plain twin of :func:`mgs_matmul_exact_partials` (same bits). A
    stationary ``schedule`` walks B3's order, as
    :func:`mgs_matmul_stationary_plain` does, and raises like the kernel
    where the cut's stripe is over :data:`WS_STRIPE_BUDGET_BYTES`."""
    _check_operands(x_codes, w_codes, "none", block_k)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    xc, wc = _as_3d(x_codes), _as_3d(w_codes)
    Bt = max(xc.shape[0], wc.shape[0])
    M, K = xc.shape[1:]
    N = wc.shape[-1]
    Kg = _check_cut(K, k_offset, k_total)
    check_stripe(schedule, M, K, block_k)
    seg_len, nseg = partial_segments(Kg, block_k, flush_period)
    out = torch.zeros((nseg, _N_CLASSES, Bt, M, N), dtype=torch.int32,
                      device=xc.device)
    if K == 0:
        return out

    def fill(lx, lw, m0, n0):
        _fill_segments(out, lx, lw, k_offset, K, seg_len, m0, n0)

    C = _PLAIN_N_CHUNK
    if schedule == "weight":        # w's chunks cached, x's sweep past
        for n0 in range(0, N, C):
            lw = _limbs64(wc[..., n0:n0 + C], fmt)
            for m0 in range(0, M, C):
                fill(_limbs64(xc[:, m0:m0 + C], fmt), lw, m0, n0)
    else:                           # x decoded once, w's chunks sweep
        for m0 in range(0, M, C):
            lx = _limbs64(xc[:, m0:m0 + C], fmt)
            for n0 in range(0, N, C):
                fill(lx, _limbs64(wc[..., n0:n0 + C], fmt), m0, n0)
    return out


def mgs_matmul_exact_flush_plain(partials, fmt: FPFormat = E4M3, *,
                                 scale=None, bias=None,
                                 activation: str = "none"):
    """Plain twin of :func:`mgs_matmul_exact_flush` (same bits)."""
    _check_partials(partials, activation)
    nseg, _, Bt, M, N = partials.shape
    acc_f = torch.zeros((Bt, M, N), dtype=torch.float32,
                        device=partials.device)
    for s in range(nseg):
        acc_f = _flush_classes(partials[s], acc_f)
    dev = partials.device
    return _epilogue(acc_f * out_scale(fmt), _rows(scale, Bt, N, dev),
                     _rows(bias, Bt, N, dev), activation)


def _check_partials(partials, activation: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    if partials.dtype != torch.int32 or partials.dim() != 5 or \
            partials.shape[1] != _N_CLASSES:
        raise ValueError(f"(segments, 5, Bt, M, N) int32 partials "
                         f"expected, got {tuple(partials.shape)} "
                         f"{partials.dtype}")


def _lib_fn(name: str, argtypes):
    fn = getattr(_cuda.load("mgs_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PART_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
_FLUSH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])


def mgs_matmul_exact_partials(x_codes, w_codes, fmt: FPFormat = E4M3, *,
                              block_k: int = 128,
                              flush_period: Optional[int] = None,
                              k_offset: int = 0,
                              k_total: Optional[int] = None,
                              schedule: str = "output"):
    """B1's (or B3's) exact class sums over one cut of K, unflushed.

    ``x_codes`` ``(M, K)`` / ``(Bt, M, K)`` and ``w_codes`` ``(K, N)`` /
    ``(Bt, K, N)`` hold K elements ``[k_offset, k_offset + K)`` of a
    product whose whole K is ``k_total`` (default ``K``). Every quantity
    that one B1 call derives from K comes from ``k_total``: the clamped
    flush period and the flush segments (:func:`partial_segments`). Returns
    the int32 class partials of every segment, ``(segments, 5, Bt, M, N)``
    (B1's split-K workspace layout), zero outside this cut. Integer sums do
    not depend on their order (int32 wraps alike in every order), so the
    sum of the partials of any cut of K, flushed by
    :func:`mgs_matmul_exact_flush`, is B1's one call, bit for bit.

    ``schedule``: ``"output"`` runs B1's partials; ``"weight"`` or
    ``"activation"`` B3's, whose stripe covers this cut only and is
    admitted by :func:`check_stripe` over the cut's K (``ValueError``
    beyond it: the dispatch picks ``"output"`` first,
    ``kernels.ops._fused_schedule``). The same bits under every schedule.

    A CPU tensor runs the twin; a CUDA tensor launches
    ``csrc/mgs_matmul.cu::mgs_matmul_exact_partials`` (or
    ``::mgs_matmul_stationary_partials``) or raises.
    """
    if x_codes.device.type == "cpu":
        return mgs_matmul_exact_partials_plain(
            x_codes, w_codes, fmt, block_k=block_k,
            flush_period=flush_period, k_offset=k_offset, k_total=k_total,
            schedule=schedule)
    if x_codes.device.type != "cuda" or w_codes.device != x_codes.device:
        raise ValueError(f"codes on {x_codes.device} / {w_codes.device}: "
                         "the kernel runs on one CUDA device")
    _check_operands(x_codes, w_codes, "none", block_k)
    check_stripe(schedule, x_codes.shape[-2], x_codes.shape[-1], block_k)
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the exact kernel takes E4M3/E3M4, got {fmt.name}")
    if block_k % 32:
        raise ValueError(f"block_k={block_k} must be a multiple of 32 on "
                         "the card (the kernels step through K 32 deep)")
    xc, wc = _as_3d(x_codes).contiguous(), _as_3d(w_codes).contiguous()
    if wc.shape[0] not in (1, xc.shape[0]):
        raise ValueError(f"slice counts {xc.shape[0]} vs {wc.shape[0]}")
    Bt, M, K = xc.shape
    N = wc.shape[-1]
    Kg = _check_cut(K, k_offset, k_total)
    seg_len, nseg = partial_segments(Kg, block_k, flush_period)
    dev = xc.device
    out = torch.zeros((nseg, _N_CLASSES, Bt, M, N), dtype=torch.int32,
                      device=dev)
    if Bt and M and N and K:
        stationary = schedule != "output"
        name = ("mgs_matmul_stationary_partials" if stationary
                else "mgs_matmul_exact_partials")
        err = _lib_fn(name, _PART_ARGTYPES[:-1] + [ctypes.c_int] * stationary
                      + _PART_ARGTYPES[-1:])(
            xc.data_ptr(), wc.data_ptr(), out.data_ptr(), Bt, M, K, N,
            M * K, K * N if wc.shape[0] == Bt else 0,
            _KERNEL_FMTS[fmt.name], block_k, seg_len // block_k, k_offset,
            *([int(schedule == "weight")] if stationary else []),
            _cuda.stream_ptr(dev))
        _cuda.check(err, name)
        _cuda.count_launch(name)
    return out


def mgs_matmul_exact_flush(partials, fmt: FPFormat = E4M3, *, scale=None,
                           bias=None, activation: str = "none"):
    """B1's flush and epilogue over summed class partials.

    ``partials``: ``(segments, 5, Bt, M, N)`` int32, the sum over every cut
    of K of :func:`mgs_matmul_exact_partials`. Each output adds the
    segments in ascending order, each segment's classes in ascending order
    into the float32 wide accumulator (``flush_classes``), then runs B1's
    epilogue (``scale`` / ``bias`` rows broadcastable to ``(Bt, 1, N)``,
    ``activation``). Returns float32 ``(Bt, M, N)``.

    A CPU tensor runs the twin; a CUDA tensor launches
    ``csrc/mgs_matmul.cu::mgs_matmul_exact_flush`` or raises.
    """
    if partials.device.type == "cpu":
        return mgs_matmul_exact_flush_plain(partials, fmt, scale=scale,
                                            bias=bias, activation=activation)
    if partials.device.type != "cuda":
        raise ValueError(f"partials on {partials.device}: the kernel runs "
                         "on one CUDA device")
    _check_partials(partials, activation)
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the exact kernel takes E4M3/E3M4, got {fmt.name}")
    part = partials.contiguous()
    nseg, _, Bt, M, N = part.shape
    dev = part.device
    out = torch.empty((Bt, M, N), dtype=torch.float32, device=dev)
    if Bt and M and N:
        sc, bi = _rows(scale, Bt, N, dev), _rows(bias, Bt, N, dev)
        err = _lib_fn("mgs_matmul_exact_flush", _FLUSH_ARGTYPES)(
            part.data_ptr(), None if sc is None else sc.data_ptr(),
            None if bi is None else bi.data_ptr(), out.data_ptr(), nseg, Bt,
            M, N, 0 if sc is None else sc.stride(0),
            0 if sc is None else sc.stride(2),
            0 if bi is None else bi.stride(0),
            0 if bi is None else bi.stride(2), _KERNEL_FMTS[fmt.name],
            _ACT_CODES[activation], _cuda.stream_ptr(dev))
        _cuda.check(err, "mgs_matmul_exact_flush")
        _cuda.count_launch("mgs_matmul_exact_flush")
    return out


# ---------------------------------------------------------------------------
# B4: the exact matmul over pre-decomposed limb planes
# ---------------------------------------------------------------------------


def _limb_planes(t: torch.Tensor, what: str) -> torch.Tensor:
    """``(3, R, C)`` or ``(Bt, 3, R, C)`` int8 limb planes as 4-D."""
    if t.dtype != torch.int8 or t.dim() not in (3, 4) or \
            t.shape[-3] != _N_LIMBS:
        raise ValueError(f"{what}: (3, R, C) or (Bt, 3, R, C) int8 limb "
                         f"planes expected, got {tuple(t.shape)} {t.dtype}")
    return t if t.dim() == 4 else t[None]


def _check_limbs(x_limbs, w_limbs, block_k: int):
    xl = _limb_planes(x_limbs, "x_limbs")
    wl = _limb_planes(w_limbs, "w_limbs")
    if xl.shape[-1] != wl.shape[-2]:
        raise ValueError(f"contraction mismatch {tuple(x_limbs.shape)} @ "
                         f"{tuple(w_limbs.shape)}")
    if block_k <= 0:
        raise ValueError(f"block_k must be positive, got {block_k}")
    return xl, wl


def mgs_matmul_exact_plain(x_limbs, w_limbs, fmt: FPFormat = E4M3, *,
                           block_k: int = 128,
                           flush_period: Optional[int] = None):
    """Plain PyTorch twin of the B4 kernel: the B1 twin's K walk
    (:func:`_walk`) over limb planes given instead of decoded."""
    xl, wl = _check_limbs(x_limbs, w_limbs, block_k)
    squeeze = x_limbs.dim() == 3 and w_limbs.dim() == 3
    Bt = max(xl.shape[0], wl.shape[0])
    M, K = xl.shape[-2:]
    N = wl.shape[-1]
    fp = flush_steps(flush_period, block_k, -(-K // block_k))
    lx = [xl[:, a].to(torch.float64) for a in range(_N_LIMBS)]
    acc_f = torch.zeros((Bt, M, N), dtype=torch.float32, device=xl.device)
    for n0 in range(0, N, _PLAIN_N_CHUNK):
        n1 = min(N, n0 + _PLAIN_N_CHUNK)
        lw = [wl[:, a, :, n0:n1].to(torch.float64) for a in range(_N_LIMBS)]
        acc_f[..., n0:n1] = _walk(lx, lw, block_k, fp, acc_f[..., n0:n1])
    out = acc_f * out_scale(fmt)
    return out[0] if squeeze else out


def _exact_kernel():
    fn = _cuda.load("mgs_matmul").mgs_matmul_exact
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + _WS_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def mgs_matmul_exact(x_limbs, w_limbs, fmt: FPFormat = E4M3, *,
                     block_k: int = 128, flush_period: Optional[int] = None):
    """Exact FP8 matmul from pre-decomposed limb planes (B4).

    Args:
      x_limbs: ``(3, M, K)`` or ``(Bt, 3, M, K)`` int8 balanced limbs
        (:func:`limb_decompose`; the caller decomposes the activation).
      w_limbs: ``(3, K, N)`` or ``(Bt, 3, K, N)`` int8 limbs (a prepared
        weight's ``limbs``); one 3-D plane set is shared by every slice.
      fmt: the operands' format (E4M3 or E3M4): the output scale.
      block_k / flush_period: the K-step and the flush cadence, as for B1
        (bit-affecting; equal settings give B1's bits).

    Returns:
      float32 ``(M, N)`` / ``(Bt, M, N)`` ``x @ w``, exact up to the
      flushes. A CPU tensor runs :func:`mgs_matmul_exact_plain`; a CUDA
      tensor launches ``csrc/mgs_matmul.cu`` or raises.
    """
    if x_limbs.device.type == "cpu":
        return mgs_matmul_exact_plain(x_limbs, w_limbs, fmt, block_k=block_k,
                                      flush_period=flush_period)
    if x_limbs.device.type != "cuda" or w_limbs.device != x_limbs.device:
        raise ValueError(f"limbs on {x_limbs.device} / {w_limbs.device}: "
                         "the kernel runs on one CUDA device")
    xl, wl = _check_limbs(x_limbs, w_limbs, block_k)
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the exact kernel takes E4M3/E3M4, got {fmt.name}")
    if block_k % 32:
        raise ValueError(f"block_k={block_k} must be a multiple of 32 on "
                         "the card (the kernels step through K 32 deep)")
    squeeze = x_limbs.dim() == 3 and w_limbs.dim() == 3
    xl, wl = xl.contiguous(), wl.contiguous()
    if wl.shape[0] not in (1, xl.shape[0]):
        raise ValueError(f"slice counts {xl.shape[0]} vs {wl.shape[0]}")
    Bt, _, M, K = xl.shape
    N = wl.shape[-1]
    out = torch.empty((Bt, M, N), dtype=torch.float32, device=xl.device)
    if Bt and M and N:
        if K == 0:
            out.zero_()
        else:
            fp = flush_steps(flush_period, block_k, -(-K // block_k))
            err = _exact_kernel()(
                xl.data_ptr(), wl.data_ptr(), out.data_ptr(), Bt, M, K, N,
                _N_LIMBS * M * K,
                _N_LIMBS * K * N if wl.shape[0] == Bt else 0,
                _KERNEL_FMTS[fmt.name], block_k, fp,
                *_split_workspace(xl.device,
                                  split_plan(Bt, M, K, N, block_k, fp), Bt,
                                  M, N),
                _cuda.stream_ptr(xl.device))
            _cuda.check(err, "mgs_matmul_exact")
            _cuda.count_launch("mgs_matmul_exact")
    return out[0] if squeeze else out


def mgs_matmul_exact_limb_partials_plain(x_limbs, w_limbs,
                                         fmt: FPFormat = E4M3, *,
                                         block_k: int = 128,
                                         flush_period: Optional[int] = None,
                                         k_offset: int = 0,
                                         k_total: Optional[int] = None):
    """Plain twin of :func:`mgs_matmul_exact_limb_partials` (same bits):
    :func:`mgs_matmul_exact_partials_plain`'s segments over limb planes
    given instead of decoded."""
    xl, wl = _check_limbs(x_limbs, w_limbs, block_k)
    Bt = max(xl.shape[0], wl.shape[0])
    M, K = xl.shape[-2:]
    N = wl.shape[-1]
    Kg = _check_cut(K, k_offset, k_total)
    seg_len, nseg = partial_segments(Kg, block_k, flush_period)
    out = torch.zeros((nseg, _N_CLASSES, Bt, M, N), dtype=torch.int32,
                      device=xl.device)
    if K == 0:
        return out
    lx = [xl[:, a].to(torch.float64) for a in range(_N_LIMBS)]
    for n0 in range(0, N, _PLAIN_N_CHUNK):
        lw = [wl[:, a, :, n0:n0 + _PLAIN_N_CHUNK].to(torch.float64)
              for a in range(_N_LIMBS)]
        _fill_segments(out, lx, lw, k_offset, K, seg_len, n0=n0)
    return out


def mgs_matmul_exact_limb_partials(x_limbs, w_limbs, fmt: FPFormat = E4M3, *,
                                   block_k: int = 128,
                                   flush_period: Optional[int] = None,
                                   k_offset: int = 0,
                                   k_total: Optional[int] = None):
    """B4's exact class sums over one cut of K, unflushed: the limb-plane
    form of :func:`mgs_matmul_exact_partials` (same cut arguments, same
    ``(segments, 5, Bt, M, N)`` int32 result). ``x_limbs`` ``(3, M, K)`` /
    ``(Bt, 3, M, K)`` and ``w_limbs`` ``(3, K, N)`` / ``(Bt, 3, K, N)``
    hold K elements ``[k_offset, k_offset + K)``. Its partials are B1's
    class sums, so :func:`mgs_matmul_exact_flush` closes them: any cut of K
    gives one B4 call's bits.

    A CPU tensor runs the twin; a CUDA tensor launches
    ``csrc/mgs_matmul.cu::mgs_matmul_exact_limb_partials`` or raises.
    """
    if x_limbs.device.type == "cpu":
        return mgs_matmul_exact_limb_partials_plain(
            x_limbs, w_limbs, fmt, block_k=block_k,
            flush_period=flush_period, k_offset=k_offset, k_total=k_total)
    if x_limbs.device.type != "cuda" or w_limbs.device != x_limbs.device:
        raise ValueError(f"limbs on {x_limbs.device} / {w_limbs.device}: "
                         "the kernel runs on one CUDA device")
    xl, wl = _check_limbs(x_limbs, w_limbs, block_k)
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the exact kernel takes E4M3/E3M4, got {fmt.name}")
    if block_k % 32:
        raise ValueError(f"block_k={block_k} must be a multiple of 32 on "
                         "the card (the kernels step through K 32 deep)")
    xl, wl = xl.contiguous(), wl.contiguous()
    if wl.shape[0] not in (1, xl.shape[0]):
        raise ValueError(f"slice counts {xl.shape[0]} vs {wl.shape[0]}")
    Bt, _, M, K = xl.shape
    N = wl.shape[-1]
    Kg = _check_cut(K, k_offset, k_total)
    seg_len, nseg = partial_segments(Kg, block_k, flush_period)
    out = torch.zeros((nseg, _N_CLASSES, Bt, M, N), dtype=torch.int32,
                      device=xl.device)
    if Bt and M and N and K:
        name = "mgs_matmul_exact_limb_partials"
        err = _lib_fn(name, _PART_ARGTYPES)(
            xl.data_ptr(), wl.data_ptr(), out.data_ptr(), Bt, M, K, N,
            _N_LIMBS * M * K, _N_LIMBS * K * N if wl.shape[0] == Bt else 0,
            _KERNEL_FMTS[fmt.name], block_k, seg_len // block_k, k_offset,
            _cuda.stream_ptr(xl.device))
        _cuda.check(err, name)
        _cuda.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# B5: the paper's dMAC numerics
# ---------------------------------------------------------------------------


def _check_dmac(x, w, fmt: FPFormat, codes: bool = False):
    if x.dim() not in (2, 3) or w.dim() not in (2, 3):
        raise ValueError(f"x (M, K) / (Bt, M, K) and w (K, N) / (Bt, K, N) "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[-1] != w.shape[-2]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if codes and not (x.dtype == w.dtype == torch.uint8):
        raise TypeError(f"uint8 codes expected, got {x.dtype}, {w.dtype}")
    if not codes and not (x.is_floating_point() and w.is_floating_point()):
        raise TypeError(f"format-exact float values expected, got "
                        f"{x.dtype}, {w.dtype}")
    if fmt.name not in _DMAC_FMTS:
        raise ValueError(f"the dmac kernel takes {sorted(_DMAC_FMTS)}, got "
                         f"{fmt.name}")


def _dmac_bins(x, w, fmt: FPFormat, gate_subnormal: bool) -> torch.Tensor:
    """The dMAC bin sums of format-exact ``x`` ``(Bt?, M, K)`` and ``w``
    ``(Bt?, K, N)``: ``(Bt, M, N, n_bins)`` int32, wrapped like the
    kernel's bins.

    Walks N in chunks of ``_DMAC_N_CHUNK`` columns and K in chunks of at
    most ``_DMAC_PRODUCTS`` products: each chunk's exact products are
    rounded and decomposed by :func:`_round_decompose_e4m3` and scattered
    into int64 bin sums (integers: the chunking cannot change them), which
    wrap to int32 as the kernel's do."""
    x3 = _as_3d(x).to(torch.float32)
    w3 = _as_3d(w).to(torch.float32)
    Bt = max(x3.shape[0], w3.shape[0])
    M, K = x3.shape[1:]
    N = w3.shape[-1]
    bins = torch.zeros((Bt, M, fmt.n_bins, N), dtype=torch.int64,
                       device=x3.device)
    for n0 in range(0, N, _DMAC_N_CHUNK):
        n1 = min(N, n0 + _DMAC_N_CHUNK)
        kc = max(1, min(K, _DMAC_PRODUCTS // max(1, Bt * M * (n1 - n0))))
        part = bins[..., n0:n1]
        for k0 in range(0, K, kc):
            p = (x3[:, :, k0:k0 + kc, None]
                 * w3[:, None, k0:k0 + kc, n0:n1])      # (Bt, M, kc, nc)
            sm, e = _round_decompose_e4m3(p, fmt, gate_subnormal)
            part.scatter_add_(2, e.to(torch.int64), sm.to(torch.int64))
    return bins.to(torch.int32).movedim(-2, -1)


def mgs_matmul_dmac_plain(x, w, fmt: FPFormat = E4M3,
                          gate_subnormal: bool = True):
    """Plain PyTorch dMAC matmul over format-exact values (the B5 twin's
    arithmetic): the bin sums of :func:`_dmac_bins`, then one combine per
    output from zero in ascending bin order."""
    _check_dmac(x, w, fmt)
    squeeze = x.dim() == 2 and w.dim() == 2
    out = combine_bins(_dmac_bins(x, w, fmt, gate_subnormal), fmt)
    return out[0] if squeeze else out


def mgs_matmul_dmac_codes_plain(xc, wc, fmt: FPFormat = E4M3,
                                gate_subnormal: bool = True):
    """Plain PyTorch twin of the B5 kernel (same arguments, same bits):
    :func:`mgs_matmul_dmac_plain` over the codes' decoded values."""
    _check_dmac(xc, wc, fmt, codes=True)
    return mgs_matmul_dmac_plain(decode_bits(xc, fmt), decode_bits(wc, fmt),
                                 fmt, gate_subnormal)


def dmac_table_plain(fmt: FPFormat = E4M3,
                     gate_subnormal: bool = True) -> torch.Tensor:
    """B5's rounding table, computed by the twin's rounding: uint8
    ``(128, 128)``, entry ``(a, b)`` = ``(e << (mbits + 1)) | |sm|`` of the
    product of magnitude codes ``a`` and ``b``."""
    v = decode_bits(torch.arange(128, dtype=torch.uint8), fmt)
    sm, e = _round_decompose_e4m3(v[:, None] * v[None, :], fmt,
                                  gate_subnormal)
    return ((e << (fmt.mbits + 1)) | sm).to(torch.uint8)


def _dmac_lib(name: str, argtypes):
    fn = getattr(_cuda.load("mgs_dmac"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def dmac_table(device, fmt: FPFormat = E4M3,
               gate_subnormal: bool = True) -> torch.Tensor:
    """B5's rounding table on a CUDA device: built there once per
    ``(device, format, gate)`` by ``csrc/mgs_dmac.cu::dmac_table_kernel``
    (the kernels' own ``round_decompose``) and cached; equal to
    :func:`dmac_table_plain`. A one-time set-up launch, not counted in
    ``LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the device table lives on a CUDA device, got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, fmt.name, bool(gate_subnormal))
    with _DMAC_TABLES_LOCK:
        tbl = _DMAC_TABLES.get(key)
        if tbl is None:
            tbl = torch.empty((128, 128), dtype=torch.uint8, device=device)
            fn = _dmac_lib("mgs_dmac_table", [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
            _cuda.check(fn(tbl.data_ptr(), _DMAC_FMTS[fmt.name],
                           int(gate_subnormal), _cuda.stream_ptr(device)),
                        "mgs_dmac_table")
            # later launches may run on other streams
            torch.cuda.current_stream(device).synchronize()
            _DMAC_TABLES[key] = tbl
    return tbl


def _dmac_launch(xc, wc, fmt: FPFormat, gate_subnormal: bool):
    """One B5 launch over checked uint8 codes on one CUDA device."""
    squeeze = xc.dim() == 2 and wc.dim() == 2
    x3 = _as_3d(xc).contiguous()
    w3 = _as_3d(wc).contiguous()
    Bt = max(x3.shape[0], w3.shape[0])
    if x3.shape[0] not in (1, Bt) or w3.shape[0] not in (1, Bt):
        raise ValueError(f"slice counts {x3.shape[0]} vs {w3.shape[0]}")
    M, K = x3.shape[1:]
    N = w3.shape[-1]
    out = torch.empty((Bt, M, N), dtype=torch.float32, device=x3.device)
    if Bt and M and N:
        tbl = dmac_table(x3.device, fmt, gate_subnormal)
        fn = _dmac_lib("mgs_matmul_dmac_codes",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        err = fn(x3.data_ptr(), w3.data_ptr(), tbl.data_ptr(), out.data_ptr(),
                 Bt, M, K, N, M * K if x3.shape[0] == Bt else 0,
                 K * N if w3.shape[0] == Bt else 0, _DMAC_FMTS[fmt.name],
                 _cuda.stream_ptr(x3.device))
        _cuda.check(err, "mgs_matmul_dmac")
        _cuda.count_launch("mgs_matmul_dmac")
    return out[0] if squeeze else out


def _on_one_cuda_device(x, w):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"operands on {x.device} / {w.device}: the kernel "
                         "runs on one CUDA device")


def mgs_matmul_dmac_codes(xc, wc, fmt: FPFormat = E4M3,
                          gate_subnormal: bool = True):
    """Paper-faithful MGS matmul (per-product rounding, Fig. 8) over packed
    FP8 codes — B5.

    Args:
      xc: ``(M, K)`` or ``(Bt, M, K)`` uint8 codes.
      wc: ``(K, N)`` or ``(Bt, K, N)`` uint8 codes; a 2-D ``wc`` is shared
        by every slice.
      fmt: E4M3 (16 bins), E5M2 (32) or E3M4 (8).
      gate_subnormal: skip products below the smallest subnormal (§5.3).

    Returns:
      float32 ``(M, N)`` / ``(Bt, M, N)``. A CPU tensor runs
      :func:`mgs_matmul_dmac_codes_plain`; a CUDA tensor launches
      ``csrc/mgs_dmac.cu`` or raises.
    """
    if xc.device.type == "cpu":
        return mgs_matmul_dmac_codes_plain(xc, wc, fmt, gate_subnormal)
    _on_one_cuda_device(xc, wc)
    _check_dmac(xc, wc, fmt, codes=True)
    return _dmac_launch(xc, wc, fmt, gate_subnormal)


def mgs_matmul_dmac(x, w, fmt: FPFormat = E4M3, gate_subnormal: bool = True):
    """B5 over format-exact float values.

    Args:
      x: ``(M, K)`` or ``(Bt, M, K)`` format-exact values.
      w: ``(K, N)`` or ``(Bt, K, N)`` format-exact values; a 2-D ``w`` is
        shared by every slice.
      fmt, gate_subnormal: as :func:`mgs_matmul_dmac_codes`.

    Returns:
      float32 ``(M, N)`` / ``(Bt, M, N)``. A CPU tensor runs
      :func:`mgs_matmul_dmac_plain`; a CUDA tensor is encoded
      (``encode_bits``) and launches the codes kernel or raises.
    """
    if x.device.type == "cpu":
        return mgs_matmul_dmac_plain(x, w, fmt, gate_subnormal)
    _on_one_cuda_device(x, w)
    _check_dmac(x, w, fmt)
    return _dmac_launch(encode_bits(x, fmt), encode_bits(w, fmt), fmt,
                        gate_subnormal)


# ---------------------------------------------------------------------------
# B5 over a cut of K: summed bins, then the combine
# ---------------------------------------------------------------------------


def mgs_matmul_dmac_partials_plain(xc, wc, fmt: FPFormat = E4M3,
                                   gate_subnormal: bool = True, *,
                                   k_offset: int = 0,
                                   k_total: Optional[int] = None):
    """Plain twin of :func:`mgs_matmul_dmac_partials` (same bits)."""
    _check_dmac(xc, wc, fmt, codes=True)
    _check_cut(xc.shape[-1], k_offset, k_total)
    return _dmac_bins(decode_bits(xc, fmt), decode_bits(wc, fmt), fmt,
                      gate_subnormal)


def _bmn(v, Bt: int, M: int, N: int, device) -> Optional[torch.Tensor]:
    """A scale or bias broadcastable to (Bt, M, N), as a float32 view."""
    if v is None:
        return None
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.dim() > 3:
        raise ValueError(f"scale/bias rank {t.dim()} > 3")
    t = t.contiguous().reshape((1,) * (3 - t.dim()) + tuple(t.shape))
    return t.expand(Bt, M, N)


def _check_bins(bins, fmt: FPFormat, activation: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(ACTIVATIONS)}")
    if fmt.name not in _DMAC_FMTS:
        raise ValueError(f"the dmac kernel takes {sorted(_DMAC_FMTS)}, got "
                         f"{fmt.name}")
    if bins.dtype != torch.int32 or bins.dim() != 4 or \
            bins.shape[-1] != fmt.n_bins:
        raise ValueError(f"(Bt, M, N, {fmt.n_bins}) int32 bins expected, "
                         f"got {tuple(bins.shape)} {bins.dtype}")


def mgs_matmul_dmac_combine_plain(bins, fmt: FPFormat = E4M3, *, scale=None,
                                  bias=None, activation: str = "none"):
    """Plain twin of :func:`mgs_matmul_dmac_combine` (same bits)."""
    _check_bins(bins, fmt, activation)
    Bt, M, N, _ = bins.shape
    dev = bins.device
    return _epilogue(combine_bins(bins, fmt), _bmn(scale, Bt, M, N, dev),
                     _bmn(bias, Bt, M, N, dev), activation)


def mgs_matmul_dmac_partials(xc, wc, fmt: FPFormat = E4M3,
                             gate_subnormal: bool = True, *,
                             k_offset: int = 0,
                             k_total: Optional[int] = None):
    """B5's summed bins over one cut of K, not combined.

    ``xc`` ``(M, K)`` / ``(Bt, M, K)`` and ``wc`` ``(K, N)`` / ``(Bt, K,
    N)`` uint8 codes hold K elements ``[k_offset, k_offset + K)`` of a
    product whose whole K is ``k_total`` (default ``K``; checked, as for
    :func:`mgs_matmul_exact_partials`). Returns ``(Bt, M, N, n_bins)``
    int32: each output's bin sums over this cut (16 bins in E4M3, 32 in
    E5M2, 8 in E3M4), wrapping mod 2^32 as the kernel's bins do. A
    product's bin depends on its two codes alone, so the int32 sum of the
    bins of any cut of K, combined by :func:`mgs_matmul_dmac_combine`, is
    one B5 call's bits.

    A CPU tensor runs the twin; a CUDA tensor launches
    ``csrc/mgs_dmac.cu::mgs_matmul_dmac_partials`` or raises.
    """
    if xc.device.type == "cpu":
        return mgs_matmul_dmac_partials_plain(xc, wc, fmt, gate_subnormal,
                                              k_offset=k_offset,
                                              k_total=k_total)
    _on_one_cuda_device(xc, wc)
    _check_dmac(xc, wc, fmt, codes=True)
    _check_cut(xc.shape[-1], k_offset, k_total)
    x3 = _as_3d(xc).contiguous()
    w3 = _as_3d(wc).contiguous()
    Bt = max(x3.shape[0], w3.shape[0])
    if x3.shape[0] not in (1, Bt) or w3.shape[0] not in (1, Bt):
        raise ValueError(f"slice counts {x3.shape[0]} vs {w3.shape[0]}")
    M, K = x3.shape[1:]
    N = w3.shape[-1]
    out = torch.empty((Bt, M, N, fmt.n_bins), dtype=torch.int32,
                      device=x3.device)
    if Bt and M and N:
        tbl = dmac_table(x3.device, fmt, gate_subnormal)
        name = "mgs_matmul_dmac_partials"
        fn = _dmac_lib(name, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        err = fn(x3.data_ptr(), w3.data_ptr(), tbl.data_ptr(),
                 out.data_ptr(), Bt, M, K, N,
                 M * K if x3.shape[0] == Bt else 0,
                 K * N if w3.shape[0] == Bt else 0, _DMAC_FMTS[fmt.name],
                 _cuda.stream_ptr(x3.device))
        _cuda.check(err, name)
        _cuda.count_launch(name)
    return out


def mgs_matmul_dmac_combine(bins, fmt: FPFormat = E4M3, *, scale=None,
                            bias=None, activation: str = "none"):
    """B5's combine and the dMAC path's epilogue over summed bins.

    ``bins``: ``(Bt, M, N, n_bins)`` int32, the sum over every cut of K of
    :func:`mgs_matmul_dmac_partials`. Each output adds its bins from zero
    in ascending order (B5's combine), then ``* scale``, ``+ bias`` and
    ``activation`` (``scale`` / ``bias`` broadcastable to ``(Bt, M, N)``),
    each step one rounding: ``quant.qmatmul``'s dMAC epilogue. Returns
    float32 ``(Bt, M, N)``.

    A CPU tensor runs the twin; a CUDA tensor launches
    ``csrc/mgs_dmac.cu::mgs_matmul_dmac_combine`` or raises.
    """
    if bins.device.type == "cpu":
        return mgs_matmul_dmac_combine_plain(bins, fmt, scale=scale,
                                             bias=bias, activation=activation)
    if bins.device.type != "cuda":
        raise ValueError(f"bins on {bins.device}: the kernel runs on one "
                         "CUDA device")
    _check_bins(bins, fmt, activation)
    part = bins.contiguous()
    Bt, M, N, _ = part.shape
    dev = part.device
    out = torch.empty((Bt, M, N), dtype=torch.float32, device=dev)
    if Bt and M and N:
        sc, bi = _bmn(scale, Bt, M, N, dev), _bmn(bias, Bt, M, N, dev)
        name = "mgs_matmul_dmac_combine"
        fn = _dmac_lib(name, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        err = fn(part.data_ptr(), None if sc is None else sc.data_ptr(),
                 None if bi is None else bi.data_ptr(), out.data_ptr(), Bt,
                 M, N, *(sc.stride() if sc is not None else (0, 0, 0)),
                 *(bi.stride() if bi is not None else (0, 0, 0)),
                 _DMAC_FMTS[fmt.name], _ACT_CODES[activation],
                 _cuda.stream_ptr(dev))
        _cuda.check(err, name)
        _cuda.count_launch(name)
    return out
