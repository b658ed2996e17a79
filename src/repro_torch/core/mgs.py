"""The dMAC half of Markov Greedy Sums (the port of ``repro.core.mgs``):
what the paper-numerics matmul needs.

A dMAC (the paper's Fig. 8 unit) rounds every product back into the FP8
format, adds its signed mantissa ``sm`` into the narrow accumulator of its
exponent bin ``e``, and shifts and adds the bins once per dot product.
Flushing a narrow accumulator into its wide register never loses bits, so
the per-bin totals are exact integers whatever the order of the sum; only
the final float32 combine rounds, and it runs in ascending bin order with
exact power-of-two scales (the kernels' order, ``mgs_matmul_dmac``).

The dot-level analysis half (the paper's Fig. 3 / Table 3 tools):

* :func:`mgs_dot_exact`, the vectorised dot: ``mode="dmac"`` rounds each
  product and sums the bins; ``mode="exact"`` sums the operands' 20-bit
  fixed-point forms through 7-bit balanced limbs, nine int32 limb-pair
  dots combined in the reference's order;
* :func:`mgs_dot_dmac`, the sequential emulator of the Fig. 8 unit: 16
  narrow ``narrow_bits``-bit registers indexed by exponent bin, greedy
  accumulation, flush-on-overflow into exact per-bin totals (the wide
  register), one final combine; it returns :class:`MGSStats`;
* :func:`mgs_dot_narrow_clipped`, the ablation without the wide fallback:
  the narrow registers saturate.

The reference's emulators run on one dot and its callers ``vmap`` them;
here every leading dim is a batch of independent dots, the state is
vectorised over them, and a plain loop walks K in the reference's order,
the same on the CPU and on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .formats import E4M3, FPFormat, decompose, round_to_format

__all__ = ["MGSStats", "round_product", "bin_sums", "combine_bins",
           "bin_scales", "mgs_dot_exact", "mgs_dot_dmac",
           "mgs_dot_narrow_clipped", "mgs_matvec_exact"]


class MGSStats(NamedTuple):
    """Counters of the dMAC emulator, one per dot (leading dims)."""

    total_macs: torch.Tensor      # partial products seen (K)
    skipped: torch.Tensor         # products below the smallest subnormal
    narrow_adds: torch.Tensor     # adds performed by the narrow adder
    wide_flushes: torch.Tensor    # overflow-triggered flushes
    final_flushes: torch.Tensor   # end-of-dot shift + add ops (n_bins)
    bin_hits: torch.Tensor        # (..., n_bins) occupancy histogram

    @staticmethod
    def zero(n_bins: int = 16, device=None) -> "MGSStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return MGSStats(z, z, z, z, z, torch.zeros(
            (n_bins,), dtype=torch.int32, device=device))

    def merge(self, other: "MGSStats") -> "MGSStats":
        return MGSStats(*(a + b for a, b in zip(self, other)))

    @property
    def overflow_rate(self) -> torch.Tensor:
        return self.wide_flushes / torch.clamp_min(self.narrow_adds, 1)


def round_product(p: torch.Tensor, fmt: FPFormat = E4M3,
                  gate_subnormal: bool = True):
    """Round exact products back into ``fmt`` (Fig. 8 'multiply + round').

    With ``gate_subnormal`` (§5.3) a product whose magnitude is below the
    smallest subnormal is skipped: it contributes zero. Returns
    ``(p_rounded, skipped_mask)``.
    """
    skipped = p.abs() < fmt.min_subnormal
    r = round_to_format(p, fmt)
    if gate_subnormal:
        r = torch.where(skipped, torch.zeros_like(r), r)
    return r, skipped


def bin_sums(sm: torch.Tensor, e: torch.Tensor, fmt: FPFormat = E4M3,
             axis: int = -1) -> torch.Tensor:
    """Per-exponent-bin integer mantissa sums along ``axis``:
    ``out[..., b] = sum_k sm[..., k] * [e[..., k] == b]`` as int32, wrapping
    like the hardware's (and the reference's) int32 registers."""
    bins = torch.arange(fmt.n_bins, dtype=torch.int32, device=sm.device)
    onehot = (e.unsqueeze(-1) == bins).to(torch.int64)
    dim = axis - 1 if axis < 0 else axis
    return (sm.to(torch.int64).unsqueeze(-1) * onehot).sum(dim=dim).to(
        torch.int32)


def bin_scales(fmt: FPFormat = E4M3):
    """The exact power of two of each bin, ``2**(max(b, 1) - bias - mbits)``
    (Python floats; every one is a float32 normal number)."""
    return [2.0 ** (max(b, 1) - (fmt.bias + fmt.mbits))
            for b in range(fmt.n_bins)]


def combine_bins(binsum: torch.Tensor, fmt: FPFormat = E4M3,
                 dtype=torch.float32) -> torch.Tensor:
    """The final shift + add: ``sum_b binsum[..., b] * 2**scale(b)``, once
    per dot product, from zero in ascending bin order in ``dtype``."""
    tot = torch.zeros(binsum.shape[:-1], dtype=dtype, device=binsum.device)
    for b, s in enumerate(bin_scales(fmt)):
        tot = tot + binsum[..., b].to(dtype) * s
    return tot


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to (kept in int64)."""
    return ((v + 2**31) & (2**32 - 1)) - 2**31


def _limbs(ix: torch.Tensor, base: int, n: int):
    """Balanced signed base-``2**base`` limbs of int32 values, in int32
    arithmetic (carried in int64, wrapped after every op)."""
    half, mod = 1 << (base - 1), 1 << base
    limbs, rem = [], ix
    for _ in range(n - 1):
        c = (_wrap32(rem + half) & (mod - 1)) - half
        limbs.append(c)
        rem = _wrap32(rem - c) >> base
    limbs.append(rem)
    return limbs


def _products(x, w, fmt, gate_subnormal):
    """Rounded products -> ``(sm, e, skipped)``."""
    p = x.to(torch.float32) * w.to(torch.float32)
    p, skipped = round_product(p, fmt, gate_subnormal)
    sm, e = decompose(p, fmt)
    return sm, e, skipped


def mgs_dot_exact(x: torch.Tensor, w: torch.Tensor, fmt: FPFormat = E4M3,
                  mode: str = "dmac", gate_subnormal: bool = True,
                  dtype=torch.float32) -> torch.Tensor:
    """MGS dot products along the last axis (operands broadcast).

    ``mode="dmac"``: each product rounded to ``fmt``, exponent-binned
    exact sums, one combine (what the Fig. 8 unit computes).
    ``mode="exact"``: no product rounding; ``ix = sx << max(ex, 1)``
    split into three 7-bit balanced limbs a side, the nine int32 limb-pair
    dots combined ``a``-major in ``dtype``, then scaled by
    ``2**(-2 * (bias + mbits))``. The integer steps keep the reference's
    int32 registers: where a wide-exponent format (E5M2) leaves int32, the
    shift, the limb products and the sums wrap as the reference's do.
    """
    if mode == "dmac":
        sm, e, _ = _products(x, w, fmt, gate_subnormal)
        return combine_bins(bin_sums(sm, e, fmt), fmt, dtype)
    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r}")
    base = 7
    sides = []
    for v in (x, w):
        s, e = decompose(v.to(torch.float32), fmt)
        ix = _wrap32(s.to(torch.int64) << torch.clamp_min(e, 1).to(
            torch.int64))
        sides.append(_limbs(ix, base, 3))
    out = None
    for a, la in enumerate(sides[0]):
        for b, lb in enumerate(sides[1]):
            part = _wrap32(_wrap32(la * lb).sum(dim=-1)).to(torch.int32)
            term = part.to(dtype) * float(2.0 ** (base * (a + b)))
            out = term if out is None else out + term
    return out * float(2.0 ** (-2 * (fmt.bias + fmt.mbits)))


def mgs_matvec_exact(X: torch.Tensor, w: torch.Tensor, fmt: FPFormat = E4M3,
                     mode: str = "dmac") -> torch.Tensor:
    """Row-wise MGS dots: ``X @ w`` with MGS numerics."""
    return mgs_dot_exact(X, w[None, :], fmt=fmt, mode=mode)


def mgs_dot_dmac(x: torch.Tensor, w: torch.Tensor, fmt: FPFormat = E4M3,
                 narrow_bits: int = 5, gate_subnormal: bool = True,
                 dtype=torch.float32):
    """Bit-faithful sequential emulation of the FP8 dMAC unit (Fig. 8).

    Walks the K products in order. State per dot: ``fmt.n_bins`` narrow
    ``narrow_bits``-bit registers and exact per-bin flush totals (the wide
    register). A product that overflows its bin's register flushes the
    register and restarts it with the product. Returns
    ``(value, MGSStats)``.

    As in the reference, a product below the smallest subnormal is left
    out of the narrow adds, the sums and ``bin_hits`` even with
    ``gate_subnormal=False``; ``total_macs`` is K and ``final_flushes``
    is ``n_bins``.
    """
    lo, hi = -(1 << (narrow_bits - 1)), (1 << (narrow_bits - 1)) - 1
    sm, e, skipped = _products(x, w, fmt, gate_subnormal)
    lead, K = sm.shape[:-1], sm.shape[-1]
    dev = sm.device
    nb = fmt.n_bins
    narrow = torch.zeros(lead + (nb,), dtype=torch.int32, device=dev)
    flushed = torch.zeros_like(narrow)
    n_ovf = torch.zeros(lead, dtype=torch.int32, device=dev)
    n_narrow = torch.zeros_like(n_ovf)
    live = ~skipped
    idx = e.to(torch.int64).unsqueeze(-1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(K):
        ei, smi, do = idx[..., k, :], sm[..., k], live[..., k]
        cur = narrow.gather(-1, ei).squeeze(-1)
        t = cur + smi
        ovf = ((t > hi) | (t < lo)) & do
        flushed.scatter_add_(-1, ei, torch.where(ovf, cur, zero)[..., None])
        new = torch.where(ovf, smi, torch.where(do, t, cur))
        narrow.scatter_(-1, ei, new[..., None])
        n_ovf += ovf
        n_narrow += do
    value = combine_bins(flushed + narrow, fmt, dtype)
    bins = torch.arange(nb, dtype=torch.int32, device=dev)
    bin_hits = ((e.unsqueeze(-1) == bins) & live.unsqueeze(-1)).sum(
        dim=-2, dtype=torch.int32)
    stats = MGSStats(
        total_macs=torch.full(lead, K, dtype=torch.int32, device=dev),
        skipped=skipped.sum(dim=-1, dtype=torch.int32),
        narrow_adds=n_narrow, wide_flushes=n_ovf,
        final_flushes=torch.full(lead, nb, dtype=torch.int32, device=dev),
        bin_hits=bin_hits)
    return value, stats


def mgs_dot_narrow_clipped(x: torch.Tensor, w: torch.Tensor,
                           fmt: FPFormat = E4M3, narrow_bits: int = 5,
                           gate_subnormal: bool = True, dtype=torch.float32):
    """MGS restricted to the narrow registers, clipping on overflow (the
    Fig. 3 ablation: without the wide fallback persistent overflows
    saturate). Returns ``(value, n_clips)``."""
    lo, hi = -(1 << (narrow_bits - 1)), (1 << (narrow_bits - 1)) - 1
    sm, e, skipped = _products(x, w, fmt, gate_subnormal)
    lead, K = sm.shape[:-1], sm.shape[-1]
    narrow = torch.zeros(lead + (fmt.n_bins,), dtype=torch.int32,
                         device=sm.device)
    n_clip = torch.zeros(lead, dtype=torch.int32, device=sm.device)
    idx = e.to(torch.int64).unsqueeze(-1)
    smk = torch.where(skipped, torch.zeros_like(sm), sm)
    for k in range(K):
        ei = idx[..., k, :]
        t = narrow.gather(-1, ei).squeeze(-1) + smk[..., k]
        n_clip += (t > hi) | (t < lo)
        narrow.scatter_(-1, ei, t.clamp(lo, hi)[..., None])
    return combine_bins(narrow, fmt, dtype), n_clip
