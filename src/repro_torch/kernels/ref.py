"""Plain oracles of the MGS matmul numerics (``repro.kernels.ref``).

Straightforward and memory-hungry (the dmac oracle holds an ``M x K x N``
product tensor): test sizes only. Operands are format-exact FP8 values.

* ``mode="exact"``: ``out[i, j] = sum_k x[i, k] * w[k, j]`` exactly,
  through 20-bit fixed-point limbs, then one float32 combine in ascending
  class order — bit-identical to the exact kernels in the single-flush
  regime (the default worst-case period never flushes mid-K at practical
  depths).
* ``mode="dmac"`` (the paper's Fig. 8): every product rounded to the
  format (``core.mgs.round_product``), exponent-binned exact integer sums,
  one ascending combine per output.
* :func:`wide_matmul_ref`: the FP32-accumulation baseline the paper
  compares against.
* :func:`swamp_matmul_ref`: the Fig. 3 failure mode, a sequential
  narrow-mantissa accumulator (no kernel; it walks K).
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import E4M3, FPFormat, decompose
from repro_torch.core.mgs import bin_sums, combine_bins, round_product
from .mgs_matmul import _limb_split, _fixed_point, _class_int32

__all__ = ["mgs_matmul_ref", "wide_matmul_ref", "swamp_matmul_ref"]


def mgs_matmul_ref(x, w, fmt: FPFormat = E4M3, mode: str = "exact",
                   gate_subnormal: bool = True):
    """Oracle matmul with MGS numerics. x: (M, K), w: (K, N) format-exact."""
    if mode == "dmac":
        p = x.to(torch.float32)[:, :, None] * w.to(torch.float32)[None]
        p, _ = round_product(p, fmt, gate_subnormal)
        sm, e = decompose(p, fmt)
        return combine_bins(bin_sums(sm, e, fmt, axis=1), fmt)
    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r}")
    base, nlimb = 7, 3
    k_limit = (2**31 - 1) // (nlimb * (1 << (base - 1)) ** 2)
    if x.shape[-1] > k_limit:
        raise ValueError(
            f"exact-mode reference supports contraction depth K <= "
            f"{k_limit} (unflushed int32 class sums); got {x.shape[-1]} — "
            "use the kernel path")
    sx, ex = decompose(x, fmt)
    sw, ew = decompose(w, fmt)
    lx = [l.to(torch.float64) for l in _limb_split(_fixed_point(sx, ex))]
    lw = [l.to(torch.float64) for l in _limb_split(_fixed_point(sw, ew))]
    accs = [None] * (2 * nlimb - 1)
    for a in range(nlimb):
        for b in range(nlimb):
            part = torch.matmul(lx[a], lw[b])
            c = a + b
            accs[c] = part if accs[c] is None else accs[c] + part
    out = _class_int32(accs[0]).to(torch.float32)
    for c in range(1, 2 * nlimb - 1):
        out = out + _class_int32(accs[c]).to(torch.float32) * float(
            2 ** (base * c))
    return out * 2.0 ** (-2 * (fmt.bias + fmt.mbits))


def wide_matmul_ref(x, w, dtype=torch.float32):
    """FP32-accumulation baseline (what tensor-core hardware does): a
    plain float32 product, outside any kernel as in the reference. TF32 is
    switched off for it, so the card multiplies in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(dtype)


def swamp_matmul_ref(x, w, fmt: FPFormat = E4M3, acc_mantissa_bits: int = 4,
                     acc_ebits: int = 4):
    """Sequential narrow-accumulator matmul, the Fig. 3 failure mode:
    ``(..., M, K) @ (..., K, N)``, leading dims independent slices.

    Every product is rounded to ``fmt`` (subnormal products gated), and
    every partial sum to an ``acc_mantissa_bits``-significant-bit
    accumulator (swamping), saturating at its max (overflow). The products
    round one by one, so they are formed a block of K-steps at a time (at
    most ``_SWAMP_BLOCK`` elements): the reference's bits without its
    ``M x K x N`` product tensor. Slices walk K together, elementwise, so
    each slice's bits are its own call's.
    """
    acc_fmt = FPFormat(f"acc{acc_mantissa_bits}", ebits=acc_ebits,
                       mbits=acc_mantissa_bits - 1)
    x, w = x.to(torch.float32), w.to(torch.float32)
    K = x.shape[-1]
    lead = torch.broadcast_shapes(x.shape[:-2], w.shape[:-2])
    shape = tuple(lead) + (x.shape[-2], w.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    kb = max(1, _SWAMP_BLOCK // max(acc.numel(), 1))
    for k0 in range(0, K, kb):
        k1 = min(K, k0 + kb)
        p, _ = round_product(x[..., k0:k1, None] * w[..., None, k0:k1, :],
                             fmt, True)
        for j in range(k1 - k0):
            acc = _round_finite(acc + p[..., j, :], acc_fmt)
    return acc


def _round_finite(x, fmt: FPFormat):
    """:func:`round_to_format` of finite float32 ``x``, bit for bit, in
    half its kernels (the swamp loop's body: a launch-bound walk over K).

    Zero needs no case of its own (it rounds to itself at any quantum, its
    sign kept by ``copysign``) and finite inputs no NaN case; the quantum
    ``2**(clamp(floor(log2|x|), emin, emax) - mbits)`` is assembled from
    ``frexp``'s exponent in one add, one clamp and one shift."""
    ax = x.abs()
    off = 126 - fmt.mbits           # frexp's exponent is floor(log2) + 1
    e = torch.clamp(torch.frexp(ax).exponent + off,
                    fmt.emin_unbiased + off + 1, fmt.emax_unbiased + off + 1)
    q = (e << 23).view(torch.float32)
    return torch.copysign(torch.clamp_max(torch.round(ax / q) * q,
                                          fmt.max_finite), x)


#: products a block of :func:`swamp_matmul_ref` holds at once
_SWAMP_BLOCK = 1 << 22
