"""The dMAC half of Markov Greedy Sums (the port of ``repro.core.mgs``):
what the paper-numerics matmul needs.

A dMAC (the paper's Fig. 8 unit) rounds every product back into the FP8
format, adds its signed mantissa ``sm`` into the narrow accumulator of its
exponent bin ``e``, and shifts and adds the bins once per dot product.
Flushing a narrow accumulator into its wide register never loses bits, so
the per-bin totals are exact integers whatever the order of the sum; only
the final float32 combine rounds, and it runs in ascending bin order with
exact power-of-two scales (the kernels' order, ``mgs_matmul_dmac``).

The dot-level analysis half of the reference (the sequential dMAC emulator
and its overflow statistics, the clipped variant) is a later slice.
"""

from __future__ import annotations

import torch

from .formats import E4M3, FPFormat, round_to_format

__all__ = ["round_product", "bin_sums", "combine_bins", "bin_scales"]


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
