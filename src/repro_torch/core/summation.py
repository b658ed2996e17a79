"""Classical low-precision summation algorithms (the paper's Fig. 3
baselines), the port of ``repro.core.summation``.

Models an *accumulator-limited* floating point: every intermediate sum is
rounded to an accumulator format with a narrow mantissa (swamping) and a
bounded exponent range (clipping). Sequential, pairwise and Kahan
summation run under such an accumulator; ``fp32_sum`` is the wide
baseline.

Each function sums along the last axis with its state vectorised over
every leading dim: a plain loop over the reduction axis, the same on the
CPU and on the card, rounding in the reference's order (so the first
four are bitwise equal to it).
"""

from __future__ import annotations

import torch

from .formats import FPFormat, round_to_format

__all__ = ["acc_format", "lowprec_add", "sequential_sum", "pairwise_sum",
           "kahan_sum", "fp32_sum"]


def acc_format(mantissa_bits: int, ebits: int = 4) -> FPFormat:
    """An accumulator format: E4-range exponent, ``mantissa_bits``
    significant bits (the leading one included, so ``mbits =
    mantissa_bits - 1`` stored bits). Fig. 3 uses ``acc_format(4)``."""
    return FPFormat(f"acc_e{ebits}m{mantissa_bits - 1}", ebits=ebits,
                    mbits=mantissa_bits - 1)


def lowprec_add(a, b, fmt: FPFormat) -> torch.Tensor:
    """One accumulator add: exact add, then RNE-round to ``fmt``
    (swamping), saturating at the format's max (clipping)."""
    return round_to_format(a + b, fmt)


def sequential_sum(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Left-to-right summation in accumulator precision."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = lowprec_add(acc, x[..., k], fmt)
    return acc


def pairwise_sum(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Balanced-tree summation in accumulator precision, over the last
    axis padded with zeros to a power of two."""
    n = x.shape[-1]
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pow2 - n,))], dim=-1)
    while x.shape[-1] > 1:
        x = round_to_format(x[..., 0::2] + x[..., 1::2], fmt)
    return x[..., 0]


def kahan_sum(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Kahan compensated summation in accumulator precision."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for k in range(x.shape[-1]):
        y = round_to_format(x[..., k] - c, fmt)
        t = round_to_format(s + y, fmt)
        c = round_to_format(round_to_format(t - s, fmt) - y, fmt)
        s = t
    return s


def fp32_sum(x: torch.Tensor) -> torch.Tensor:
    """Wide-accumulator baseline (24-bit mantissa): a float32 reduction,
    in torch's order."""
    return x.to(torch.float32).sum(dim=-1)
