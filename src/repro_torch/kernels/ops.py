"""Public dispatch around the MGS matmul kernel (``repro.kernels.ops``).

``mgs_matmul`` routes exact-mode products to the fused B1 kernel wrapper
(``use_kernel=True, fused=True``: packed codes in, the scale / bias /
activation epilogue inside the kernel) or to the plain oracle
(``use_kernel=False``: epilogue applied afterwards, the same float32
operations). Batched LHS ``(..., K)`` is flattened to ``(M, K)``.

The other kernels of the reference are not ported yet and raise, naming
their ROADMAP items: the pre-decomposed limb kernel (``fused=False``, B4),
the stationary schedules (B3) and the dmac numerics (B5).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import E4M3, FPFormat, encode_bits
from . import ref as _ref
from .mgs_matmul import ACTIVATIONS, mgs_matmul_exact_fused

__all__ = ["mgs_matmul", "apply_epilogue"]


def apply_epilogue(out, scale, bias, activation: str):
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return ACTIVATIONS[activation](out)


def mgs_matmul(x, w, fmt: FPFormat = E4M3, mode: str = "exact", *,
               use_kernel: bool = True, fused: bool = False,
               block_k: int = 128, flush_period: Optional[int] = None,
               schedule: str = "output", scale=None, bias=None,
               activation: str = "none"):
    """MGS quantized matmul: ``(..., K) @ (K, N)`` with exact numerics.

    ``x`` holds format-exact FP8 values (or uint8 codes); ``w`` is a
    ``(K, N)`` tensor of format-exact values or a
    :class:`repro_torch.quant.prepared.PreparedWeight` (anything with
    ``codes`` / ``values()``). The CUDA kernel picks its own M/N tiles.
    """
    if mode != "exact":
        raise NotImplementedError(
            f"mode {mode!r}: the dmac kernel is ROADMAP item B5")
    ix_bits = fmt.mbits + 1 + fmt.emax
    if ix_bits > 21:
        raise ValueError(
            f"exact mode supports narrow-exponent formats only (E4M3/"
            f"E3M4); {fmt.name} (ix={ix_bits}b) needs dmac mode")
    prepared = hasattr(w, "codes") and hasattr(w, "values")
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    n_out = w.codes.shape[-1] if prepared else w.shape[-1]
    if not use_kernel:
        if x2.dtype == torch.uint8:
            raise ValueError("the plain path takes values, not codes")
        out = _ref.mgs_matmul_ref(x2, w.values() if prepared else w, fmt,
                                  mode)
        out = apply_epilogue(out, scale, bias, activation)
    elif not fused:
        raise NotImplementedError(
            "the pre-decomposed limb kernel (fused=False) is ROADMAP item "
            "B4; use the fused kernel or use_kernel=False")
    elif schedule != "output":
        raise NotImplementedError(
            f"schedule {schedule!r}: the stationary kernels are ROADMAP "
            "item B3 (bit-identical to schedule='output')")
    else:
        xc = x2 if x2.dtype == torch.uint8 else encode_bits(x2, fmt)
        wc = w.codes if prepared else encode_bits(w, fmt)
        out = mgs_matmul_exact_fused(
            xc, wc, fmt, scale=scale, bias=bias, activation=activation,
            block_k=block_k, flush_period=flush_period)
    return out.reshape(tuple(lead) + (n_out,))
