"""FP8 quantizers (absmax scaling + RNE rounding).

Quantized *values* are carried as format-exact float32 tensors plus a
scale — the form the MGS kernels consume (they re-derive mantissa /
exponent bit fields from the packed codes).

Division semantics follow the reference's compiled graph: a divide by a
*constant* (``amax / max_finite``) is lowered by XLA to a multiply by the
float32 reciprocal, while ``x / scale`` by a runtime scale stays a true
division. :func:`recip` reproduces the first; the second is a plain
tensor ``/`` (never by a Python scalar, which PyTorch's CUDA division
would itself turn into a reciprocal multiply).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch.core.formats import FPFormat, round_to_format

__all__ = ["QTensor", "quantize_fp8", "quantize_fp8_static", "recip",
           "TINY"]

#: ``jnp.finfo(float32).tiny`` — the absmax floor.
TINY = float(np.finfo(np.float32).tiny)


def recip(c: float) -> float:
    """The float32 reciprocal of ``c`` (as XLA folds ``x / c``)."""
    return float(np.float32(1.0) / np.float32(c))


class QTensor(NamedTuple):
    """Format-exact values + a broadcastable scale (``x ≈ q * scale``)."""

    q: torch.Tensor
    scale: torch.Tensor


def _absmax(x: torch.Tensor, axis):
    if axis is None:
        m = x.abs().amax()
    else:
        m = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(m, TINY)


def quantize_fp8(x: torch.Tensor, fmt: FPFormat,
                 axis: Union[None, int, Sequence[int]] = None,
                 margin: float = 1.0) -> QTensor:
    """Scale ``x`` into ``fmt``'s range (absmax) and RNE-round.

    ``axis``: reduction axis (or axes) for the scale, kept as size-1 dims;
    ``None`` = one per-tensor scalar. A tuple of all non-leading axes gives
    one scale per leading slice — the reference's ``vmap`` of the
    per-tensor quantizer.
    """
    x = x.to(torch.float32)
    amax = _absmax(x, axis)
    scale = amax * recip(fmt.max_finite * margin)
    q = round_to_format(x / scale, fmt)
    return QTensor(q=q, scale=scale)


def quantize_fp8_static(x: torch.Tensor, fmt: FPFormat, amax, *,
                        dynamic_rows: bool = True) -> QTensor:
    """:func:`quantize_fp8` over ``(N, K)`` rows with a fixed absmax.

    ``amax``: a positive scalar, or a scalar / per-row ``(N, 1)`` tensor.
    Rows are clipped into ``[-amax, amax]`` and divided by the same scale,
    so a row whose own absmax equals ``amax`` gets codes and scale
    identical to ``quantize_fp8(x, fmt, axis=1)``. A tensor entry ``<= 0``
    selects the dynamic per-row reduce for its row (the same
    ``clamp_min(TINY)`` guard), bit-identical to ``quantize_fp8(x, fmt,
    axis=1)``; ``dynamic_rows=False`` promises that no entry is ``<= 0``
    and skips that reduce.
    """
    x = x.to(torch.float32)
    a = torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    if dynamic_rows and isinstance(amax, torch.Tensor):
        a = torch.where(a > 0.0, a, _absmax(x, 1))
    scale = a * recip(fmt.max_finite)
    q = round_to_format(torch.clamp(x, -a, a) / scale, fmt)
    return QTensor(q=q, scale=torch.broadcast_to(scale, (x.shape[0], 1)))
