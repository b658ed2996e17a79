"""Weight / activation quantizers (paper §2.1 / §2.2).

FP8: absmax scaling into the format's range and RNE rounding. Quantized
*values* are carried as format-exact float32 tensors plus a scale — the
form the MGS kernels consume (they re-derive mantissa / exponent bit
fields from the packed codes). Integer: uniform b-bit quantization,
symmetric (int32 values, no offset) or asymmetric (with an int32 offset).

Division semantics follow the reference's compiled graph: a divide by a
*constant* (``amax / max_finite``, ``amax / (2**(b-1) - 1)``) is lowered
by XLA to a multiply by the float32 reciprocal, while ``x / scale`` by a
runtime scale stays a true division. :func:`recip` reproduces the first;
the second is a plain tensor ``/`` (never by a Python scalar, which
PyTorch's CUDA division would itself turn into a reciprocal multiply).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.formats import FPFormat, round_to_format

__all__ = ["QTensor", "quantize_fp8", "quantize_fp8_static",
           "quantize_int", "dequantize_int", "fake_quant_fp8",
           "fake_quant_int", "recip", "TINY"]

#: ``jnp.finfo(float32).tiny`` — the absmax floor.
TINY = float(np.finfo(np.float32).tiny)


def recip(c: float) -> float:
    """The float32 reciprocal of ``c`` (as XLA folds ``x / c``)."""
    return float(np.float32(1.0) / np.float32(c))


class QTensor(NamedTuple):
    """Format-exact values (int32 on the integer path) + a broadcastable
    scale (``x ≈ q * scale``) + the integer path's zero point (``None`` =
    symmetric)."""

    q: torch.Tensor
    scale: torch.Tensor
    offset: Optional[torch.Tensor] = None


def _absmax(x: torch.Tensor, axis):
    if axis is None:
        m = x.abs().amax()
    else:
        m = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(m, TINY)


def quantize_fp8(x: torch.Tensor, fmt: FPFormat,
                 axis: Union[None, int, Sequence[int]] = None,
                 margin: float = 1.0, amax=None) -> QTensor:
    """Scale ``x`` into ``fmt``'s range (absmax) and RNE-round.

    ``axis``: reduction axis (or axes) for the scale, kept as size-1 dims;
    ``None`` = one per-tensor scalar. A tuple of all non-leading axes gives
    one scale per leading slice — the reference's ``vmap`` of the
    per-tensor quantizer. ``amax``: the absmax to scale by, already taken
    (and clamped at ``TINY``) over more than ``x``: a slice of a tensor
    sharded over a mesh of ranks quantizes as the whole tensor would.
    """
    x = x.to(torch.float32)
    if amax is None:
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


def quantize_int(x: torch.Tensor, bits: int = 8,
                 axis: Union[None, int, Sequence[int]] = None,
                 symmetric: bool = True, amax=None) -> QTensor:
    """Uniform b-bit quantization (paper §2.1).

    Symmetric: ``q = round(x / s)``, ``s = absmax / (2**(b-1) - 1)``, no
    offset. Asymmetric: ``s = range / (2**b - 1)`` and the offset
    ``o = -2**(b-1) - round(min / s)``, so that real zero maps to an
    integer. ``round`` is half to even; ``axis`` and (symmetric only)
    ``amax`` as in :func:`quantize_fp8`.
    """
    x = x.to(torch.float32)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if symmetric:
        if amax is None:
            amax = _absmax(x, axis)
        scale = amax * recip(2 ** (bits - 1) - 1)
        q = torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)
        return QTensor(q=q, scale=scale)
    if axis is None:
        xmin, xmax = x.amin(), x.amax()
    else:
        xmin = x.amin(dim=axis, keepdim=True)
        xmax = x.amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(xmax - xmin, 1e-12) * recip(2 ** bits - 1)
    offset = -(2 ** (bits - 1)) - torch.round(xmin / scale)
    q = torch.clamp(torch.round(x / scale) + offset, lo, hi).to(torch.int32)
    return QTensor(q=q, scale=scale, offset=offset.to(torch.int32))


def dequantize_int(t: QTensor) -> torch.Tensor:
    """``x* = s (q - o)`` (paper §2.1)."""
    q = t.q.to(torch.float32)
    if t.offset is not None:
        q = q - t.offset.to(torch.float32)
    return q * t.scale


def fake_quant_fp8(x: torch.Tensor, fmt: FPFormat,
                   axis: Union[None, int, Sequence[int]] = None
                   ) -> torch.Tensor:
    """Quantize-dequantize (QDQ), for accuracy studies."""
    t = quantize_fp8(x, fmt, axis)
    return t.q * t.scale


def fake_quant_int(x: torch.Tensor, bits: int = 8,
                   axis: Union[None, int, Sequence[int]] = None,
                   symmetric: bool = True) -> torch.Tensor:
    return dequantize_int(quantize_int(x, bits, axis, symmetric))
