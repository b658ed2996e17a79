"""Quantized linear projection: ``(..., K) @ (K, *tail)`` through
:func:`repro_torch.quant.qeinsum`. ``activation`` / ``bias`` form the
layer epilogue (inside the kernel on the fused exact path); ``site`` tags
the call for calibration (``quant.calibrate``). ``gather=False`` leaves a
sharded weight's output columns this rank's (``quant.qeinsum``)."""

from __future__ import annotations

from typing import Optional

from repro_torch.quant import PreparedWeight, QuantConfig, qeinsum

__all__ = ["proj"]

_TAIL_LETTERS = "nopqrstu"


def proj(x, w, quant: QuantConfig, *, activation: str = "none", bias=None,
         site: Optional[str] = None, gather: bool = True):
    """x: (..., K) @ w: (K, *tail) -> (..., *tail); ``w`` raw or prepared."""
    tail = w.tail if isinstance(w, PreparedWeight) else tuple(w.shape[1:])
    t = _TAIL_LETTERS[:len(tail)]
    K = x.shape[-1]
    out = qeinsum(f"mk,k{t}->m{t}", x.reshape(-1, K), w, quant, bias=bias,
                  activation=activation, out_dtype=x.dtype, site=site,
                  gather=gather)
    return out.reshape(tuple(x.shape[:-1]) + tuple(out.shape[1:]))
