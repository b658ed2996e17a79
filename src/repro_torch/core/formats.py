"""Low-bitwidth floating-point formats (bit-level codecs) in PyTorch.

The port's copy of ``repro.core.formats``. A value ``v`` of a format ``f``
is represented as an integer *signed mantissa* ``sm`` and an
*exponent-bin index* ``e`` with::

    v = sm * 2 ** (max(e, 1) - f.bias - f.mbits)

Rounding is IEEE round-to-nearest-even (``torch.round``) on a
mantissa-scaled value; overflow saturates to the format's max finite value.

Two deliberate choices:

* Codes are built with integer bit manipulation, never through
  ``torch.float8_e4m3fn``: that dtype encodes ``-0.0`` as ``0x80`` while
  :func:`encode_bits` gives ``0x00``, and E3M4 has no torch dtype at all.
* Powers of two are assembled from exponent bits (:func:`pow2`), so every
  binade scale is exact. (XLA:CPU's ``exp2`` is a few ulps off for
  ``|x| >= 13``, which only the wide-exponent E5M2 reaches.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FPFormat", "E4M3", "E5M2", "E3M4", "get_format", "pow2",
           "round_to_format", "decompose", "recompose", "encode_bits",
           "decode_bits", "decode_sm_e", "quantum_exponent",
           "representable_values"]


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A sign + ``ebits`` exponent + ``mbits`` mantissa floating point format.

    OCP FP8 conventions: exponent bias ``2**(ebits-1) - 1``, subnormals,
    no infinities (overflow saturates).
    """

    name: str
    ebits: int
    mbits: int
    top_exponent_reserved: bool = False
    nan_codes_at_top: int = 1

    @property
    def bias(self) -> int:
        return 2 ** (self.ebits - 1) - 1

    @property
    def n_bins(self) -> int:
        return 2**self.ebits

    @property
    def emax(self) -> int:
        top = self.n_bins - 1
        return top - 1 if self.top_exponent_reserved else top

    @property
    def emax_unbiased(self) -> int:
        return self.emax - self.bias

    @property
    def emin_unbiased(self) -> int:
        return 1 - self.bias

    @property
    def mant_lead(self) -> int:
        return 2**self.mbits

    @property
    def max_mantissa(self) -> int:
        hi = 2 ** (self.mbits + 1) - 1
        if not self.top_exponent_reserved:
            hi -= self.nan_codes_at_top
        return hi

    @property
    def max_finite(self) -> float:
        return float(self.max_mantissa) * 2.0 ** (self.emax - self.bias
                                                  - self.mbits)

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (1 - self.bias - self.mbits)

    @property
    def min_subnormal_exp(self) -> int:
        return 1 - self.bias - self.mbits

    @property
    def max_abs_sm(self) -> int:
        """Largest |signed mantissa| over all bins (for overflow analysis)."""
        return 2 ** (self.mbits + 1) - 1

    def scale(self, e: torch.Tensor) -> torch.Tensor:
        """Per-bin power-of-two scale: value = sm * 2**scale_exp(e), as an
        exact float32 (:func:`pow2`)."""
        return pow2(self.scale_exp(torch.as_tensor(e)))

    def scale_exp(self, e: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(torch.as_tensor(e), 1) - (self.bias
                                                         + self.mbits)


E4M3 = FPFormat("e4m3", ebits=4, mbits=3)
E5M2 = FPFormat("e5m2", ebits=5, mbits=2, top_exponent_reserved=True)
E3M4 = FPFormat("e3m4", ebits=3, mbits=4)

_FORMATS = {f.name: f for f in (E4M3, E5M2, E3M4)}


def get_format(name: str) -> FPFormat:
    return _FORMATS[name]


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**e`` for integer ``e`` in the normal range
    [-126, 127], assembled from exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _floor_log2(ax: torch.Tensor) -> torch.Tensor:
    """floor(log2(ax)) for ax > 0, exact via frexp."""
    return torch.frexp(ax).exponent.to(torch.int32) - 1


def _as_f32(x):
    x = torch.as_tensor(x)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def round_to_format(x: torch.Tensor, fmt: FPFormat = E4M3) -> torch.Tensor:
    """RNE-round float values to ``fmt``; saturating; subnormal-aware.

    Returns the rounded value in the input's float dtype (half-precision
    inputs are rounded in float32 and cast back, losslessly). NaNs
    propagate.
    """
    x_in = torch.as_tensor(x)
    x = _as_f32(x_in)
    ax = x.abs()
    e = _floor_log2(torch.where(ax > 0, ax, torch.ones_like(ax))).clamp(
        fmt.emin_unbiased, fmt.emax_unbiased)
    q = pow2(e - fmt.mbits)
    r = torch.round(ax / q) * q
    r = torch.clamp_max(r, fmt.max_finite)
    r = torch.where(ax == 0, torch.zeros_like(r), r)
    out = torch.where(torch.isnan(x), x, torch.copysign(r, x))
    return out.to(x_in.dtype)


def decompose(v: torch.Tensor, fmt: FPFormat = E4M3):
    """Format-exact values -> ``(sm, e)`` int32 tensors with
    ``v == sm * 2**(max(e,1) - bias - mbits)``."""
    v = _as_f32(v)
    av = v.abs()
    eu = _floor_log2(torch.where(av > 0, av, torch.ones_like(av)))
    is_sub = (eu < fmt.emin_unbiased) | (av == 0)
    e = torch.where(is_sub, torch.zeros_like(eu), eu + fmt.bias)
    sc = pow2(torch.clamp_min(e, 1) - (fmt.bias + fmt.mbits))
    sm = torch.round(v / sc).to(torch.int32)
    sm = torch.where(av == 0, torch.zeros_like(sm), sm)
    return sm, e


def recompose(sm, e, fmt: FPFormat = E4M3, dtype=torch.float32):
    """Inverse of :func:`decompose`."""
    sc = pow2(torch.clamp_min(e, 1) - (fmt.bias + fmt.mbits))
    return (sm.to(torch.float32) * sc).to(dtype)


def encode_bits(v: torch.Tensor, fmt: FPFormat = E4M3) -> torch.Tensor:
    """Pack format-exact values into uint8 codes, MSB..LSB
    sign | exponent | mantissa fraction. Zero encodes as 0 (+0.0)."""
    sm, e = decompose(v, fmt)
    sign = (sm < 0).to(torch.int32)
    mag = sm.abs()
    frac = torch.where(e > 0, mag - fmt.mant_lead, mag)
    code = (sign << (fmt.ebits + fmt.mbits)) | (e << fmt.mbits) | frac
    return (code & 0xFF).to(torch.uint8)


def decode_sm_e(code: torch.Tensor, fmt: FPFormat = E4M3):
    """Unpack integer codes to ``(sm, e)`` int32 tensors — the single
    source of truth for the code layout (the CUDA kernels repeat it in
    ``csrc/mgs_common.cuh``)."""
    code = code.to(torch.int32)
    frac = code & (fmt.mant_lead - 1)
    e = (code >> fmt.mbits) & (fmt.n_bins - 1)
    sign = (code >> (fmt.ebits + fmt.mbits)) & 1
    mag = torch.where(e > 0, frac + fmt.mant_lead, frac)
    sm = torch.where(sign == 1, -mag, mag)
    return sm, e


def decode_bits(code: torch.Tensor, fmt: FPFormat = E4M3,
                dtype=torch.float32) -> torch.Tensor:
    """Unpack codes produced by :func:`encode_bits` to values."""
    sm, e = decode_sm_e(code, fmt)
    return recompose(sm, e, fmt, dtype)


def quantum_exponent(fmt: FPFormat, e: torch.Tensor) -> torch.Tensor:
    """Power-of-two exponent of one mantissa ULP in bin ``e``."""
    return fmt.scale_exp(e)


def representable_values(fmt: FPFormat = E4M3) -> np.ndarray:
    """All finite non-negative representable values, ascending (numpy)."""
    vals = []
    for e in range(fmt.n_bins):
        if fmt.top_exponent_reserved and e == fmt.n_bins - 1:
            continue
        for m in range(fmt.mant_lead):
            mag = m if e == 0 else m + fmt.mant_lead
            if (not fmt.top_exponent_reserved and e == fmt.n_bins - 1
                    and mag > fmt.max_mantissa):
                continue
            vals.append(mag * 2.0 ** (max(e, 1) - fmt.bias - fmt.mbits))
    return np.unique(np.array(vals, dtype=np.float64))
