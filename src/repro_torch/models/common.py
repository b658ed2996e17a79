"""Shared model building blocks: init, norms, RoPE, activations.

Parameters are plain nested dicts of tensors with the reference's keys
and layout — per-layer weights stacked on a leading ``layers`` axis — so
a reference tree converts one to one (:mod:`repro_torch.convert`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mgs_matmul import ACTIVATIONS
from repro_torch.quant.quantize import recip

__all__ = ["dtype_of", "normal_param", "pairwise_sum_last", "softmax_last",
           "rms_norm", "rope_freqs", "apply_rope", "gelu", "silu",
           "ACTIVATIONS"]

# ATen's CPU kernels are compiled once per vector ISA (``default``, AVX2,
# AVX512) and picked at run time; the vectorized ``softmax``, ``pow``,
# ``log1p``, ``logaddexp``, ``sigmoid`` and ``tanh_backward`` change bits
# between them. The port's CPU results stay the same on every host by
# composing those functions from ops that do not (``exp``, ``log``,
# ``tanh``, ``sqrt``, IEEE arithmetic and sums). Not so ``normal_param``:
# float32 ``normal_`` is vectorized too, so the CPU weights that
# ``init_params`` draws depend on the host (parity tests that need the same
# weights everywhere draw them with numpy).


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def normal_param(gen: torch.Generator, shape: Tuple[int, ...], *,
                 scale: float | None = None, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``N(0, 1) * scale`` with the reference's default fan-in scale
    ``1 / sqrt(shape[0])`` (``ParamFactory.normal``). Stacked weights pass
    the per-layer fan-in explicitly."""
    if scale is None:
        scale = 1.0 / shape[0] ** 0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def pairwise_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Shape-independent pairwise sum over the last axis: the halving tree
    ``x[..., 0::2] + x[..., 1::2]`` over a zero-padded power of two."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def softmax_last(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its order: ``exp(x - max)``
    over its sum (the pairwise row sum)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / pairwise_sum_last(e)[..., None]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with the pairwise row sum (the mean is a multiply by the
    float32 reciprocal of the width, as the reference's compiled graph
    computes ``/ n``)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (pairwise_sum_last(x32 * x32) * recip(x.shape[-1]))[..., None]
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


_ROPE_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """``1 / theta ** (arange(half) / half)`` in float32. The power is the
    host's double ``pow`` rounded once (ATen's vectorized ``pow`` moves
    bits by ISA), kept per device."""
    key = (head_dim, float(theta), str(torch.device(device or "cpu")))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        half = head_dim // 2
        e = torch.arange(0, half, dtype=torch.float32) * recip(half)
        pw = torch.tensor([float(theta) ** v for v in e.tolist()],
                          dtype=torch.float32)
        freqs = _ROPE_FREQS[key] = (1.0 / pw).to(device)
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0):
    """x: (..., T, n_heads, head_dim); positions: (..., T) int."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = rope_freqs(head_dim, theta, device=x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    out = torch.cat([rot1, rot2, x[..., 2 * half:].to(rot1.dtype)], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    return ACTIVATIONS["gelu"](x)


def silu(x):
    return ACTIVATIONS["silu"](x)
