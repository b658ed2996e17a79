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

__all__ = ["dtype_of", "normal_param", "pairwise_sum_last", "rms_norm",
           "rope_freqs", "apply_rope", "gelu", "silu", "ACTIVATIONS"]


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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with the pairwise row sum (the mean is a multiply by the
    float32 reciprocal of the width, as the reference's compiled graph
    computes ``/ n``)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (pairwise_sum_last(x32 * x32) * recip(x.shape[-1]))[..., None]
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    e = torch.arange(0, half, dtype=torch.float32, device=device) * recip(half)
    return 1.0 / torch.pow(torch.full_like(e, theta), e)


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
