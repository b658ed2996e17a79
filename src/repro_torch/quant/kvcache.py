"""Packed-FP8 quantized KV cache for decode serving (dense layout).

K and V are stored as packed FP8 codes, 1 byte per element, plus one
float32 scale per cached (position, head) entry::

    k[b, s, h, :] == decode_bits(k_codes[b, h, s, :]) * k_scale[b, h, s]

The per-entry scale makes the cache append-only: :func:`append_kv`
quantizes exactly the new positions, and old codes and scales never
change. The kv-head axis sits before the sequence axis, so the decode
kernel's ``(B * KV, S, hd)`` view is a reshape.

Unlike the reference (pure functions on immutable arrays), :func:`append_kv`
writes the new entries into the planes in place and returns the same
cache: the cache is the largest serving buffer, and copying it per step
would double its traffic. The paged half of the reference module is a
later slice (ROADMAP A6/A7).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.formats import E4M3, FPFormat, encode_bits, \
    round_to_format
from .quantize import TINY, recip

__all__ = ["QuantizedKVCache", "quantize_kv", "append_kv",
           "init_quantized_kv"]


class QuantizedKVCache(NamedTuple):
    """Packed-code KV planes (one attention layer's view, or a stack)."""

    k_codes: torch.Tensor   # (..., KV, S, hd) uint8
    v_codes: torch.Tensor   # (..., KV, S, hd) uint8
    k_scale: torch.Tensor   # (..., KV, S) float32
    v_scale: torch.Tensor   # (..., KV, S) float32


def quantize_kv(x: torch.Tensor, fmt: FPFormat = E4M3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., hd)`` K or V vectors -> ``(codes, scale)``: uint8 codes and
    one float32 scale per vector (absmax over ``hd`` / max finite)."""
    x = x.to(torch.float32)
    amax = torch.clamp_min(x.abs().amax(dim=-1), TINY)
    scale = amax * recip(fmt.max_finite)
    q = round_to_format(x / scale[..., None], fmt)
    return encode_bits(q, fmt), scale


def init_quantized_kv(lead, n_heads: int, seq: int, head_dim: int, *,
                      device=None) -> QuantizedKVCache:
    """An all-zero packed cache ``(*lead, n_heads, seq, head_dim)``; code 0
    is +0.0 and a 0.0 scale keeps unwritten entries exactly inert."""
    full = tuple(lead) + (n_heads, seq, head_dim)
    srow = tuple(lead) + (n_heads, seq)
    return QuantizedKVCache(
        k_codes=torch.zeros(full, dtype=torch.uint8, device=device),
        v_codes=torch.zeros(full, dtype=torch.uint8, device=device),
        k_scale=torch.zeros(srow, dtype=torch.float32, device=device),
        v_scale=torch.zeros(srow, dtype=torch.float32, device=device))


def append_kv(cache: QuantizedKVCache, k_new, v_new, pos: int,
              fmt: FPFormat = E4M3) -> QuantizedKVCache:
    """Quantize ``(B, T, KV, hd)`` new K/V and write them at positions
    ``[pos, pos + T)`` of the per-layer ``(B, KV, S, hd)`` planes, in
    place. Returns ``cache``."""
    T = k_new.shape[1]
    for plane, splane, x in ((cache.k_codes, cache.k_scale, k_new),
                             (cache.v_codes, cache.v_scale, v_new)):
        codes, scale = quantize_kv(x, fmt)
        plane[:, :, pos:pos + T] = codes.transpose(1, 2)
        splane[:, :, pos:pos + T] = scale.transpose(1, 2)
    return cache
