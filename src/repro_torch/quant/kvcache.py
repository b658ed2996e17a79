"""Packed-FP8 quantized KV cache for decode serving: the dense layout and
the paged block pool of continuous batching.

K and V are stored as packed FP8 codes, 1 byte per element, plus one
float32 scale per cached (position, head) entry::

    k[b, s, h, :] == decode_bits(k_codes[b, h, s, :]) * k_scale[b, h, s]

The per-entry scale makes the cache append-only: :func:`append_kv`
quantizes exactly the new positions, and old codes and scales never
change. The kv-head axis sits before the sequence axis, so the decode
kernel's ``(B * KV, S, hd)`` view is a reshape.

The paged layout (:class:`PagedKVCache`) chops the sequence axis into
blocks of a shared physical pool; each slot names its blocks in a block
table, and :class:`BlockAllocator` hands blocks out FIFO, never block
:data:`TRASH_BLOCK`.

Unlike the reference (pure functions on immutable arrays), the writers
(:func:`append_kv`, :func:`paged_append_kv`, :func:`paged_rollback_kv`)
update the planes in place and return the same cache: the cache is the
largest serving buffer, and copying it per step would double its traffic.
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.formats import E4M3, FPFormat, encode_bits, \
    round_to_format
from .quantize import TINY, recip

__all__ = ["QuantizedKVCache", "quantize_kv", "append_kv",
           "init_quantized_kv", "TRASH_BLOCK", "PagedKVCache",
           "BlockAllocator", "init_paged_kv", "paged_append_kv",
           "paged_rollback_kv", "gather_paged_kv", "kv_cache_bytes"]

#: Physical block reserved as the write target of free slots: their zeroed
#: table rows scatter dead appends here. Its content is scratch — nothing
#: reads it (the flash kernel gates every chunk of a ``live == 0`` slice
#: off) and :class:`BlockAllocator` never hands it out.
TRASH_BLOCK = 0


class QuantizedKVCache(NamedTuple):
    """Packed-code KV planes (one attention layer's view, or a stack)."""

    k_codes: torch.Tensor   # (..., KV, S, hd) uint8
    v_codes: torch.Tensor   # (..., KV, S, hd) uint8
    k_scale: torch.Tensor   # (..., KV, S) float32
    v_scale: torch.Tensor   # (..., KV, S) float32


def quantize_kv(x: torch.Tensor, fmt: FPFormat = E4M3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., hd)`` K or V vectors -> ``(codes, scale)``: uint8 codes and
    one float32 scale per vector (absmax over ``hd`` / max finite).

    A subnormal scale (an all-zero vector: ``TINY / max_finite``) is
    flushed to zero, as XLA:CPU flushes it in the reference; the codes are
    then those of ``0 / 0`` (NaN's code), scaled by zero to an exact zero
    contribution."""
    x = x.to(torch.float32)
    amax = torch.clamp_min(x.abs().amax(dim=-1), TINY)
    scale = amax * recip(fmt.max_finite)
    scale = torch.where(scale < TINY, torch.zeros_like(scale), scale)
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


class PagedKVCache(NamedTuple):
    """Packed-code KV planes chopped into a physical block pool.

    A slot's logical cache is whatever blocks its table row names, so
    admitting or releasing a request moves table entries, never cache
    bytes. The block size is the flash kernel's chunk
    (``QuantConfig.block_k``) and the head axis precedes the in-block
    position, so the kernel's ``(P * KV, bs, hd)`` pool view is a reshape.
    """

    k_codes: torch.Tensor   # (..., P, KV, bs, hd) uint8
    v_codes: torch.Tensor   # (..., P, KV, bs, hd) uint8
    k_scale: torch.Tensor   # (..., P, KV, bs) float32
    v_scale: torch.Tensor   # (..., P, KV, bs) float32


class BlockAllocator:
    """Deterministic host-side FIFO pool allocator.

    FIFO reuse makes the assignment a pure function of the
    admission/release sequence. Block :data:`TRASH_BLOCK` is reserved
    and never handed out.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is the trash block), "
                             f"got {n_blocks}")
        self._free: deque = deque(range(1, n_blocks))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (raises ``RuntimeError`` when exhausted)."""
        if n > len(self._free):
            raise RuntimeError(f"paged KV pool exhausted: want {n} blocks, "
                               f"{len(self._free)} free")
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: Sequence[int]) -> None:
        """Return blocks to the pool (they keep stale codes until the
        next owner's adoption overwrites them)."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("block 0 is the reserved trash block")
            self._free.append(b)


def init_paged_kv(lead, n_blocks: int, n_heads: int, block_size: int,
                  head_dim: int, *, device=None) -> PagedKVCache:
    """An all-zero pool ``(*lead, n_blocks, n_heads, block_size,
    head_dim)`` (scales without ``head_dim``); zero codes and scales keep
    unwritten entries exactly inert."""
    full = tuple(lead) + (n_blocks, n_heads, block_size, head_dim)
    srow = tuple(lead) + (n_blocks, n_heads, block_size)
    return PagedKVCache(
        k_codes=torch.zeros(full, dtype=torch.uint8, device=device),
        v_codes=torch.zeros(full, dtype=torch.uint8, device=device),
        k_scale=torch.zeros(srow, dtype=torch.float32, device=device),
        v_scale=torch.zeros(srow, dtype=torch.float32, device=device))


def _table_rows(block_table, pos_t, bs: int):
    """Physical block and in-block offset of logical positions ``pos_t``
    ``(B, T)``; the table index is clipped to the table width."""
    nb = block_table.shape[1]
    blk = torch.clamp(pos_t // bs, 0, nb - 1)
    phys = block_table.to(torch.int64).gather(1, blk)
    return phys, pos_t % bs


def paged_append_kv(cache: PagedKVCache, k_new, v_new, pos, block_table,
                    fmt: FPFormat = E4M3) -> PagedKVCache:
    """Quantize ``(B, T, KV, hd)`` new K/V (per-entry scales) and write
    token ``t`` of slot ``b`` at logical position ``pos[b] + t`` through
    its table row, in place on the per-layer ``(P, KV, bs, hd)`` pool.

    Every other (block, offset) row stays bit-frozen. A free slot's
    ``pos = 0`` and zeroed row land in :data:`TRASH_BLOCK`. Per-entry
    quantization makes rewriting a position with the same K/V idempotent.
    Returns ``cache``.
    """
    bs = cache.k_codes.shape[-2]
    B, T, KV, hd = k_new.shape
    pos_t = (pos.to(torch.int64)[:, None]
             + torch.arange(T, device=k_new.device)[None, :])
    phys, off = _table_rows(block_table, pos_t, bs)
    phys, off = phys.reshape(-1), off.reshape(-1)
    for plane, splane, x in ((cache.k_codes, cache.k_scale, k_new),
                             (cache.v_codes, cache.v_scale, v_new)):
        codes, scale = quantize_kv(x, fmt)
        plane[phys, :, off, :] = codes.reshape(B * T, KV, hd)
        splane[phys, :, off] = scale.reshape(B * T, KV)
    return cache


def paged_rollback_kv(cache: PagedKVCache, block_table, start, count,
                      max_count: int) -> PagedKVCache:
    """Physically zero logical positions ``[start, start + count)`` of
    each slot — codes and scales back to the never-written state — in
    place on a stacked or per-layer pool. ``count`` 0 leaves a slot
    alone; :data:`TRASH_BLOCK` is never zeroed. Returns ``cache``."""
    bs = cache.k_codes.shape[-2]
    P = cache.k_codes.shape[-4]
    dev = cache.k_codes.device
    ar = torch.arange(max_count, device=dev)[None, :]
    pos_t = start.to(torch.int64)[:, None] + ar
    phys, off = _table_rows(block_table, pos_t, bs)
    phys = torch.where(ar < count.to(torch.int64)[:, None], phys,
                       TRASH_BLOCK)
    hit = torch.zeros((P, bs), dtype=torch.bool, device=dev)
    hit[phys.reshape(-1), off.reshape(-1)] = True
    hit[TRASH_BLOCK] = False
    for plane in (cache.k_codes, cache.v_codes):
        plane.masked_fill_(hit[:, None, :, None], 0)
    for plane in (cache.k_scale, cache.v_scale):
        plane.masked_fill_(hit[:, None, :], 0.0)
    return cache


def gather_paged_kv(cache: PagedKVCache, block_table) -> QuantizedKVCache:
    """Dense per-slot planes ``(B, KV, nb * bs, hd)`` gathered through the
    table (tests; the hot path reads the pool in place)."""
    bt = block_table.to(torch.int64)
    B, nb = bt.shape
    KV, bs, hd = cache.k_codes.shape[1:]

    def dense(plane):
        g = plane[bt.reshape(-1)]
        g = g.reshape((B, nb) + tuple(plane.shape[1:])).transpose(1, 2)
        return g.reshape((B, KV, nb * bs) + tuple(plane.shape[3:]))

    return QuantizedKVCache(dense(cache.k_codes), dense(cache.v_codes),
                            dense(cache.k_scale), dense(cache.v_scale))


def kv_cache_bytes(batch: int, seq: int, kv_heads: int, head_dim: int, *,
                   quantized: bool, float_itemsize: int = 2) -> int:
    """Analytic device bytes of one layer's K+V cache: 1 byte a code plus a
    4-byte scale per (position, head) when ``quantized``, else
    ``float_itemsize`` bytes an element."""
    elems = batch * seq * kv_heads * head_dim
    if quantized:
        return 2 * (elems + 4 * batch * seq * kv_heads)
    return 2 * elems * float_itemsize
