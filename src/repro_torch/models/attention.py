"""Self- and cross-attention (MHA/GQA/MQA, causal / sliding window /
bidirectional) with decode KV caches — float (:class:`KVCache`), packed
FP8 (:class:`repro_torch.quant.QuantizedKVCache`) or the paged pool
(:class:`repro_torch.quant.PagedKVCache`), the last two decoded by the B2
flash kernel.

The port's copy of ``repro.models.attention``: dense scores
(``_sdpa_dense``), the online-softmax chunked prefill
(``_sdpa_chunked``), the packed-cache decode (``_sdpa_packed_cache``,
also the packed cross-attention of an encoder-decoder's decode) and the
paged decode and speculative verify (``_sdpa_paged_cache``,
``_sdpa_paged_verify``). Under an fp8
config the score and value contractions of prefill route through
``qeinsum`` (B1 or B3, batched over (batch, kv-head) slices). Caches are
written in place. Every contraction carries the reference's calibration
site (``attn.wq`` ... ``attn.wo``, ``attn.scores``, ``attn.values``); the
decode query's absmax is observed at ``attn.q`` and, under
``quant.static_q_scale``, replaced by the calibrated amax.

On a mesh of ranks (tensor parallelism): where ``wq`` and ``wk`` / ``wv``
shard their heads over the same axes (the kv heads divide the model
axis), each rank projects and attends its own heads, whole kv groups, with
the cache (or the paged pool) holding those heads; the attention output is
all-gathered over the heads before the replicated ``wo``. Otherwise every
rank attends every head over a whole cache or pool. A cache whose sequence is sharded (``kv_seq``, :class:`KVSeqShard`)
takes each position's entries on the rank holding it, and decode
all-gathers the shards before the flash kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.prepared import LaidOutWeight
from repro_torch.kernels.mgs_attention import (mgs_flash_attention,
                                               mgs_paged_flash_attention,
                                               mgs_paged_verify_attention)
from repro_torch.quant import (PagedKVCache, QuantizedKVCache, append_kv,
                               paged_append_kv, qeinsum)
from repro_torch.quant.calibrate import (current_calib_state, observe,
                                         observe_amax)
from repro_torch.quant.quantize import (QTensor, quantize_fp8,
                                        quantize_fp8_static)
from .common import apply_rope, pairwise_sum_last, softmax_last
from .linear import proj

__all__ = ["attention_apply", "KVCache"]

_NEG_INF = -1e30
_POS_SENTINEL = 2**30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor  # (B, S_max, KV, hd)


class KVSeqShard(NamedTuple):
    """A serving cache whose sequence axis is cut over mesh ``axes``: this
    rank holds positions ``[start, start + length)``."""
    mesh: object
    axes: tuple
    start: int
    length: int


def _heads_axes(p) -> tuple:
    """The mesh axes this rank's heads are cut over: those of ``wq``'s
    output when ``wk`` and ``wv`` cut theirs alike, else ``()`` (every
    rank takes every head)."""
    lays = [w.layout if isinstance(w, LaidOutWeight) else None
            for w in (p["wq"], p.get("wk"), p.get("wv"))]
    if any(l is None for l in lays):
        return ()
    axes = lays[0].n_axes
    return axes if all(l.n_axes == axes for l in lays[1:]) else ()


def _local_window(seq: KVSeqShard, pos: int, T: int):
    """The positions of ``[pos, pos + T)`` this rank holds, as (first,
    last + 1) clipped to its range (empty: first >= last + 1)."""
    return max(pos, seq.start), min(pos + T, seq.start + seq.length)


def _gather_seq(t: torch.Tensor, dim: int, seq):
    return t if seq is None else seq.mesh.all_gather(t, dim, seq.axes)


def _mask(q_pos, k_pos, *, causal: bool, window: int, is_global):
    """(..., Tq, Tk) additive float32 mask from position vectors."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window > 0 and not is_global:
        ok = ok & (dq - dk < window)
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG_INF))


def _pad_heads(t, dim: int, n: int):
    """``t`` with zero kv heads appended along ``dim`` up to ``n``."""
    pad = n - t.shape[dim]
    if pad <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim)


def _sdpa_dense(q, k, v, bias, quant=None, kv_heads=None):
    """q: (B,T,KV,G,hd)  k/v: (B,S,KV,hd)  bias: (B,1,1,T,S).

    ``kv_heads``: the model's kv heads, where ``q`` holds a rank's share of
    them. A decode step (T = 1) of the float path then contracts at the
    model's head count, the other heads zero, and keeps the rank's: on the
    card the two contractions are batched GEMVs whose algorithm follows
    the batch count (heads x batch), so a rank's share alone would not get
    the one-device bits."""
    scale = q.shape[-1] ** -0.5
    if quant is None or not quant.is_fp8:
        KV = q.shape[2]
        n = kv_heads if (kv_heads and q.shape[1] == 1) else KV
        scores = torch.einsum(
            "btkgh,bskh->bkgts", _pad_heads(q.to(torch.float32), 2, n),
            _pad_heads(k.to(torch.float32), 2, n)) * scale
        scores = scores[:, :KV] + bias
        w = softmax_last(scores).to(q.dtype)
        out = torch.einsum("bkgts,bskh->btkgh", _pad_heads(w, 1, n),
                           _pad_heads(v, 2, n))
        return out[:, :, :KV]
    scores = qeinsum("btkgh,bskh->bkgts", q, k, quant, site="attn.scores",
                     out_dtype=torch.float32) * scale
    scores = scores + bias
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    w = (e / pairwise_sum_last(e)[..., None]).to(q.dtype)
    return qeinsum("bkgts,bskh->btkgh", w, v, quant, site="attn.values",
                   out_dtype=q.dtype)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, window, is_global,
                  chunk: int, quant=None):
    """Online-softmax attention over KV chunks (chunk-aligned ``S``)."""
    B, T, KV, G, hd = q.shape
    S = k.shape[1]
    if S % chunk:
        raise ValueError(
            f"chunked attention needs a chunk-aligned key length: "
            f"S={S} % attn_chunk={chunk} != 0")
    scale = hd ** -0.5
    dq = q_pos[..., :, None]
    hi = dq if causal else torch.full_like(dq, _POS_SENTINEL - 1)
    if window > 0 and not is_global:
        lo = dq - window + 1
    else:
        lo = torch.full_like(dq, -_POS_SENTINEL)
    fp8 = quant is not None and quant.is_fp8
    m = torch.full((B, KV, G, T), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, T), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, KV, G, T, hd), dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pb = k_pos[:, c0:c0 + chunk]
        if fp8:
            s = qeinsum("btkgh,bskh->bkgts", q, kb, quant,
                        site="attn.scores", out_dtype=torch.float32) * scale
        else:
            s = torch.einsum("btkgh,bskh->bkgts", q.to(torch.float32),
                             kb.to(torch.float32)) * scale
        dk = pb[:, None, :]
        ok = (dk <= hi) & (dk >= lo)
        s = s + torch.where(ok, zero, torch.full_like(zero, _NEG_INF)
                            )[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + pairwise_sum_last(p)
        if fp8:
            pv = qeinsum("bkgts,bskh->bkgth", p.to(q.dtype), vb, quant,
                         site="attn.values", out_dtype=torch.float32)
        else:
            pv = torch.einsum("bkgts,bskh->bkgth", p.to(q.dtype),
                              vb).to(torch.float32)
        o = o * alpha[..., None] + pv
        m, l = m_new, l_new
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _pad_kv_to_chunk(k, v, k_pos, chunk: int):
    """Pad keys/values to a chunk multiple with masked sentinel positions."""
    pad = -k.shape[1] % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_POS_SENTINEL)
    return k, v, k_pos


#: calibration site of the decode-query quantization; the table carries
#: its absmax as ``"attn.q.amax"``
_Q_SITE = "attn.q"


def _quantize_decode_q(q2, quant, batch: int = 1) -> QTensor:
    """Per-row decode-query quantization: dynamic absmax or calibrated.

    ``q2``: ``(N, K)`` query rows, one per kernel slice. Dynamic is
    ``quantize_fp8(axis=1)``. Under ``quant.static_q_scale`` the absmax
    comes from the applied runtime state's ``q_amax`` (a scalar, or one
    entry per slot repeated over the slot's ``N // batch`` rows), else from
    the config's ``"attn.q.amax"`` entry, else the dynamic path. A state
    entry ``<= 0`` takes the dynamic reduce for its rows, bit-identically;
    when the state's host-known minimum is positive no reduce runs.
    """
    fmt = quant.kv_fmt
    observe_amax(_Q_SITE, q2)
    if quant.static_q_scale:
        cs = current_calib_state()
        if cs is not None and "q_amax" in cs:
            if cs["q_amax_max"] <= 0.0:
                return quantize_fp8(q2, fmt, axis=1)
            a = cs["q_amax"]
            if a.dim():
                a = _slot_rows(cs, q2.shape[0] // batch)
            return quantize_fp8_static(q2, fmt, a,
                                       dynamic_rows=cs["q_amax_min"] <= 0.0)
        amax = quant.act_sigma(_Q_SITE + ".amax")
        if amax is not None and amax > 0.0:
            return quantize_fp8_static(q2, fmt, amax)
    return quantize_fp8(q2, fmt, axis=1)


def _slot_rows(cs, reps: int):
    """The state's per-slot amax repeated over each slot's ``reps`` rows
    (``repeat_interleave``: element by element), kept in the state's
    ``q_amax_rows`` cache so every layer of a step reuses one copy."""
    cache = cs.get("q_amax_rows")
    rows = None if cache is None else cache.get(reps)
    if rows is None:
        rows = torch.repeat_interleave(cs["q_amax"], reps).reshape(-1, 1)
        if cache is not None:
            cache[reps] = rows
    return rows


def _observe_scores(qvals, quant):
    """The decode paths' score-contraction statistics (the query codes)."""
    if quant.accum in ("mgs_exact", "mgs_dmac"):
        observe("attn.scores", qvals, quant.kv_fmt)


def _sdpa_packed_cache(q, cache: QuantizedKVCache, bias, quant,
                       lengths=None):
    """Decode attention over the packed cache: the MGS flash kernel.

    q: (B, T=1, KV, G, hd); cache planes (B, KV, S, hd) codes + (B, KV, S)
    scales; bias: (B, 1, S). The query is quantized once per (batch,
    kv-head) slice and its scale folds with the entry scales and
    ``head_dim**-0.5`` into the per-key score multiplier.
    """
    B, T, KV, G, hd = q.shape
    S = cache.k_codes.shape[2]
    fmt = quant.kv_fmt
    q2 = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * T * hd)
    qt = _quantize_decode_q(q2, quant, batch=B)
    qvals = qt.q.reshape(B * KV, G * T, hd)
    _observe_scores(qvals, quant)
    ks = cache.k_scale.reshape(B * KV, S)
    vs = cache.v_scale.reshape(B * KV, S)
    qk = (qt.scale * ks) * (hd ** -0.5)
    kc = cache.k_codes.reshape(B * KV, S, hd)
    vc = cache.v_codes.reshape(B * KV, S, hd)
    bias2 = bias.reshape(B, 1, S).expand(B, KV, S).reshape(B * KV, S)
    live = (None if lengths is None
            else torch.repeat_interleave(lengths.to(torch.int32), KV))
    out = mgs_flash_attention(qvals, kc, vc, qk, vs, bias2, fmt,
                              chunk=quant.block_k,
                              use_kernel=quant.use_kernel, lengths=live)
    return out.reshape(B, KV, G, T, hd).permute(0, 3, 1, 2, 4).to(q.dtype)


def _paged_rows(cache: PagedKVCache, bt, B: int):
    """The per-entry scale rows of every slot in logical ``(B * KV, S)``
    order, and the ``(B * KV, nb)`` table into the ``(P * KV, bs, hd)``
    pool view (slot b / head h / chunk j is tile ``bt[b, j] * KV + h``)."""
    P, KV, bs = cache.k_scale.shape
    nb = bt.shape[1]
    S = nb * bs

    def rows(plane):
        g = plane[bt.reshape(-1)].reshape(B, nb, KV, bs)
        return g.transpose(1, 2).reshape(B * KV, S)

    bt_nk = (bt[:, None, :] * KV + torch.arange(
        KV, device=bt.device)[None, :, None]).reshape(B * KV, nb)
    return rows(cache.k_scale), rows(cache.v_scale), bt_nk


def _pools(cache: PagedKVCache):
    P, KV, bs, hd = cache.k_codes.shape
    return (cache.k_codes.reshape(P * KV, bs, hd),
            cache.v_codes.reshape(P * KV, bs, hd))


def _sdpa_paged_cache(q, cache: PagedKVCache, block_table, bias, lengths,
                      quant):
    """Decode attention over the paged pool: the block-table B2 kernel.

    q: (B, 1, KV, G, hd); bias: (B, 1, S); ``lengths``: (B,) live key
    counts (0 = free slot, an exact-zero row). Codes never move; only the
    per-entry scale rows are gathered into logical order, where they fold
    with the query scale and ``head_dim**-0.5`` into the score multiplier.
    """
    B, T, KV, G, hd = q.shape
    fmt = quant.kv_fmt
    q2 = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * T * hd)
    qt = _quantize_decode_q(q2, quant, batch=B)
    qvals = qt.q.reshape(B * KV, G * T, hd)
    _observe_scores(qvals, quant)
    bt = block_table.to(torch.int64)
    ks, vs, bt_nk = _paged_rows(cache, bt, B)
    S = ks.shape[1]
    qk = (qt.scale * ks) * (hd ** -0.5)
    kp, vp = _pools(cache)
    live = torch.repeat_interleave(lengths.to(torch.int32), KV)
    bias2 = bias.reshape(B, 1, S).expand(B, KV, S).reshape(B * KV, S)
    out = mgs_paged_flash_attention(qvals, kp, vp, bt_nk, live, qk, vs,
                                    bias2, fmt, use_kernel=quant.use_kernel)
    return out.reshape(B, KV, G, T, hd).permute(0, 3, 1, 2, 4).to(q.dtype)


def _sdpa_paged_verify(q, cache: PagedKVCache, block_table, bias,
                       positions, lengths, quant):
    """Multi-query (T > 1) verify attention over the paged pool.

    Every (slot, kv-head) pair is one kernel slice of ``T`` tokens. The
    query is quantized per ``(G * hd)`` token row — the granularity of
    the sequential ``T == 1`` step — and token ``t`` attends up to its
    own position, so its row is bitwise the sequential step's at
    ``pos + t``. ``positions``: (B, T); ``lengths`` 0 marks a dead slot.
    """
    B, T, KV, G, hd = q.shape
    fmt = quant.kv_fmt
    q2 = q.permute(0, 2, 1, 3, 4).reshape(B * KV * T, G * hd)
    qt = _quantize_decode_q(q2, quant, batch=B)
    qvals = qt.q.reshape(B * KV, T, G, hd)
    _observe_scores(qvals, quant)
    bt = block_table.to(torch.int64)
    ks, vs, bt_nk = _paged_rows(cache, bt, B)
    S = ks.shape[1]
    qk = qt.scale.reshape(B * KV, T, 1) * ks[:, None, :] * (hd ** -0.5)
    vs3 = vs[:, None, :].expand(B * KV, T, S)
    kp, vp = _pools(cache)
    live_t = torch.where(lengths[:, None] > 0, positions + 1,
                         torch.zeros_like(positions))
    live = torch.repeat_interleave(live_t.to(torch.int32), KV, dim=0)
    bias3 = bias.reshape(B, 1, T, S).expand(B, KV, T, S).reshape(
        B * KV, T, S)
    out = mgs_paged_verify_attention(qvals, kp, vp, bt_nk, live, qk, vs3,
                                     bias3, fmt, use_kernel=quant.use_kernel)
    return out.reshape(B, KV, T, G, hd).permute(0, 2, 1, 3, 4).to(q.dtype)


def _live_positions(positions, S: int):
    """Key positions ``0..S-1`` of a decode cache, those past the query's
    last position set to the sentinel."""
    B = positions.shape[0]
    k_pos = torch.arange(S, device=positions.device)[None].expand(B, S)
    return torch.where(k_pos <= positions[:, -1:], k_pos,
                       torch.full_like(k_pos, _POS_SENTINEL))


def _decode_bias(positions, S: int, causal: bool, cfg: ModelConfig,
                 is_global):
    """The (B, T, S) mask of a decode or verify step over an S-key cache."""
    return _mask(positions, _live_positions(positions, S), causal=causal,
                 window=cfg.window, is_global=is_global)


def attention_apply(p, x, cfg: ModelConfig, *, positions, is_global=True,
                    causal: bool = True, cache=None, cache_pos=0,
                    block_table=None, lengths=None, cross_kv=None,
                    kv_seq=None):
    """Self- or cross-attention. x: (B, T, d); positions: (B, T) int.

    ``cache``: a float :class:`KVCache`, a packed
    :class:`QuantizedKVCache` or a paged :class:`PagedKVCache` (one
    layer's planes), written in place at ``cache_pos``. With the packed
    cache the decode step (T == 1) attends the codes through the flash
    kernel; prefill (T > 1, ``cache_pos`` 0) attends the fresh float K/V
    and only stores them quantized. With the paged pool ``cache_pos`` is
    a per-slot ``(B,)`` position, ``block_table`` ``(B, nb)`` names each
    slot's blocks and ``lengths`` ``(B,)`` its live key count (0 = free
    slot); ``T == 1`` decodes, ``T > 1`` is the speculative verify.

    ``cross_kv``: the encoder's K/V (encoder-decoder), not roped, in place
    of the self-attention K/V; attended without a causal mask. Packed
    (:class:`QuantizedKVCache`, decode only) through the flash kernel over
    the first ``cfg.encoder_len`` keys, the padded tail masked; float
    (:class:`KVCache`) by the dense or chunked path.
    ``kv_seq``: the :class:`KVSeqShard` of a sequence-sharded group cache.
    Returns (out (B, T, d), cache | None).
    """
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    heads_axes = () if cross_kv is not None else _heads_axes(p)
    local = bool(heads_axes)

    q = proj(x, p["wq"], cfg.quant, site="attn.wq", gather=not local)
    H_l = q.shape[-2]
    KV = H_l // G
    q = apply_rope(q, positions, cfg.rope_theta).reshape(B, T, KV, G, hd)

    packed_out = None
    if isinstance(cross_kv, QuantizedKVCache):
        if T != 1:
            raise NotImplementedError(
                "packed cross-attention is decode-only (T == 1): the "
                "decoder prefill attends the fresh float encoder K/V")
        S = cross_kv.k_codes.shape[2]
        k_pos = torch.arange(S, device=x.device)[None].expand(B, S)
        k_pos = torch.where(k_pos < cfg.encoder_len, k_pos,
                            torch.full_like(k_pos, _POS_SENTINEL))
        bias3 = _mask(positions, k_pos, causal=False, window=cfg.window,
                      is_global=is_global)
        packed_out = _sdpa_packed_cache(
            q, cross_kv, bias3, cfg.quant,
            lengths=torch.full((B,), cfg.encoder_len, dtype=torch.int32,
                               device=x.device))
    elif cross_kv is not None:
        k, v = cross_kv.k, cross_kv.v
        S = k.shape[1]
        k_pos = torch.arange(S, device=x.device)[None].expand(B, S)
        causal = False
    else:
        k = proj(x, p["wk"], cfg.quant, site="attn.wk", gather=not local)
        k = apply_rope(k, positions, cfg.rope_theta)
        v = proj(x, p["wv"], cfg.quant, site="attn.wv", gather=not local)
        if isinstance(cache, PagedKVCache):
            paged_append_kv(cache, k, v, cache_pos, block_table,
                            cfg.quant.kv_fmt)
            S = block_table.shape[1] * cache.k_codes.shape[2]
            bias3 = _decode_bias(positions, S, causal, cfg, is_global)
            if T == 1:
                packed_out = _sdpa_paged_cache(q, cache, block_table, bias3,
                                               lengths, cfg.quant)
            else:
                packed_out = _sdpa_paged_verify(q, cache, block_table, bias3,
                                                positions, lengths, cfg.quant)
        elif isinstance(cache, QuantizedKVCache):
            if kv_seq is None:
                append_kv(cache, k, v, cache_pos, cfg.quant.kv_fmt)
            else:
                a, b = _local_window(kv_seq, cache_pos, T)
                if a < b:
                    append_kv(cache, k[:, a - cache_pos:b - cache_pos],
                              v[:, a - cache_pos:b - cache_pos],
                              a - kv_seq.start, cfg.quant.kv_fmt)
            if T == 1:
                full = QuantizedKVCache(
                    *(_gather_seq(t, 2, kv_seq) for t in cache))
                bias3 = _decode_bias(positions, full.k_codes.shape[2],
                                     causal, cfg, is_global)
                packed_out = _sdpa_packed_cache(q, full, bias3, cfg.quant,
                                                lengths=positions[:, -1] + 1)
            else:
                if cache_pos != 0:
                    raise NotImplementedError(
                        "packed-cache prefill (T > 1) supports cache_pos "
                        "== 0 only")
                k_pos = positions
        elif cache is not None:
            a, b = ((cache_pos, cache_pos + T) if kv_seq is None
                    else _local_window(kv_seq, cache_pos, T))
            o = 0 if kv_seq is None else kv_seq.start
            if a < b:
                cache.k[:, a - o:b - o] = k[:, a - cache_pos:b - cache_pos
                                            ].to(cache.k.dtype)
                cache.v[:, a - o:b - o] = v[:, a - cache_pos:b - cache_pos
                                            ].to(cache.v.dtype)
            k = _gather_seq(cache.k, 1, kv_seq)
            v = _gather_seq(cache.v, 1, kv_seq)
            k_pos = _live_positions(positions, k.shape[1])
        else:
            k_pos = positions

    if packed_out is not None:
        out = packed_out
    elif cfg.attn_chunk and T > 1:
        kp, vp, k_pos_p = _pad_kv_to_chunk(k.to(q.dtype), v.to(q.dtype),
                                           k_pos, cfg.attn_chunk)
        out = _sdpa_chunked(q, kp, vp, positions, k_pos_p, causal=causal,
                            window=cfg.window, is_global=is_global,
                            chunk=cfg.attn_chunk, quant=cfg.quant)
    else:
        bias = _mask(positions, k_pos, causal=causal, window=cfg.window,
                     is_global=is_global)[:, None, None]
        out = _sdpa_dense(q, k.to(q.dtype), v.to(q.dtype), bias,
                          quant=cfg.quant, kv_heads=cfg.n_kv_heads)

    out = out.reshape(B, T, H_l, hd)
    if local:
        out = p["wq"].layout.mesh.all_gather(out, 2, heads_axes)
    y = qeinsum("bthd,hdo->bto", out, p["wo"], cfg.quant, site="attn.wo")
    return y, cache
