"""Exact-MGS flash-decode attention over packed FP8 K/V: the B2 kernel
wrapper and its twin.

``mgs_flash_blocks`` is the port of the TPU kernel
``repro.kernels.mgs_attention._flash_kernel`` with ``_flash_pallas``'s
arguments: each ``(T, D)`` query slice ``n`` walks its key chunks through a
block table ``bt[n, j]`` into physical ``(P, chunk, D)`` code pools and
skips every chunk with ``j * chunk >= live[n]``. Per chunk,
:func:`_attn_tile_step` runs the exact limb contraction for the scores,
the online softmax with a pairwise (neighbour-pair) denominator tree, the
per-row absmax re-quantization of ``p * v_scale`` to the cache format,
and the exact limb contraction for the values.

On a CUDA tensor the wrapper launches ``csrc/mgs_attention.cu``; on a CPU
tensor it runs the twin :func:`_flash_plain` (``_attn_tile_step`` in a
loop over chunks). Three entry points share the wrapper: the dense
:func:`mgs_flash_attention` passes an identity table over the contiguous
cache; :func:`mgs_paged_flash_attention` passes each slot's block table
into the shared paged pool; :func:`mgs_paged_verify_attention` batches
the ``T`` candidate tokens (x ``R`` query rows) of a slot into one slice
with per-row score scales and biases, so each chunk's limb decode is
shared by all of them.

Skipping a dead chunk is bitwise equal to walking an inert one: its
probabilities are exactly ``exp(-1e30 - m) = +0.0``, so ``alpha == 1``
and ``l``, ``o`` are unchanged.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.formats import E4M3, FPFormat, encode_bits
from repro_torch.quant.quantize import recip
from . import _cuda
from .mgs_matmul import (_KERNEL_FMTS, _LIMB_BASE, _N_CLASSES, _N_LIMBS,
                         _class_int32, _fixed_point, _limb_split, _limbs64,
                         _round_decompose_e4m3, out_scale)

__all__ = ["mgs_flash_attention", "mgs_paged_flash_attention",
           "mgs_paged_verify_attention", "mgs_flash_blocks",
           "flash_chunk_limit"]

_TINY = 1e-30
_KERNEL_MAX_CHUNK = 512     # csrc/mgs_attention.cu: kMaxChunk
_MAX_PAIR = _N_LIMBS * (1 << (_LIMB_BASE - 1)) ** 2


def flash_chunk_limit() -> int:
    """Largest key chunk whose int32 class sums cannot overflow."""
    return (2**31 - 1) // _MAX_PAIR


def _combine_classes(accs):
    """Exact class sums -> float32, fixed 5-term ascending order."""
    tot = _class_int32(accs[0]).to(torch.float32)
    for c in range(1, _N_CLASSES):
        tot = tot + _class_int32(accs[c]).to(torch.float32) * float(
            2 ** (_LIMB_BASE * c))
    return tot


def _class_dots(lx, lw):
    """Limb-pair contractions ``lx[a] @ lw[b]`` summed per class a+b
    (float64 limbs: exact integer sums)."""
    accs = [None] * _N_CLASSES
    for a in range(_N_LIMBS):
        for b in range(_N_LIMBS):
            d = torch.matmul(lx[a], lw[b])
            c = a + b
            accs[c] = d if accs[c] is None else accs[c] + d
    return accs


def _pairwise_sum_cols(x):
    """Pairwise sum over the last axis, keepdims: ``x[0::2] + x[1::2]``
    at every level of a zero-padded power-of-two tree."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x


def _attn_tile_step(lq, k_codes, v_codes, qk_row, v_row, bias, m, l, o,
                    fmt: FPFormat):
    """One online-softmax chunk update for every slice at once.

    ``lq``: 3 float64 limb planes ``(N, T, D)``; ``k_codes`` /
    ``v_codes``: ``(N, chunk, D)`` uint8; ``qk_row`` / ``v_row`` /
    ``bias``: ``(N, 1 | T, chunk)``; ``m`` / ``l``: ``(N, T, 1)``;
    ``o``: ``(N, T, D)``. Returns the updated ``(m, l, o)``.
    """
    osc = out_scale(fmt)
    lk = _limbs64(k_codes, fmt)
    s = _combine_classes(_class_dots(lq, [t.transpose(-1, -2) for t in lk]))
    s = s * osc
    s = s * qk_row + bias
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + _pairwise_sum_cols(p)
    pv = p * v_row
    sp = torch.clamp_min(pv.abs().amax(dim=-1, keepdim=True),
                         _TINY) * recip(fmt.max_finite)
    sm, e = _round_decompose_e4m3(pv / sp, fmt, gate_subnormal=False)
    lp = [t.to(torch.float64) for t in _limb_split(_fixed_point(sm, e))]
    lv = _limbs64(v_codes, fmt)
    o_chunk = _combine_classes(_class_dots(lp, lv)) * osc * sp
    o_new = o * alpha + o_chunk
    return m_new, l_new, o_new


def _last_live_chunk(live, chunk: int):
    """Index of the last live chunk per slice, clamped to 0."""
    return torch.clamp_min(-(-live // chunk) - 1, 0).to(torch.int64)


def _flash_plain(q_codes, k_pool, v_pool, bt, live, qk_scale, v_scale, bias,
                 fmt: FPFormat):
    """Plain twin of the B2 kernel: ``_attn_tile_step`` over the chunks
    of every slice, dead chunks' updates discarded."""
    N, T, D = q_codes.shape
    nb = bt.shape[1]
    chunk = k_pool.shape[1]
    dev = q_codes.device
    lq = _limbs64(q_codes, fmt)
    live = live.to(torch.int64)
    last = _last_live_chunk(live, chunk)
    m = torch.full((N, T, 1), -float("inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((N, T, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((N, T, D), dtype=torch.float32, device=dev)
    n_walk = min(nb, -(-int(live.max()) // chunk)) if N else 0
    for j in range(n_walk):
        jj = torch.clamp_max(torch.full_like(last, j), last)
        tiles = bt.to(torch.int64).gather(1, jj[:, None])[:, 0]
        cols = slice(j * chunk, (j + 1) * chunk)
        upd = _attn_tile_step(lq, k_pool[tiles], v_pool[tiles],
                              qk_scale[..., cols], v_scale[..., cols],
                              bias[..., cols], m, l, o, fmt)
        keep = (j * chunk < live)[:, None, None]
        m, l, o = (torch.where(keep, u, c) for u, c in zip(upd, (m, l, o)))
    return o / torch.clamp_min(l, _TINY)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _kernel():
    lib = _cuda.load("mgs_attention")
    fn = lib.mgs_flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.mgs_flash_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.mgs_flash_attention_smem.restype = ctypes.c_longlong
    return lib


def mgs_flash_blocks(q_codes, k_pool, v_pool, bt, live, qk_scale, v_scale,
                     bias, fmt: FPFormat = E4M3):
    """All ``(T, D)`` slices through one block-table launch.

    Args:
      q_codes: ``(N, T, D)`` uint8 query codes.
      k_pool / v_pool: ``(P, chunk, D)`` uint8 physical tile pools.
      bt: ``(N, nb)`` int32 tile ids; ``pool[bt[n, j]]`` holds keys
        ``[j * chunk, (j + 1) * chunk)`` of slice ``n``.
      live: ``(N,)`` int32 live key counts; later chunks are skipped.
      qk_scale / v_scale / bias: ``(N, rs, nb * chunk)`` float32 logical
        rows, ``rs`` in ``{1, T}``.

    Returns:
      ``(N, T, D)`` float32. A CPU tensor runs the twin; a CUDA tensor
      launches ``csrc/mgs_attention.cu`` or raises.
    """
    if q_codes.device.type == "cpu":
        return _flash_plain(q_codes, k_pool, v_pool, bt, live, qk_scale,
                            v_scale, bias, fmt)
    dev = q_codes.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pool, v_pool, bt, live, qk_scale, v_scale, bias)):
        raise ValueError("the flash kernel runs on one CUDA device")
    N, T, D = q_codes.shape
    P, chunk, Dp = k_pool.shape
    nb = bt.shape[1]
    rs = qk_scale.shape[1]
    if fmt.name not in _KERNEL_FMTS:
        raise ValueError(f"the flash kernel takes E4M3/E3M4, got {fmt.name}")
    if (Dp != D or v_pool.shape != k_pool.shape or bt.shape != (N, nb)
            or live.shape != (N,) or rs not in (1, T)
            or any(t.shape != (N, rs, nb * chunk)
                   for t in (qk_scale, v_scale, bias))):
        raise ValueError(
            f"shapes q {tuple(q_codes.shape)}, pools {tuple(k_pool.shape)}"
            f"/{tuple(v_pool.shape)}, bt {tuple(bt.shape)}, live "
            f"{tuple(live.shape)}, rows {tuple(qk_scale.shape)}")
    if D % 4 or chunk % 4:
        raise ValueError(f"head dim {D} and chunk {chunk} must be multiples "
                         "of 4 (int8x4 limb words)")
    if chunk > flash_chunk_limit():
        raise ValueError(f"chunk {chunk} exceeds the int32 class-sum bound")
    if q_codes.dtype != torch.uint8 or k_pool.dtype != torch.uint8 or \
            v_pool.dtype != torch.uint8:
        raise TypeError("q / k / v must be uint8 codes")
    lib = _kernel()
    smem = lib.mgs_flash_attention_smem(T, D, chunk)
    if smem < 0:
        raise ValueError(f"chunk {chunk} exceeds the kernel's "
                         f"{_KERNEL_MAX_CHUNK} keys per tile")
    if smem > _cuda.SMEM_LIMIT:
        raise ValueError(f"T={T}, D={D}, chunk={chunk} needs {smem} B of "
                         f"shared memory (> {_cuda.SMEM_LIMIT})")
    args = [q_codes.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
            bt.to(torch.int32).contiguous(), live.to(torch.int32).contiguous(),
            qk_scale.to(torch.float32).contiguous(),
            v_scale.to(torch.float32).contiguous(),
            bias.to(torch.float32).contiguous()]
    if args[1].data_ptr() % 16 or args[2].data_ptr() % 16:
        raise ValueError("the K / V pools must start on a 16-byte boundary "
                         "(a tile is one bulk copy)")
    out = torch.empty((N, T, D), dtype=torch.float32, device=dev)
    if N:
        err = lib.mgs_flash_attention(
            *(a.data_ptr() for a in args), out.data_ptr(), N, T, D, chunk,
            nb, rs, _KERNEL_FMTS[fmt.name], _cuda.stream_ptr(dev))
        _cuda.check(err, "mgs_flash_attention")
        _cuda.count_launch("mgs_flash_attention")
    return out


def _dispatch(q_codes, k_pool, v_pool, bt, live, qk_scale, v_scale, bias,
              fmt: FPFormat, use_kernel: bool):
    if k_pool.shape[1] > flash_chunk_limit():
        raise ValueError(f"chunk {k_pool.shape[1]} exceeds the int32 "
                         f"class-accumulator bound {flash_chunk_limit()}")
    if qk_scale.dim() == 2:
        qk_scale, v_scale, bias = qk_scale[:, None], v_scale[:, None], \
            bias[:, None]
    if qk_scale.shape[1] not in (1, q_codes.shape[1]):
        raise ValueError(f"scale rows {tuple(qk_scale.shape)} for queries "
                         f"{tuple(q_codes.shape)}")
    live = live.to(torch.int32)
    if use_kernel:
        return mgs_flash_blocks(q_codes, k_pool, v_pool, bt, live, qk_scale,
                                v_scale, bias, fmt)
    return _flash_plain(q_codes, k_pool, v_pool, bt, live, qk_scale,
                        v_scale, bias, fmt)


def mgs_flash_attention(q, k_codes, v_codes, qk_scale, v_scale, bias,
                        fmt: FPFormat = E4M3, *, chunk: int = 256,
                        use_kernel: bool = True, lengths=None):
    """Flash-style exact-MGS attention over packed-code keys/values.

    Args:
      q: ``(N, T, D)`` format-exact FP8 query values (the slice's scale
        belongs in ``qk_scale``).
      k_codes / v_codes: ``(N, S, D)`` uint8 packed cache codes.
      qk_scale: ``(N, S)`` float32 per-key score multiplier (query scale x
        entry scale x ``head_dim**-0.5``).
      v_scale: ``(N, S)`` float32 per-key value scale.
      bias: ``(N, S)`` float32 additive mask row.
      chunk: keys per tile. ``S`` is padded to a multiple with inert
        entries (zero codes / scales, ``-1e30`` bias).
      use_kernel: the kernel wrapper (twin on CPU tensors) vs the plain
        path — the same bits either way.
      lengths: optional ``(N,)`` live key counts (masked-chunk early exit).

    Returns:
      ``(N, T, D)`` float32 attention outputs.
    """
    N, T, D = q.shape
    S = k_codes.shape[1]
    if (k_codes.shape != (N, S, D) or v_codes.shape != (N, S, D)
            or any(t.shape != (N, S) for t in (qk_scale, v_scale, bias))):
        raise ValueError(
            f"q {tuple(q.shape)}, k/v {tuple(k_codes.shape)}/"
            f"{tuple(v_codes.shape)}, rows {tuple(qk_scale.shape)}/"
            f"{tuple(v_scale.shape)}/{tuple(bias.shape)}")
    nc = -(-S // chunk)
    Sp = nc * chunk
    pad = Sp - S
    q_codes = encode_bits(q, fmt)
    if pad:
        k_codes = F.pad(k_codes, (0, 0, 0, pad))
        v_codes = F.pad(v_codes, (0, 0, 0, pad))
        qk_scale = F.pad(qk_scale, (0, pad))
        v_scale = F.pad(v_scale, (0, pad))
        bias = F.pad(bias, (0, pad), value=-1e30)
    k_pool = k_codes.reshape(N * nc, chunk, D)
    v_pool = v_codes.reshape(N * nc, chunk, D)
    bt = torch.arange(N * nc, dtype=torch.int32,
                      device=q.device).reshape(N, nc)
    if lengths is None:
        live = torch.full((N,), Sp, dtype=torch.int32, device=q.device)
    elif lengths.shape != (N,):
        raise ValueError(f"lengths {tuple(lengths.shape)} for {N} slices")
    else:
        live = torch.clamp(lengths.to(torch.int32), 0, Sp)
    return _dispatch(q_codes, k_pool, v_pool, bt, live, qk_scale, v_scale,
                     bias, fmt, use_kernel)


def _check_pool(q, k_pool, v_pool, block_table, lengths, want_lengths,
                rows, want_rows):
    P, bs, D = k_pool.shape
    if (q.shape[-1] != D or v_pool.shape != k_pool.shape
            or block_table.shape != (q.shape[0], want_rows[-1] // bs)
            or tuple(lengths.shape) != want_lengths
            or any(tuple(t.shape) != want_rows for t in rows)):
        raise ValueError(
            f"q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
            f"{tuple(v_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)} (want {want_lengths}), rows "
            f"{[tuple(t.shape) for t in rows]} (want {want_rows})")


def mgs_paged_flash_attention(q, k_pool, v_pool, block_table, lengths,
                              qk_scale, v_scale, bias, fmt: FPFormat = E4M3,
                              *, use_kernel: bool = True):
    """Exact-MGS decode attention over a **paged** packed-code pool.

    Args:
      q: ``(N, T, D)`` format-exact FP8 query values.
      k_pool / v_pool: ``(P, bs, D)`` uint8 physical pools; the block size
        ``bs`` is the kernel's chunk.
      block_table: ``(N, nb)`` int physical tile ids; ``pool[bt[n, j]]``
        holds keys ``[j * bs, (j + 1) * bs)`` of slice ``n``. Entries past
        ``ceil(lengths[n] / bs)`` are never read, so free slots may leave
        their rows zeroed (the trash block).
      lengths: ``(N,)`` live key counts (0 = dead slice: an exact-zero row).
      qk_scale / v_scale / bias: ``(N, nb * bs)`` float32 logical rows.

    Returns:
      ``(N, T, D)`` float32, bitwise equal to the dense entry over the
      gathered cache with the same ``lengths``.
    """
    N, T, D = q.shape
    S = block_table.shape[1] * k_pool.shape[1]
    _check_pool(q, k_pool, v_pool, block_table, lengths, (N,),
                (qk_scale, v_scale, bias), (N, S))
    live = torch.clamp(lengths.to(torch.int32), 0, S)
    return _dispatch(encode_bits(q, fmt), k_pool, v_pool,
                     block_table.to(torch.int32), live, qk_scale, v_scale,
                     bias, fmt, use_kernel)


def mgs_paged_verify_attention(q, k_pool, v_pool, block_table, lengths,
                               qk_scale, v_scale, bias,
                               fmt: FPFormat = E4M3, *,
                               use_kernel: bool = True):
    """Multi-query verify attention over the paged pool.

    All ``T * R`` query rows of a slice (``T`` candidate tokens x their
    GQA group of ``R`` rows) form one kernel slice that walks the slot's
    blocks once; score scale and mask bias stay per row (``rs = T * R``).
    Rows are independent in the tile step, and every key past a token's
    horizon carries the ``-1e30`` bias, so token ``t``'s row is bitwise
    equal to a sequential decode step at its position.

    Args:
      q: ``(N, T, R, D)`` format-exact FP8 query values.
      k_pool / v_pool / block_table: as :func:`mgs_paged_flash_attention`.
      lengths: ``(N, T)`` per-token live key counts (0 for dead slots);
        the slice walks to the largest.
      qk_scale / v_scale / bias: ``(N, T, nb * bs)`` float32 rows.

    Returns:
      ``(N, T, R, D)`` float32.
    """
    N, T, R, D = q.shape
    S = block_table.shape[1] * k_pool.shape[1]
    _check_pool(q, k_pool, v_pool, block_table, lengths, (N, T),
                (qk_scale, v_scale, bias), (N, T, S))
    q_codes = encode_bits(q, fmt).reshape(N, T * R, D)
    qk, vs, bias_r = (t if R == 1 else torch.repeat_interleave(t, R, dim=1)
                      for t in (qk_scale, v_scale, bias))
    live = torch.clamp(lengths.to(torch.int32), 0, S).amax(dim=1)
    out = _dispatch(q_codes, k_pool, v_pool, block_table.to(torch.int32),
                    live, qk, vs, bias_r, fmt, use_kernel)
    return out.reshape(N, T, R, D)
