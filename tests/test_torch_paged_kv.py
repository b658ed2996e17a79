"""Port parity for the paged KV pool and the paged / verify entries of the
B2 wrapper (``repro_torch.quant.kvcache``, ``kernels.mgs_attention``).

The properties of ``tests/test_paged_kv.py``, run on the port (bitwise
inside the port): the allocator's round trip, FIFO order, exhaustion and
trash block; the append bit-freeze and multi-token append; paged vs dense
dequantization; the paged entry vs the dense entry over the gathered
cache; early exit == full walk; immunity to trash and stale blocks;
rollback, other slots preserved; verify per token == sequential.

Against the reference on identical numpy inputs: codes and scales of
``paged_append_kv`` / ``paged_rollback_kv`` / ``gather_paged_kv`` are
bitwise equal; the attention entries agree within the tolerance of
``tests/test_torch_attention.py`` (``exp`` rounds differently in the last
ulp between XLA:CPU and PyTorch, and XLA:CPU contracts multiply-adds:
rtol 2e-3, atol 2e-4 at an output scale of ~0.2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels import mgs_attention as ra  # noqa: E402
from repro.quant import kvcache as rk  # noqa: E402

from repro_torch.core.formats import E4M3, decode_bits  # noqa: E402
from repro_torch.kernels import mgs_attention as ta  # noqa: E402
from repro_torch.quant import kvcache as tk  # noqa: E402
from repro_torch.quant.quantize import quantize_fp8  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_KV, _HD, _BS = 2, 8, 4
_FIELDS = ("k_codes", "v_codes", "k_scale", "v_scale")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_pool(pool):
    return [getattr(pool, f).numpy().copy() for f in _FIELDS]


def _dequant(codes, scale):
    return decode_bits(codes, E4M3) * scale[..., None]


# ---------------------------------------------------------------------------
# BlockAllocator
# ---------------------------------------------------------------------------


def test_allocator_roundtrip_restores_pool():
    rng = np.random.default_rng(11)
    for _ in range(20):
        n_blocks = int(rng.integers(3, 40))
        alloc = tk.BlockAllocator(n_blocks)
        assert alloc.n_free == n_blocks - 1
        held = []
        for _ in range(30):
            if held and rng.random() < 0.4:
                alloc.free(held.pop(rng.integers(0, len(held))))
                continue
            want = int(rng.integers(1, 4))
            if want > alloc.n_free:
                continue
            got = alloc.alloc(want)
            assert tk.TRASH_BLOCK not in got
            assert not set(got) & {b for bl in held for b in bl}
            held.append(got)
        for blocks in held:
            alloc.free(blocks)
        assert alloc.n_free == n_blocks - 1


def test_allocator_fifo_matches_reference():
    """The same alloc/free script gives the same blocks in both packages
    (FIFO: a pure function of the schedule)."""
    rng = np.random.default_rng(5)
    a, b = tk.BlockAllocator(12), rk.BlockAllocator(12)
    held = []
    for _ in range(40):
        if held and rng.random() < 0.35:
            i = int(rng.integers(0, len(held)))
            blocks = held.pop(i)
            a.free(blocks)
            b.free(blocks)
            continue
        want = int(rng.integers(1, 3))
        if want > a.n_free:
            continue
        got = a.alloc(want)
        assert got == b.alloc(want)
        held.append(got)


def test_allocator_exhaustion_and_trash_block():
    alloc = tk.BlockAllocator(4)
    got = alloc.alloc(3)
    assert sorted(got) == [1, 2, 3]
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(1)
    with pytest.raises(ValueError, match="trash block"):
        alloc.free([tk.TRASH_BLOCK])
    with pytest.raises(ValueError, match=">= 2 blocks"):
        tk.BlockAllocator(1)
    alloc.free(got)
    assert alloc.n_free == 3


# ---------------------------------------------------------------------------
# appends, rollback, gather: bit-freeze and parity with the reference
# ---------------------------------------------------------------------------


def _garbage_pool(rng, P):
    pool = tk.init_paged_kv((), P, _KV, _BS, _HD)
    pool.k_codes[...] = _t(rng.integers(0, 255, pool.k_codes.shape)
                           .astype(np.uint8))
    pool.v_codes[...] = _t(rng.integers(0, 255, pool.v_codes.shape)
                           .astype(np.uint8))
    pool.k_scale[...] = _t(rng.normal(0, 1, pool.k_scale.shape)
                           .astype(np.float32))
    pool.v_scale[...] = _t(rng.normal(0, 1, pool.v_scale.shape)
                           .astype(np.float32))
    return pool


def _ref_pool(arrays):
    return rk.PagedKVCache(*(jnp.asarray(a) for a in arrays))


def test_paged_append_bit_freezes_everything_else_and_matches_reference():
    rng = np.random.default_rng(0)
    B, P = 3, 10
    pool = _garbage_pool(rng, P)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    for pos in (np.array([1, 4, 11]), np.array([0, 8, 3])):
        before = _np_pool(pool)
        k_new = rng.normal(0, 1, (B, 1, _KV, _HD)).astype(np.float32)
        v_new = rng.normal(0, 1, (B, 1, _KV, _HD)).astype(np.float32)
        # jitted, as the reference serves: XLA lowers the constant divide
        # of the scale to the reciprocal multiply the port uses
        ref = jax.jit(rk.paged_append_kv, static_argnums=5)(
            _ref_pool(before), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(pos), jnp.asarray(table), rf.E4M3)
        tk.paged_append_kv(pool, _t(k_new), _t(v_new), _t(pos), _t(table),
                           E4M3)
        touched = {(int(table[b, p // _BS]), int(p % _BS))
                   for b, p in enumerate(pos)}
        for f, a, c in zip(_FIELDS, before, _np_pool(pool)):
            mask = np.ones(a.shape, bool)
            for blk, off in touched:
                mask[blk, :, off] = False
            np.testing.assert_array_equal(a[mask], c[mask])
            np.testing.assert_array_equal(c, np.asarray(getattr(ref, f)),
                                          err_msg=f)
        kc, ks = tk.quantize_kv(_t(k_new), E4M3)
        for b, p in enumerate(pos):
            blk, off = int(table[b, p // _BS]), int(p % _BS)
            assert torch.equal(pool.k_codes[blk, :, off], kc[b, 0])
            assert torch.equal(pool.k_scale[blk, :, off], ks[b, 0])


def test_paged_append_multi_token_bitwise():
    """A T-token append (the verify step's) writes exactly the bytes of T
    single-token appends, across a block boundary."""
    rng = np.random.default_rng(1)
    T, pos0 = 3, _BS - 2
    table = _t(np.array([[1, 2]], np.int32))
    k = _t(rng.normal(0, 2, (1, T, _KV, _HD)).astype(np.float32))
    v = _t(rng.normal(0, 2, (1, T, _KV, _HD)).astype(np.float32))
    seq = tk.init_paged_kv((), 3, _KV, _BS, _HD)
    for t in range(T):
        tk.paged_append_kv(seq, k[:, t:t + 1], v[:, t:t + 1],
                           _t(np.array([pos0 + t])), table, E4M3)
    multi = tk.paged_append_kv(tk.init_paged_kv((), 3, _KV, _BS, _HD), k, v,
                               _t(np.array([pos0])), table, E4M3)
    for f in _FIELDS:
        assert torch.equal(getattr(multi, f), getattr(seq, f)), f


@pytest.mark.parametrize("lengths", [(0, 5, 16, 9), (16, 16, 0, 1)])
def test_paged_dense_dequantize_bitwise_ragged(lengths):
    """The same logical caches built densely (``append_kv``) and paged
    (allocator blocks, interleaved appends) dequantize to equal bits; the
    gathered planes equal the reference's gather of the same pool."""
    rng = np.random.default_rng(sum(lengths))
    nb, B = 4, len(lengths)
    S = nb * _BS
    alloc = tk.BlockAllocator(B * nb + 1)
    pool = tk.init_paged_kv((), B * nb + 1, _KV, _BS, _HD)
    table = np.zeros((B, nb), np.int32)
    dense = tk.init_quantized_kv((B,), _KV, S, _HD)
    for b, ln in enumerate(lengths):
        if ln:
            blocks = alloc.alloc(-(-ln // _BS))
            table[b, :len(blocks)] = blocks
    for step in range(max(lengths)):
        for b, ln in enumerate(lengths):
            if step >= ln:
                continue
            k = _t(rng.normal(0, 2, (1, 1, _KV, _HD)).astype(np.float32))
            v = _t(rng.normal(0, 2, (1, 1, _KV, _HD)).astype(np.float32))
            tk.append_kv(tk.QuantizedKVCache(*(getattr(dense, f)[b:b + 1]
                                               for f in _FIELDS)),
                         k, v, step, E4M3)
            tk.paged_append_kv(pool, k, v, _t(np.array([step])),
                               _t(table[b:b + 1]), E4M3)
    got = tk.gather_paged_kv(pool, _t(table))
    ref = rk.gather_paged_kv(_ref_pool(_np_pool(pool)), jnp.asarray(table))
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    for b, ln in enumerate(lengths):
        for c, s in (("k_codes", "k_scale"), ("v_codes", "v_scale")):
            assert torch.equal(
                _dequant(getattr(got, c)[b, :, :ln],
                         getattr(got, s)[b, :, :ln]),
                _dequant(getattr(dense, c)[b, :, :ln],
                         getattr(dense, s)[b, :, :ln]))


def _grown_pool(rng, table, length):
    pool = tk.init_paged_kv((), int(table.max()) + 1, _KV, _BS, _HD)
    for t in range(length):
        k = _t(rng.normal(0, 2, (1, 1, _KV, _HD)).astype(np.float32))
        v = _t(rng.normal(0, 2, (1, 1, _KV, _HD)).astype(np.float32))
        tk.paged_append_kv(pool, k, v, _t(np.array([t])), _t(table), E4M3)
    return pool


@pytest.mark.parametrize("accepted", [0, 1, 2, 3])
def test_paged_rollback_restores_never_drafted_state(accepted):
    """Append k candidates, accept e, roll back the rest: the pool equals
    one that only appended the e accepted tokens (and the reference's
    rollback of the same pool)."""
    rng = np.random.default_rng(accepted)
    k_spec, pos0 = 3, _BS - 1
    table = np.array([[1, 2]], np.int32)
    committed = _grown_pool(rng, table, pos0)
    base = _np_pool(committed)
    k = _t(rng.normal(0, 2, (1, k_spec, _KV, _HD)).astype(np.float32))
    v = _t(rng.normal(0, 2, (1, k_spec, _KV, _HD)).astype(np.float32))
    spec = tk.paged_append_kv(committed, k, v, _t(np.array([pos0])),
                              _t(table), E4M3)
    spec_np = _np_pool(spec)
    start, count = np.array([pos0 + accepted]), np.array([k_spec - accepted])
    rolled = tk.paged_rollback_kv(spec, _t(table), _t(start), _t(count),
                                  k_spec)
    ref = rk.paged_rollback_kv(_ref_pool(spec_np), jnp.asarray(table),
                               jnp.asarray(start), jnp.asarray(count),
                               k_spec)
    baseline = tk.PagedKVCache(*(_t(a) for a in base))
    if accepted:
        tk.paged_append_kv(baseline, k[:, :accepted], v[:, :accepted],
                           _t(np.array([pos0])), _t(table), E4M3)
    for f in _FIELDS:
        assert torch.equal(getattr(rolled, f), getattr(baseline, f)), f
        np.testing.assert_array_equal(getattr(rolled, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_paged_rollback_preserves_other_slots_and_allocator():
    rng = np.random.default_rng(3)
    alloc = tk.BlockAllocator(6)
    t0, t1 = alloc.alloc(2), alloc.alloc(2)
    free_before = list(alloc._free)
    table = _t(np.array([t0, t1], np.int32))
    pool = _garbage_pool(rng, 6)
    k = _t(rng.normal(0, 2, (2, 2, _KV, _HD)).astype(np.float32))
    pos = _t(np.array([1, _BS - 1]))
    tk.paged_append_kv(pool, k, k, pos, table, E4M3)
    spec = _np_pool(pool)
    tk.paged_rollback_kv(pool, table, pos, _t(np.array([0, 0])), 2)
    for f, a in zip(_FIELDS, spec):
        np.testing.assert_array_equal(getattr(pool, f).numpy(), a)
    tk.paged_rollback_kv(pool, table, pos, _t(np.array([2, 0])), 2)
    assert list(alloc._free) == free_before
    for t in range(2):
        p = int(pos[1]) + t
        blk, off = int(table[1, p // _BS]), p % _BS
        np.testing.assert_array_equal(pool.k_codes[blk, :, off].numpy(),
                                      spec[0][blk, :, off])
        p = int(pos[0]) + t
        blk, off = int(table[0, p // _BS]), p % _BS
        assert not pool.k_codes[blk, :, off].any()
        assert not pool.k_scale[blk, :, off].any()
    np.testing.assert_array_equal(pool.k_codes[tk.TRASH_BLOCK].numpy(),
                                  spec[0][tk.TRASH_BLOCK])


def test_kv_cache_bytes_matches_reference():
    for q in (True, False):
        assert tk.kv_cache_bytes(4, 1024, 8, 128, quantized=q) == \
            rk.kv_cache_bytes(4, 1024, 8, 128, quantized=q)


# ---------------------------------------------------------------------------
# the paged and verify entries of B2
# ---------------------------------------------------------------------------

_RAGGED = [(0, 7, 16, 3), (16, 0, 0, 12), (1, 15, 8, 16)]


def _paged_case(lengths, nb=4, bs=16, D=16, T=1, seed=0, shuffle_seed=0):
    """A shuffled physical pool + tables + logical rows for ragged
    lengths, as numpy, plus the equivalent dense contiguous cache."""
    rng = np.random.default_rng(seed)
    N = len(lengths)
    S = nb * bs
    P = N * nb + 1
    k = rng.normal(0, 1, (N, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (N, S, D)).astype(np.float32)
    q = rng.normal(0, 1, (N, T * D)).astype(np.float32)
    live_mask = np.arange(S)[None] < np.asarray(lengths)[:, None]
    k[~live_mask], v[~live_mask] = 0.0, 0.0
    kc, ks = (a.numpy() for a in tk.quantize_kv(_t(k), E4M3))
    vc, vs = (a.numpy() for a in tk.quantize_kv(_t(v), E4M3))
    ks, vs = np.where(live_mask, ks, 0.0), np.where(live_mask, vs, 0.0)
    qt = quantize_fp8(_t(q), E4M3, axis=1)
    qv = qt.q.reshape(N, T, D).numpy()
    qk = (np.broadcast_to(qt.scale.numpy(), (N, S)) * ks
          * np.float32(D ** -0.5)).astype(np.float32)
    bias = np.where(live_mask, 0.0, -1e30).astype(np.float32)
    order = 1 + np.random.default_rng(shuffle_seed).permutation(P - 1)
    k_pool = np.zeros((P, bs, D), np.uint8)
    v_pool = np.zeros((P, bs, D), np.uint8)
    bt = np.zeros((N, nb), np.int32)
    nxt = 0
    for n, ln in enumerate(lengths):
        for j in range(-(-ln // bs)):
            phys = int(order[nxt])
            nxt += 1
            bt[n, j] = phys
            k_pool[phys] = kc[n, j * bs:(j + 1) * bs]
            v_pool[phys] = vc[n, j * bs:(j + 1) * bs]
    live = np.asarray(lengths, np.int32)
    return dict(q=qv, k_pool=k_pool, v_pool=v_pool, bt=bt, live=live,
                qk=qk.astype(np.float32), vs=vs.astype(np.float32),
                bias=bias, kc=kc, vc=vc, bs=bs)


def _paged_args(c):
    return [_t(c[k]) for k in ("q", "k_pool", "v_pool", "bt", "live", "qk",
                                "vs", "bias")]


@pytest.mark.parametrize("lengths", _RAGGED)
def test_paged_entry_matches_dense_gathered_and_reference(lengths):
    """The paged entry over a shuffled pool == the dense entry over the
    contiguous cache with the same lengths (bitwise), == the plain path,
    and within tolerance of the reference's paged entry; dead slots give
    exact-zero rows."""
    c = _paged_case(lengths, shuffle_seed=3)
    args = _paged_args(c)
    paged = ta.mgs_paged_flash_attention(*args, E4M3)
    plain = ta.mgs_paged_flash_attention(*args, E4M3, use_kernel=False)
    dense = ta.mgs_flash_attention(
        _t(c["q"]), _t(c["kc"]), _t(c["vc"]), _t(c["qk"]), _t(c["vs"]),
        _t(c["bias"]), E4M3, chunk=c["bs"], lengths=_t(c["live"]))
    assert torch.equal(paged, plain) and torch.equal(paged, dense)
    ref = ra.mgs_paged_flash_attention(
        *(jnp.asarray(a.numpy()) for a in args), rf.E4M3, use_kernel=False)
    np.testing.assert_allclose(paged.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-4)
    for n, ln in enumerate(lengths):
        if ln == 0:
            assert not paged[n].any()


@pytest.mark.parametrize("lengths", _RAGGED)
def test_dense_early_exit_bitwise_vs_full_walk(lengths):
    c = _paged_case(lengths, seed=1)
    args = [_t(c[k]) for k in ("q", "kc", "vc", "qk", "vs", "bias")]
    for use_kernel in (False, True):
        early = ta.mgs_flash_attention(*args, E4M3, chunk=c["bs"],
                                       use_kernel=use_kernel,
                                       lengths=_t(c["live"]))
        full = ta.mgs_flash_attention(*args, E4M3, chunk=c["bs"],
                                      use_kernel=use_kernel)
        assert torch.equal(early, full)


def test_paged_entry_ignores_trash_and_stale_blocks():
    lengths = (7, 0, 16)
    c = _paged_case(lengths, seed=2)
    before = ta.mgs_paged_flash_attention(*_paged_args(c), E4M3)
    used = set()
    for n, ln in enumerate(lengths):
        used |= set(c["bt"][n, :-(-ln // c["bs"])].tolist())
    rng = np.random.default_rng(9)
    for p in range(c["k_pool"].shape[0]):
        if p not in used:
            c["k_pool"][p] = rng.integers(0, 255, c["k_pool"][p].shape)
            c["v_pool"][p] = rng.integers(0, 255, c["v_pool"][p].shape)
    after = ta.mgs_paged_flash_attention(*_paged_args(c), E4M3)
    assert torch.equal(before, after)


@pytest.mark.parametrize("base_lengths", [(5, 0, 14), (1, 16, 8)])
def test_paged_verify_bitwise_per_token(base_lengths):
    """Token t of the T-row verify slice equals a standalone T=1 paged
    call with that token's rows, bitwise; the verify output agrees with
    the reference's within tolerance."""
    rng = np.random.default_rng(4)
    T, R, D = 3, 2, 16
    c = _paged_case(base_lengths, D=D)
    N = len(base_lengths)
    S = c["bt"].shape[1] * c["bs"]
    q = np.asarray(rf.round_to_format(jnp.asarray(
        rng.normal(0, 20, (N, T, R, D)).astype(np.float32)), rf.E4M3))
    lengths = np.zeros((N, T), np.int32)
    for n, ln in enumerate(base_lengths):
        for t in range(T):
            lengths[n, t] = min(ln + t + 1, S) if ln else 0
    live_mask = np.arange(S)[None, None] < lengths[:, :, None]
    qk = np.where(live_mask, rng.uniform(0.5, 1.5, (N, T, S)) * 2e-3,
                  0.0).astype(np.float32)
    vs = np.where(live_mask, rng.uniform(0.5, 1.5, (N, T, S)) * 1e-2,
                  0.0).astype(np.float32)
    bias = np.where(live_mask, 0.0, -1e30).astype(np.float32)
    pools = [_t(c[k]) for k in ("k_pool", "v_pool", "bt")]
    got = ta.mgs_paged_verify_attention(_t(q), *pools, _t(lengths), _t(qk),
                                        _t(vs), _t(bias), E4M3)
    assert got.shape == (N, T, R, D)
    for t in range(T):
        solo = ta.mgs_paged_flash_attention(
            _t(q[:, t]), *pools, _t(lengths[:, t]), _t(qk[:, t]),
            _t(vs[:, t]), _t(bias[:, t]), E4M3)
        assert torch.equal(got[:, t], solo), t
    ref = ra.mgs_paged_verify_attention(
        jnp.asarray(q), *(jnp.asarray(c[k]) for k in ("k_pool", "v_pool",
                                                      "bt")),
        jnp.asarray(lengths), jnp.asarray(qk), jnp.asarray(vs),
        jnp.asarray(bias), rf.E4M3, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-4)


def test_paged_entry_shape_checks():
    c = _paged_case((3, 5))
    args = _paged_args(c)
    args[4] = args[4][:1]
    with pytest.raises(ValueError, match="lengths"):
        ta.mgs_paged_flash_attention(*args, E4M3)
