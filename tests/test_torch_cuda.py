"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no
NVIDIA GPU. Run on a machine with one:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import E3M4, E4M3, decode_bits, \
    encode_bits, get_format, round_to_format  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import mgs_attention as ta  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    dmac_table, dmac_table_plain, limb_decompose, mgs_matmul_dmac,
    mgs_matmul_dmac_codes, mgs_matmul_dmac_codes_plain,
    mgs_matmul_dmac_plain, mgs_matmul_exact,
    mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain,
    mgs_matmul_exact_plain, mgs_matmul_stationary_plain, split_plan,
    stationary_plan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _codes(shape, fmt, seed, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 30
    return encode_bits(round_to_format(x, fmt), fmt).to(dev)


@pytest.mark.parametrize("M", [1, 4, 13, 16, 70])
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b1_kernel_equals_twin(dev, M, fmt):
    K, N = 300, 197
    xc, wc = _codes((2, M, K), fmt, 0, dev), _codes((2, K, N), fmt, 1, dev)
    s = torch.rand(2, 1, N, device=dev) * 1e-2
    b = torch.randn(N, device=dev)
    for kw in ({}, {"scale": s, "bias": b}, {"flush_period": 1},
               {"scale": s, "activation": "silu"},
               {"scale": s, "activation": "gelu"}):
        n0 = LAUNCHES["mgs_matmul_exact_fused"]
        out = mgs_matmul_exact_fused(xc, wc, fmt, **kw)
        assert LAUNCHES["mgs_matmul_exact_fused"] == n0 + 1
        twin = mgs_matmul_exact_fused_plain(xc, wc, fmt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, twin), kw


def test_b2_kernel_equals_twin(dev):
    N, T, D, chunk, nb = 6, 3, 64, 32, 5
    q = round_to_format(torch.randn(N, T, D) * 20, E4M3)
    qc = encode_bits(q, E4M3).to(dev)
    kp = _codes((N * nb, chunk, D), E4M3, 2, dev)
    vp = _codes((N * nb, chunk, D), E4M3, 3, dev)
    bt = torch.randperm(N * nb, dtype=torch.int32).reshape(N, nb).to(dev)
    live = torch.tensor([160, 1, 0, 33, 64, 100], dtype=torch.int32,
                        device=dev)
    qk = torch.rand(N, T, nb * chunk, device=dev) * 1e-3
    vs = torch.rand(N, 1, nb * chunk, device=dev) * 1e-2
    vs = vs.expand(N, T, nb * chunk).contiguous()
    pos = torch.arange(nb * chunk, device=dev)
    bias = torch.where(pos[None, None] < live[:, None, None], 0.0, -1e30)
    bias = bias.expand(N, T, nb * chunk).contiguous()
    out = ta.mgs_flash_blocks(qc, kp, vp, bt, live, qk, vs, bias, E4M3)
    twin = ta._flash_plain(qc, kp, vp, bt, live, qk, vs, bias, E4M3)
    torch.cuda.synchronize()
    assert torch.equal(out, twin)
    assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.parametrize("M", [1, 4, 13, 16, 70])
@pytest.mark.parametrize("schedule", ["weight", "activation"])
def test_b3_kernel_equals_b1_and_twin(dev, M, schedule):
    K, N = 300, 197
    xc, wc = _codes((2, M, K), E4M3, 4, dev), _codes((2, K, N), E4M3, 5, dev)
    s = torch.rand(2, 1, N, device=dev) * 1e-2
    b = torch.randn(N, device=dev)
    for kw in ({}, {"scale": s, "bias": b}, {"flush_period": 1},
               {"scale": s, "activation": "silu"}):
        n0 = LAUNCHES["mgs_matmul_exact_fused_stationary"]
        out = mgs_matmul_exact_fused(xc, wc, E4M3, schedule=schedule, **kw)
        assert LAUNCHES["mgs_matmul_exact_fused_stationary"] == n0 + 1
        b1 = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
        twin = mgs_matmul_stationary_plain(xc, wc, E4M3, schedule=schedule,
                                           **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, b1) and torch.equal(out, twin), kw


@pytest.mark.parametrize("flush_period", [None, 1])
@pytest.mark.parametrize("K,N", [(4096, 11008), (11008, 4096)])
def test_b3_at_serving_width(dev, K, N, flush_period):
    """4 x K @ K x N under activation-stationary, 16-byte aligned: the
    cp.async path with 4 resident rows and K split across blocks (one
    segment, or one split per segment at flush_period=1)."""
    M = 4
    plan = stationary_plan(1, M, K, N, 128, flush_period, "activation")
    assert plan.splits > 1 and plan.lines == M
    xc, wc = _codes((M, K), E4M3, 16, dev), _codes((K, N), E4M3, 17, dev)
    s = torch.rand(N, device=dev) * 1e-2
    b = torch.randn(N, device=dev)
    n0 = LAUNCHES["mgs_matmul_exact_fused_stationary"]
    kw = dict(scale=s, bias=b, flush_period=flush_period)
    out = mgs_matmul_exact_fused(xc, wc, E4M3, schedule="activation", **kw)
    assert LAUNCHES["mgs_matmul_exact_fused_stationary"] == n0 + 1
    b1 = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
    twin = mgs_matmul_stationary_plain(xc, wc, E4M3, schedule="activation",
                                       **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, b1) and torch.equal(out, twin)
    # the workspace came back zero: a second call gives the same bits
    assert torch.equal(mgs_matmul_exact_fused(
        xc, wc, E4M3, schedule="activation", **kw), out)


def test_stationary_plan_matches_the_launcher(dev):
    import ctypes

    from repro_torch.kernels import _cuda
    fn = _cuda.load("mgs_matmul").mgs_matmul_stationary_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = None
    plan = (ctypes.c_int * 8)()
    for Bt, M, K, N, bk, fp in [(1, 4, 4096, 11008, 128, 1),
                                (1, 4, 11008, 4096, 128, 86),
                                (1, 4, 4096, 102400, 128, 32),
                                (1, 16, 4096, 4096, 128, 32),
                                (32, 64, 128, 1024, 128, 1),
                                (32, 64, 1024, 128, 128, 8),
                                (32, 192, 1024, 128, 128, 8),
                                (2, 13, 300, 197, 64, 2),
                                (1, 70, 300, 197, 128, 3),
                                (3, 1, 4100, 70, 64, 1)]:
        for schedule in ("weight", "activation"):
            fn(Bt, M, K, N, bk, fp, int(schedule == "weight"), plan)
            assert tuple(plan) == tuple(stationary_plan(Bt, M, K, N, bk, fp,
                                                        schedule))


def test_b3_refuses_an_over_budget_stripe(dev):
    xc = _codes((64, 4096), E4M3, 6, dev)
    wc = _codes((4096, 64), E4M3, 7, dev)
    with pytest.raises(ValueError, match="shared-memory budget"):
        mgs_matmul_exact_fused(xc, wc, E4M3, schedule="activation")


def test_b2_paged_and_verify_entries_equal_twin(dev):
    N, T, R, D, bs, nb = 5, 4, 1, 64, 32, 4
    S = nb * bs
    P = N * nb + 1
    kp = _codes((P, bs, D), E4M3, 8, dev)
    vp = _codes((P, bs, D), E4M3, 9, dev)
    bt = (1 + torch.randperm(P - 1)[:N * nb]).to(torch.int32).reshape(
        N, nb).to(dev)
    bt[1, 2:] = 0                       # trash-block tail
    base = torch.tensor([100, 0, 33, 64, 1], dtype=torch.int32, device=dev)
    q = round_to_format(torch.randn(N, T, R, D) * 20, E4M3).to(dev)
    lengths = torch.where(base[:, None] > 0, base[:, None] + torch.arange(
        T, device=dev)[None] + 1, 0).to(torch.int32)
    pos = torch.arange(S, device=dev)
    live = pos[None, None] < lengths[:, :, None]
    qk = torch.where(live, torch.rand(N, T, S, device=dev) * 1e-3, 0.0)
    vs = torch.where(live, torch.rand(N, T, S, device=dev) * 1e-2, 0.0)
    bias = torch.where(live, 0.0, -1e30)
    n0 = LAUNCHES["mgs_flash_attention"]
    ver = ta.mgs_paged_verify_attention(q, kp, vp, bt, lengths, qk, vs, bias,
                                        E4M3)
    ver_plain = ta.mgs_paged_verify_attention(q, kp, vp, bt, lengths, qk, vs,
                                              bias, E4M3, use_kernel=False)
    dec = ta.mgs_paged_flash_attention(q[:, 0], kp, vp, bt, lengths[:, 0],
                                       qk[:, 0], vs[:, 0], bias[:, 0], E4M3)
    dec_plain = ta.mgs_paged_flash_attention(
        q[:, 0], kp, vp, bt, lengths[:, 0], qk[:, 0], vs[:, 0], bias[:, 0],
        E4M3, use_kernel=False)
    torch.cuda.synchronize()
    assert LAUNCHES["mgs_flash_attention"] == n0 + 2
    assert torch.equal(ver, ver_plain) and torch.equal(dec, dec_plain)
    assert torch.equal(ver[:, 0], dec)
    assert not ver[1].any()


def _paged_case(dev, lens, KV, R, D, bs, T, fmt, seed):
    """A paged pool through a permuted table: stale blocks, free slots
    (length 0) and unallocated tails on the trash block 0; verify token t
    attends to ``lens - (T - 1) + t`` keys (token T - 1 is the decode)."""
    g = torch.Generator().manual_seed(seed)
    slots = len(lens)
    nb = max(1, -(-max(lens) // bs))
    S, P = nb * bs, slots * nb + 1
    kp = _codes((P * KV, bs, D), fmt, seed + 1, dev)
    vp = _codes((P * KV, bs, D), fmt, seed + 2, dev)
    bt = (1 + torch.randperm(P - 1, generator=g)[:slots * nb]).to(
        torch.int32).reshape(slots, nb)
    dec = torch.tensor(lens)
    bt[torch.arange(nb)[None] * bs >= dec[:, None]] = 0
    bt = (bt[:, None, :] * KV + torch.arange(KV)[None, :, None]).reshape(
        slots * KV, nb).to(torch.int32)
    lengths = torch.where(dec[:, None] > 0, torch.clamp_min(
        dec[:, None] - (T - 1) + torch.arange(T)[None], 1), 0)
    lengths = lengths.to(torch.int32).repeat_interleave(KV, dim=0)
    N = slots * KV
    q = round_to_format(torch.randn(N, T, R, D, generator=g) * 20, fmt)
    live = torch.arange(S)[None, None] < lengths[:, :, None]
    qk = torch.where(live, torch.rand(N, T, S, generator=g) * 1e-3, 0.0)
    vs = torch.where(live, torch.rand(N, T, S, generator=g) * 1e-2, 0.0)
    bias = torch.where(live, 0.0, -1e30)
    return [x.to(dev) for x in (q, kp, vp, bt, lengths, qk, vs, bias)]


def _entries_equal_twin(case, fmt):
    q, kp, vp, bt, lengths, qk, vs, bias = case
    n0 = LAUNCHES["mgs_flash_attention"]
    out = {}
    for k in (True, False):
        out[k] = (ta.mgs_paged_flash_attention(
            q[:, -1], kp, vp, bt, lengths[:, -1], qk[:, -1], vs[:, -1],
            bias[:, -1], fmt, use_kernel=k),
            ta.mgs_paged_verify_attention(q, kp, vp, bt, lengths, qk, vs,
                                          bias, fmt, use_kernel=k))
    torch.cuda.synchronize()
    assert LAUNCHES["mgs_flash_attention"] == n0 + 2
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    dec, ver = out[True]
    assert torch.equal(ver[:, -1], dec)
    assert torch.isfinite(ver).all()
    return dec, ver


# (kv heads, query rows a kv head, head dim, decode lengths): granite-20b
# (one kv head, 48 rows: 192 at a spec_k=4 verify), gemma3-27b (head dim
# 168), minicpm-2b (head dim 64), deepseek-7b
_ARCH_WIDTHS = {"granite-20b": (1, 48, 128, [300, 0, 129, 1]),
                "gemma3-27b": (4, 2, 168, [640, 0, 257, 3]),
                "minicpm-2b": (4, 1, 64, [500, 1, 0, 128]),
                "deepseek-7b": (8, 1, 128, [1024, 0, 700, 2])}


@pytest.mark.parametrize("arch", list(_ARCH_WIDTHS))
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b2_entries_at_dense_arch_widths(dev, arch, fmt):
    KV, R, D, lens = _ARCH_WIDTHS[arch]
    case = _paged_case(dev, lens, KV, R, D, 128, 4, fmt, 20)
    dec, ver = _entries_equal_twin(case, fmt)
    free = lens.index(0)
    assert not ver[free * KV:(free + 1) * KV].any()   # exact zeros


@pytest.mark.parametrize("nb", [7, 8, 9, 16, 17, 33])
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b2_across_split_passes(dev, nb, fmt):
    """Tables 7 to 33 chunks wide (cluster 8: one to five passes), lengths
    at and around the pass edges, chunk 32, shared and per-row rows."""
    bs = 32
    lens = [nb * bs, nb * bs - 1, (nb - 1) * bs + 1, min(nb, 8) * bs, 1, 0]
    case = _paged_case(dev, lens, 2, 3, 64, bs, 4, fmt, nb)
    _entries_equal_twin(case, fmt)


def test_b2_paged_4096_keys(dev):
    """4 slots x 32 heads, block 128, decode lengths 4096, 0, 2000, 1 over a
    permuted pool with stale and trash blocks."""
    case = _paged_case(dev, [4096, 0, 2000, 1], 32, 1, 128, 128, 4, E4M3, 40)
    dec, ver = _entries_equal_twin(case, E4M3)
    assert not ver[32:64].any()


def test_b2_granite_spec4_verify_fits(dev):
    """A granite-20b verify at spec_k=4 (one kv head, 4 tokens x 48 query
    rows = 192 rows a slice, head dim 128, chunk 128) launches: no dense
    arch's decode or verify exceeds the shared-memory limit."""
    from repro_torch.kernels import _cuda
    for rows, D in ((1, 64), (16, 64), (8, 168), (16, 168), (48, 128),
                    (192, 128)):
        assert 0 < ta._kernel().mgs_flash_attention_smem(
            rows, D, 128) <= _cuda.SMEM_LIMIT
    q, kp, vp, bt, lengths, qk, vs, bias = _paged_case(
        dev, [130, 4096, 1, 0], 1, 48, 128, 128, 4, E4M3, 50)
    ver = ta.mgs_paged_verify_attention(q, kp, vp, bt, lengths, qk, vs, bias,
                                        E4M3)
    torch.cuda.synchronize()
    assert ver.shape == (4, 4, 48, 128) and torch.isfinite(ver).all()


@pytest.mark.parametrize("pool", ["k", "v"])
def test_b2_refuses_a_pool_off_16_bytes(dev, pool):
    """A tile is one bulk copy: a pool view that starts off a 16-byte
    boundary is refused, not launched, and the aligned copy of the same
    pool still equals the twin."""
    case = _paged_case(dev, [200, 0, 65, 1], 2, 1, 64, 32, 4, E4M3, 60)
    q, kp, vp, bt, lengths, qk, vs, bias = case
    i = 1 if pool == "k" else 2
    flat = torch.empty(case[i].numel() + 4, dtype=torch.uint8, device=dev)
    view = flat[4:].view(case[i].shape)
    view.copy_(case[i])
    assert view.data_ptr() % 16
    bad = list(case)
    bad[i] = view
    n0 = LAUNCHES["mgs_flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        ta.mgs_paged_flash_attention(
            bad[0][:, -1], bad[1], bad[2], bt, lengths[:, -1], qk[:, -1],
            vs[:, -1], bias[:, -1], E4M3)
    assert LAUNCHES["mgs_flash_attention"] == n0
    _entries_equal_twin(case, E4M3)


@pytest.mark.parametrize("M", [1, 4, 13, 16, 70])
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b4_kernel_equals_b1_and_twin(dev, M, fmt):
    K, N = 300, 197
    xc, wc = _codes((2, M, K), fmt, 10, dev), _codes((2, K, N), fmt, 11, dev)
    xl = limb_decompose(decode_bits(xc, fmt), fmt).movedim(0, 1)
    wl = limb_decompose(decode_bits(wc, fmt), fmt).movedim(0, 1)
    for kw in ({}, {"flush_period": 1}, {"block_k": 64, "flush_period": 2}):
        n0 = LAUNCHES["mgs_matmul_exact"]
        out = mgs_matmul_exact(xl, wl, fmt, **kw)
        assert LAUNCHES["mgs_matmul_exact"] == n0 + 1
        b1 = mgs_matmul_exact_fused(xc, wc, fmt, **kw)
        twin = mgs_matmul_exact_plain(xl, wl, fmt, **kw)
        shared = mgs_matmul_exact(xl, wl[0], fmt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, b1) and torch.equal(out, twin), kw
        assert torch.equal(shared, mgs_matmul_exact_plain(xl, wl[0], fmt,
                                                          **kw))


@pytest.mark.parametrize("flush_period", [None, 1])
def test_b1_b4_split_k_at_serving_width(dev, flush_period):
    """4 x 4096 @ 4096 x 11008, 16-byte aligned: the cp.async path with K
    split across blocks (one segment, or 32 at flush_period=1)."""
    M, K, N = 4, 4096, 11008
    plan = split_plan(1, M, K, N, 128, flush_period)
    assert plan.splits > 1
    xc, wc = _codes((M, K), E4M3, 14, dev), _codes((K, N), E4M3, 15, dev)
    xl = limb_decompose(decode_bits(xc, E4M3))
    wl = limb_decompose(decode_bits(wc, E4M3))
    s = torch.rand(N, device=dev) * 1e-2
    n1, n4 = LAUNCHES["mgs_matmul_exact_fused"], LAUNCHES["mgs_matmul_exact"]
    b1 = mgs_matmul_exact_fused(xc, wc, E4M3, scale=s,
                                flush_period=flush_period)
    b1_raw = mgs_matmul_exact_fused(xc, wc, E4M3, flush_period=flush_period)
    b4 = mgs_matmul_exact(xl, wl, E4M3, flush_period=flush_period)
    assert LAUNCHES["mgs_matmul_exact_fused"] == n1 + 2
    assert LAUNCHES["mgs_matmul_exact"] == n4 + 1
    twin = mgs_matmul_exact_fused_plain(xc, wc, E4M3, scale=s,
                                        flush_period=flush_period)
    torch.cuda.synchronize()
    assert torch.equal(b1, twin)
    assert torch.equal(b4, b1_raw)
    assert torch.equal(b4, mgs_matmul_exact_plain(xl, wl, E4M3,
                                                  flush_period=flush_period))
    # the workspace came back zero: a second call gives the same bits
    assert torch.equal(mgs_matmul_exact_fused(
        xc, wc, E4M3, scale=s, flush_period=flush_period), b1)


def test_split_plan_matches_the_launcher(dev):
    import ctypes

    from repro_torch.kernels import _cuda
    fn = _cuda.load("mgs_matmul").mgs_matmul_split_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    plan = (ctypes.c_int * 4)()
    for Bt, M, K, N, bk, fp in [(1, 4, 4096, 11008, 128, 1),
                                (1, 4, 11008, 4096, 128, 86),
                                (1, 16, 4096, 4096, 128, 32),
                                (1, 4, 4096, 102400, 128, 32),
                                (2, 13, 300, 197, 64, 2),
                                (128, 1, 128, 49, 128, 1),
                                (1, 70, 300, 197, 128, 3),
                                (3, 1, 4100, 70, 64, 1)]:
        fn(Bt, M, K, N, bk, fp, plan)
        assert tuple(plan) == tuple(split_plan(Bt, M, K, N, bk, fp))


@pytest.mark.parametrize("M", [1, 4, 7, 13, 70])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e3m4"])
def test_b5_kernel_equals_twin(dev, M, fmt):
    f = get_format(fmt)
    K, N = 300, 75
    g = torch.Generator().manual_seed(12)
    scale = {"e4m3": 0.3, "e5m2": 0.05, "e3m4": 1.0}[fmt]
    x = round_to_format(torch.randn(3, M, K, generator=g) * scale, f).to(dev)
    w = round_to_format(torch.randn(3, K, N, generator=g) * scale, f).to(dev)
    for gate in (True, False):
        n0 = LAUNCHES["mgs_matmul_dmac"]
        out = mgs_matmul_dmac(x, w, f, gate)
        assert LAUNCHES["mgs_matmul_dmac"] == n0 + 1
        twin = mgs_matmul_dmac_plain(x, w, f, gate)
        shared = mgs_matmul_dmac(x, w[1], f, gate)
        torch.cuda.synchronize()
        assert torch.equal(out, twin), gate
        assert torch.equal(shared, mgs_matmul_dmac_plain(x, w[1], f, gate))
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("M", [1, 4, 7, 13, 70])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e3m4"])
def test_b5_codes_kernel_equals_twin_and_float_entry(dev, M, fmt):
    f = get_format(fmt)
    K, N = 300, 75
    g = torch.Generator().manual_seed(13)
    scale = {"e4m3": 0.3, "e5m2": 0.05, "e3m4": 1.0}[fmt]
    x = round_to_format(torch.randn(3, M, K, generator=g) * scale, f).to(dev)
    w = round_to_format(torch.randn(3, K, N, generator=g) * scale, f).to(dev)
    xc, wc = encode_bits(x, f), encode_bits(w, f)
    for gate in (True, False):
        n0 = LAUNCHES["mgs_matmul_dmac"]
        out = mgs_matmul_dmac_codes(xc, wc, f, gate)
        assert LAUNCHES["mgs_matmul_dmac"] == n0 + 1
        flt = mgs_matmul_dmac(x, w, f, gate)
        assert LAUNCHES["mgs_matmul_dmac"] == n0 + 2
        shared = mgs_matmul_dmac_codes(xc, wc[2], f, gate)
        twin = mgs_matmul_dmac_codes_plain(xc, wc, f, gate)
        torch.cuda.synchronize()
        assert torch.equal(out, twin), gate
        assert torch.equal(flt, out), gate
        assert torch.equal(shared, mgs_matmul_dmac_codes_plain(
            xc, wc[2], f, gate))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e3m4"])
def test_b5_device_table_equals_twin(dev, fmt):
    f = get_format(fmt)
    for gate in (True, False):
        tbl = dmac_table(dev, f, gate)
        assert tbl.shape == (128, 128) and tbl.dtype == torch.uint8
        assert torch.equal(tbl.cpu(), dmac_table_plain(f, gate)), gate
        assert dmac_table(dev, f, gate) is tbl          # built once


# ---------------------------------------------------------------------------
# calibration's runtime values at the kernels
# ---------------------------------------------------------------------------


def test_b2_paged_entries_with_static_q_scale(dev):
    """B2's paged decode and verify entries at the continuous width (4
    slots x 32 heads x 128, block 128) under a static decode-query scale
    whose per-slot vector holds a 0 (that live slot's rows take the dynamic
    reduce) == the twin; the static rows differ from the dynamic run, the
    dynamic slot's do not."""
    from repro_torch.models.attention import (_sdpa_paged_cache,
                                              _sdpa_paged_verify)
    from repro_torch.quant import PagedKVCache
    from repro_torch.quant.calibrate import applied_calib_state
    from repro_torch.quant.config import FP8_MGS_SERVE_PAGED
    slots, KV, hd, bs, nb, T = 4, 32, 128, 128, 2, 4
    P = slots * nb + 1
    g = torch.Generator().manual_seed(40)
    cache = PagedKVCache(_codes((P, KV, bs, hd), E4M3, 41, dev),
                         _codes((P, KV, bs, hd), E4M3, 42, dev),
                         (torch.rand(P, KV, bs, generator=g) * 1e-2).to(dev),
                         (torch.rand(P, KV, bs, generator=g) * 1e-2).to(dev))
    bt = (1 + torch.randperm(P - 1, generator=g)[:slots * nb]).to(
        torch.int32).reshape(slots, nb).to(dev)
    pos = torch.tensor([201, 64, 126, 2], dtype=torch.int32, device=dev)
    lengths = pos + 1
    q = (torch.randn(slots, T, KV, 1, hd, generator=g) * 2).to(dev)
    k_pos = torch.arange(nb * bs, device=dev)
    positions = pos[:, None].to(torch.int64) + torch.arange(T, device=dev)
    bias_v = torch.where(k_pos[None, None] <= positions[:, :, None], 0.0,
                         -1e30)
    amax = torch.tensor([2.5, 0.0, 4.0, 3.0], device=dev)
    state = {"q_amax": amax, "q_amax_min": 0.0, "q_amax_max": 4.0}
    out = {}
    for static in (True, False):
        for k in (True, False):
            quant = FP8_MGS_SERVE_PAGED.replace(static_q_scale=static,
                                                use_kernel=k)
            n0 = LAUNCHES["mgs_flash_attention"]
            with applied_calib_state(state):
                out[static, k] = (
                    _sdpa_paged_cache(q[:, :1], cache, bt, bias_v[:, :1],
                                      lengths, quant),
                    _sdpa_paged_verify(q, cache, bt, bias_v, positions,
                                       lengths, quant))
            assert LAUNCHES["mgs_flash_attention"] == n0 + 2 * k
    torch.cuda.synchronize()
    for static in (True, False):
        for a, b in zip(out[static, True], out[static, False]):
            assert torch.equal(a, b)
            assert torch.isfinite(a).all()
    dec, ver = out[True, True]
    dyn_dec, dyn_ver = out[False, True]
    assert torch.equal(dec[1], dyn_dec[1]) and torch.equal(ver[1], dyn_ver[1])
    assert not torch.equal(dec[0], dyn_dec[0])
    assert not torch.equal(ver[2], dyn_ver[2])


_PERIOD_KERNELS = {"b1": "mgs_matmul_exact_fused",
                   "b3": "mgs_matmul_exact_fused_stationary",
                   "b4": "mgs_matmul_exact"}


@pytest.mark.parametrize("period", [1, 2, 2**31 - 1])
@pytest.mark.parametrize("kernel", list(_PERIOD_KERNELS))
def test_flush_period_through_qmatmul_equals_direct_call(dev, kernel,
                                                         period):
    """A flush period from the applied runtime state reaches B1, B3
    (``schedule="activation"``) and B4 through ``qmatmul``: == the kernel
    called directly with that period; ``2**31 - 1`` (the clamp of a
    near-uniform plan) runs and gives the worst case's bits."""
    from repro_torch.quant import prepare_weight
    from repro_torch.quant.calibrate import applied_calib_state
    from repro_torch.quant.config import FP8_MGS_EXACT, FP8_MGS_SERVE
    from repro_torch.quant.qmatmul import qmatmul
    from repro_torch.quant.quantize import quantize_fp8
    cfg = {"b1": FP8_MGS_SERVE,
           "b3": FP8_MGS_SERVE.replace(schedule="activation"),
           "b4": FP8_MGS_EXACT.replace(use_kernel=True)}[kernel]
    g = torch.Generator().manual_seed(50)
    x = (torch.randn(4, 4096, generator=g)
         * torch.exp(torch.randn(4096, generator=g))).to(dev)
    pw = prepare_weight((torch.randn(4096, 1024, generator=g) * 0.02).to(dev),
                        cfg)
    name = _PERIOD_KERNELS[kernel]
    n0 = LAUNCHES[name]
    with applied_calib_state({"flush": {"ffn.wd": period}}):
        got = qmatmul(x, pw, cfg, site="ffn.wd")
    assert LAUNCHES[name] == n0 + 1
    qx = quantize_fp8(x, E4M3)
    scale = qx.scale * pw.scale
    fp = None if period == 2**31 - 1 else period
    if kernel == "b4":
        want = mgs_matmul_exact(limb_decompose(qx.q, E4M3), pw.limbs, E4M3,
                                block_k=cfg.block_k, flush_period=fp) * scale
    else:
        want = mgs_matmul_exact_fused(
            encode_bits(qx.q, E4M3), pw.codes, E4M3, scale=scale,
            block_k=cfg.block_k, flush_period=fp, schedule=cfg.schedule)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# B1 on the MoE path of granite-moe-1b-a400m at batch 4: the experts in one
# launch over all 32 (2 rows a slice at decode, 40 at a 4 x 32 prefill; the
# gate with its silu epilogue), the router's 32 columns, the 49155-column
# logits head (rows not 16-byte aligned)
@pytest.mark.parametrize("Bt,M,K,N,act", [
    (32, 2, 1024, 512, "silu"), (32, 2, 512, 1024, "none"),
    (32, 40, 1024, 512, "silu"), (1, 4, 1024, 32, "none"),
    (1, 4, 1024, 49155, "none")])
def test_b1_at_moe_shapes(dev, Bt, M, K, N, act):
    """Per-expert scales, an expert slice of zero codes (an expert no
    token chose: zeros out), the path's epilogue: kernel == twin."""
    xc = _codes((Bt, M, K), E4M3, 60, dev)
    if Bt > 1:
        xc[1] = 0
    wc = _codes((Bt, K, N), E4M3, 61, dev)
    s = torch.rand(Bt, 1, 1, device=dev) * 1e-3
    for kw in ({}, {"scale": s}, {"scale": s, "activation": act}):
        out = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
        twin = mgs_matmul_exact_fused_plain(xc, wc, E4M3, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, twin), kw
        if Bt > 1:
            assert not out[1].any()


def test_moe_apply_on_the_card_is_deterministic(dev):
    """One granite-moe-1b-a400m layer at full width under
    ``FP8_MGS_SERVE_KV``: the router and the three expert contractions
    are one B1 launch each, and two calls give identical bits (dispatch
    and combine are gathers and integer adds, no float scatter)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layer_params, moe_apply
    from repro_torch.quant import prepare_params
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=1,
                              quant=FP8_MGS_SERVE_KV)
    params = prepare_params(init_params(cfg, 0, device=dev), cfg.quant)
    p = layer_params(params["layers"], 0)["moe"]
    g = torch.Generator(device=dev).manual_seed(62)
    for T in (1, 32):
        x = torch.randn((4, T, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        n0 = LAUNCHES["mgs_matmul_exact_fused"]
        y1, _ = moe_apply(p, x, cfg)
        assert LAUNCHES["mgs_matmul_exact_fused"] == n0 + 4
        y2, _ = moe_apply(p, x, cfg)
        torch.cuda.synchronize()
        assert torch.isfinite(y1).all() and torch.equal(y1, y2)


def _dense_b2_case(dev, N, T, D, S, live, seed):
    """Dense-entry B2 inputs: ``N`` slices of ``T`` query rows over ``S``
    keys in 128-key chunks, slice ``i`` with ``live[i]`` live keys and a
    bias row masking the rest (no causal part: one row a slice)."""
    chunk, nb = 128, S // 128
    qc = _codes((N, T, D), E4M3, seed, dev)
    kp = _codes((N * nb, chunk, D), E4M3, seed + 1, dev)
    vp = _codes((N * nb, chunk, D), E4M3, seed + 2, dev)
    bt = torch.arange(N * nb, dtype=torch.int32, device=dev).reshape(N, nb)
    live = torch.as_tensor(live, dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    qk = torch.rand(N, 1, S, device=dev) * 1e-3
    vs = torch.rand(N, 1, S, device=dev) * 1e-2
    bias = torch.where(pos[None, None] < live[:, None, None], 0.0, -1e30)
    return qc, kp, vp, bt, live, qk, vs, bias


@pytest.mark.parametrize("case", ["whisper cross", "internvl2", "jamba"])
def test_b2_at_late_family_shapes(dev, case):
    """B2 == twin at whisper-tiny's cross-attention (4 requests x 6 heads,
    one row of 64, 1500 live frames of 1536 keys, the padded tail masked by
    a non-causal bias row), internvl2-2b's heads (8 kv x 2 rows of 128, up
    to 304 live keys of 384) and jamba's (8 kv x 8 rows of 128)."""
    N, T, D, S, live = {
        "whisper cross": (24, 1, 64, 1536, [1500] * 24),
        "internvl2": (32, 2, 128, 384, [304, 0, 1] + [289 + i % 16
                                                      for i in range(29)]),
        "jamba": (32, 8, 128, 128, [49, 0] + [1 + i for i in range(30)]),
    }[case]
    args = _dense_b2_case(dev, N, T, D, S, live, 70)
    n0 = LAUNCHES["mgs_flash_attention"]
    out = ta.mgs_flash_blocks(*args, E4M3)
    assert LAUNCHES["mgs_flash_attention"] == n0 + 1
    twin = ta._flash_plain(*args, E4M3)
    torch.cuda.synchronize()
    assert torch.equal(out, twin)
    assert torch.isfinite(out).all()
    dead = args[4] == 0
    assert not out[dead].any()


def test_reduced_hybrid_is_deterministic_on_the_card(dev):
    """Reduced jamba (2 periods, MoE and Mamba sublayers) under
    ``FP8_MGS_SERVE_KV``: a prefill and 3 decode steps run twice on the
    card give identical logits, through B1 and B2."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    cfg = dataclasses.replace(reduced_config("jamba-1.5-large-398b"),
                              quant=FP8_MGS_SERVE_KV)
    eng = ServeEngine(cfg, batch=2, max_len=16, device=dev)
    toks = torch.randint(1, cfg.vocab, (2, 8), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))

    def run():
        rows = []
        logits, cache = prefill(eng.params, cfg, {"tokens": toks},
                                init_cache(cfg, 2, 16, device=dev))
        for _ in range(3):
            rows.append(logits)
            logits, cache = decode_step(eng.params, cfg,
                                        logits.argmax(-1)[:, None], cache)
        return torch.stack(rows + [logits])
    n0 = dict(LAUNCHES)
    a = run()
    assert LAUNCHES["mgs_flash_attention"] == n0["mgs_flash_attention"] + 6
    assert LAUNCHES["mgs_matmul_exact_fused"] > n0["mgs_matmul_exact_fused"]
    b = run()
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the paper's accumulation analysis (chip_smoke.py phase 11), small sizes
# ---------------------------------------------------------------------------


def _leaves(out):
    if isinstance(out, tuple):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _card_equals_cpu(fn, *args):
    """``fn`` on the card == ``fn`` on the CPU, bitwise, every returned
    tensor (counters included)."""
    gpu = _leaves(fn(*(a.cuda() for a in args)))
    cpu = _leaves(fn(*args))
    torch.cuda.synchronize()
    assert len(gpu) == len(cpu)
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b), i


def _fp8_rows(shape, seed, scale=1.0, fmt=E4M3):
    g = torch.Generator().manual_seed(seed)
    return round_to_format(torch.randn(shape, generator=g) * scale, fmt)


@pytest.mark.parametrize("fn", ["sequential_sum", "pairwise_sum",
                                "kahan_sum"])
def test_low_precision_sum_on_the_card_equals_cpu(dev, fn):
    from repro_torch.core import summation
    p = _fp8_rows((16, 300), 0, 3.0)
    _card_equals_cpu(lambda a: getattr(summation, fn)(
        a, summation.acc_format(4)), p)


@pytest.mark.parametrize("fn", ["exact", "dmac", "dmac_emulator",
                                "narrow_clipped"])
def test_mgs_dot_on_the_card_equals_cpu(dev, fn):
    from repro_torch.core import mgs
    x, w = _fp8_rows((16, 257), 1, 3.0), _fp8_rows((16, 257), 2)
    call = {"exact": lambda a, b: mgs.mgs_dot_exact(a, b, E4M3, "exact"),
            "dmac": lambda a, b: mgs.mgs_dot_exact(a, b, E4M3, "dmac"),
            "dmac_emulator": lambda a, b: mgs.mgs_dot_dmac(a, b),
            "narrow_clipped": lambda a, b: mgs.mgs_dot_narrow_clipped(a, b)}
    _card_equals_cpu(call[fn], x, w)


@pytest.mark.parametrize("fn", ["int_dot_dmac", "int_dot_clip",
                                "int_dot_wrap", "int_dot_exact"])
def test_int_dot_on_the_card_equals_cpu(dev, fn):
    from repro_torch.core import int_dmac
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 128, (64, 576), generator=g, dtype=torch.int32)
    w = torch.randint(-15, 16, (64, 576), generator=g, dtype=torch.int32)
    f = getattr(int_dmac, fn)
    _card_equals_cpu((lambda a, b: f(a, b)) if fn == "int_dot_exact"
                     else (lambda a, b: f(a, b, 9)), x, w)


@pytest.mark.parametrize("kw", [
    dict(dtype="fp8_e4m3", accum="swamp"),
    dict(dtype="int8", accum="mgs_dmac"),
    dict(dtype="int8", accum="clip", narrow_bits=16),
    dict(dtype="int8", accum="wrap", narrow_bits=24),
    dict(dtype="int4", accum="wide", per_channel=True, per_row_act=True)],
    ids=lambda kw: f"{kw['dtype']}-{kw['accum']}")
def test_qmatmul_swamp_and_int_on_the_card_equal_cpu(dev, kw):
    from repro_torch.quant import QuantConfig, qmatmul
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 512), generator=g)
    w = torch.randn((512, 384), generator=g) * 512 ** -0.5
    cfg = QuantConfig(**kw)
    _card_equals_cpu(lambda a, b: qmatmul(a, b, cfg), x, w)
    xb = torch.randn((3, 5, 256), generator=g)
    wb = torch.randn((3, 256, 64), generator=g)
    _card_equals_cpu(lambda a, b: qmatmul(a, b, cfg, batched=True), xb, wb)


# the teacher-forced forward of full-width mgs-paper-eval over 8 x 64 tokens
# (launch.dryrun.eval_b1_shapes): projections over 512 rows, the score / value
# contractions over 8 x 6 (batch, kv head) slices, the tied 32768 head
_EVAL_SHAPES = [(1, 512, 384, 384, "none"), (1, 512, 384, 1536, "silu"),
                (1, 512, 1536, 384, "none"), (48, 64, 64, 64, "none"),
                (1, 512, 384, 32768, "none")]


@pytest.mark.parametrize("Bt,M,K,N,act", _EVAL_SHAPES)
def test_b1_and_b5_at_eval_forward_shapes(dev, Bt, M, K, N, act):
    xc, wc = _codes((Bt, M, K), E4M3, 5, dev), _codes((Bt, K, N), E4M3, 6, dev)
    s = torch.full((Bt, 1, 1), 1e-3, device=dev)
    for kw in ({}, {"scale": s, "activation": act}):
        out = mgs_matmul_exact_fused(xc, wc, E4M3, **kw)
        twin = mgs_matmul_exact_fused_plain(xc, wc, E4M3, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, twin), kw
    g = torch.Generator().manual_seed(7)
    x = round_to_format(torch.randn((Bt, M, K), generator=g) / 16, E4M3)
    w = round_to_format(torch.randn((Bt, K, N), generator=g) / 16, E4M3)
    xc5, wc5 = encode_bits(x, E4M3).to(dev), encode_bits(w, E4M3).to(dev)
    n0 = LAUNCHES["mgs_matmul_dmac"]
    out = mgs_matmul_dmac_codes(xc5, wc5, E4M3)
    assert LAUNCHES["mgs_matmul_dmac"] == n0 + 1
    twin = mgs_matmul_dmac_codes_plain(xc5, wc5, E4M3)
    torch.cuda.synchronize()
    assert torch.equal(out, twin)


def test_train_step_on_the_card_matches_cpu(dev):
    """One ``make_train_step`` on reduced deepseek-7b, float32 compute, the
    same parameters and batch: loss and grad norm within 1e-5 (relative),
    updated parameters within 1e-6 in >= 99.9% of each leaf's entries and
    within 2 x lr everywhere (AdamW's first step is g / |g|, whose sign
    near a zero gradient follows the sums' last bits)."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32")
    params = init_params(cfg, seed=0)
    hb = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                seed=0)).make_batch(0)
    step = make_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=0,
                                          schedule="const"))
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(_tree_to(params, d))
        new, m = step(state, {k: torch.from_numpy(v).to(d)
                              for k, v in hb.items()})
        out[str(d)] = (flatten_with_paths(new["params"]),
                       {k: float(v) for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out[str(dev)]
    for k in ("loss", "grad_norm"):
        assert mg[k] == pytest.approx(mc[k], rel=1e-5), k
    for k, v in pc.items():
        diff = (pg[k].cpu() - v).abs()
        assert (diff <= 1e-6).float().mean() >= 0.999, k
        assert diff.max() <= 2 * 3e-3, k


def _tree_to(tree, d):
    if isinstance(tree, dict):
        return {k: _tree_to(v, d) for k, v in tree.items()}
    return tree.to(d)


def _fleet_tokens(cfg, params, devices, n=8):
    import numpy as np
    from repro_torch.launch.replica import ReplicaServeDriver
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 12).astype(
        np.int32), max_new_tokens=6) for i in range(n)]
    with ReplicaServeDriver(cfg, 2, batch=2, max_len=24,
                            params=_tree_to(params, devices[0].device),
                            devices=devices) as driver:
        stats = driver.run(reqs, timeout=300)
    return [r.out_tokens for r in reqs], stats


def test_fleet_on_two_slots_of_the_card_equals_the_cpu_fleet(dev):
    """R = 2 replicas on two slots of one card (a CUDA stream each) serve
    reduced deepseek-7b (float32 compute, FP8_MGS_SERVE_KV, wo / wd x 8 so
    tokens vary): the same tokens as the fleet on two CPU slots, with B1
    and B2 launched from both workers."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import virtual_devices
    from repro_torch.models import init_params
    from repro_torch.quant.config import FP8_MGS_SERVE_KV
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32",
                              quant=FP8_MGS_SERVE_KV)
    params = init_params(cfg, seed=0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0
    want, _ = _fleet_tokens(cfg, params, virtual_devices("cpu", 2))
    reset_launch_counts()
    got, stats = _fleet_tokens(cfg, params, virtual_devices(dev, 2))
    assert got == want
    assert stats["groups_per_replica"] == [2, 2]
    assert LAUNCHES["mgs_matmul_exact_fused"] > 0
    assert LAUNCHES["mgs_flash_attention"] > 0


def test_b1_split_k_stays_exact_with_two_streams_launching(dev):
    """Two threads, each on a CUDA stream of its own, launch B1 at a
    split-K decode shape at once: every result equals the twin (each
    stream keeps its own zeroed workspace; a shared one would mix the
    partial sums)."""
    import threading
    M, K, N = 4, 4096, 2048
    assert split_plan(1, M, K, N, 128, None).splits > 1
    xs = [_codes((M, K), E4M3, 10 + i, dev) for i in range(2)]
    wc = _codes((K, N), E4M3, 12, dev)
    twins = [mgs_matmul_exact_fused_plain(x, wc, E4M3) for x in xs]
    torch.cuda.synchronize()
    bad, errors = [], []

    def worker(i):
        try:
            s = torch.cuda.Stream(dev)
            with torch.cuda.stream(s):
                for _ in range(40):
                    out = mgs_matmul_exact_fused(xs[i], wc, E4M3)
                    s.synchronize()
                    if not torch.equal(out, twins[i]):
                        bad.append(i)
        except Exception as e:      # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad


# ---------------------------------------------------------------------------
# sharded serving: B1's partials / flush entries, ranks sharing the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 4, 16, 70])
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b1_partials_and_flush_equal_b1_and_the_twin(dev, M, fmt):
    from repro_torch.kernels.mgs_matmul import (mgs_matmul_exact_flush,
                                                mgs_matmul_exact_partials)
    K, N = 1000, 200
    xc, wc = _codes((2, M, K), fmt, 2, dev), _codes((2, K, N), fmt, 3, dev)
    s = torch.rand(2, 1, N, device=dev) * 1e-2
    for fp in (None, 1, 3):
        kw = dict(block_k=64, flush_period=fp)
        one = mgs_matmul_exact_fused(xc, wc, fmt, scale=s,
                                     activation="silu", **kw)
        twin = mgs_matmul_exact_fused_plain(xc, wc, fmt, scale=s,
                                            activation="silu", **kw)
        for cut in ((0, 37), (0, 333, 555), (0, 16, 48)):
            edges = list(cut) + [K]
            n0 = LAUNCHES["mgs_matmul_exact_partials"]
            part = sum(mgs_matmul_exact_partials(
                xc[..., a:b].contiguous(), wc[:, a:b].contiguous(), fmt,
                k_offset=a, k_total=K, **kw)
                for a, b in zip(edges[:-1], edges[1:]))
            assert LAUNCHES["mgs_matmul_exact_partials"] == n0 + len(cut)
            got = mgs_matmul_exact_flush(part, fmt, scale=s,
                                         activation="silu")
            torch.cuda.synchronize()
            assert torch.equal(got, one) and torch.equal(one, twin), (fp, cut)


@pytest.mark.parametrize("schedule", ["activation", "weight"])
@pytest.mark.parametrize("M", [4, 16])
def test_b3_partials_and_flush_equal_b3_and_the_twin(dev, M, schedule):
    """B3's partials entry at a decode (4 rows) and a verify (16 rows)
    shape, K cut at offsets off block_k: the pieces' summed partials,
    flushed == one B3 call == the twins; a cut outside K and a stripe over
    the budget raise."""
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_flush, mgs_matmul_exact_partials,
        mgs_matmul_exact_partials_plain)
    K, N = 1000, 600
    xc, wc = _codes((1, M, K), E4M3, 4, dev), _codes((1, K, N), E4M3, 5, dev)
    s = torch.rand(1, 1, N, device=dev) * 1e-2
    for fp in (None, 1, 3):
        kw = dict(block_k=64, flush_period=fp)
        one = mgs_matmul_exact_fused(xc, wc, E4M3, scale=s, schedule=schedule,
                                     activation="silu", **kw)
        twin = mgs_matmul_stationary_plain(xc, wc, E4M3, schedule=schedule,
                                           scale=s, activation="silu", **kw)
        for cut in ((0, 37), (0, 333, 555), (0, 16, 48)):
            edges = list(cut) + [K]
            n0 = LAUNCHES["mgs_matmul_stationary_partials"]
            parts = [mgs_matmul_exact_partials(
                xc[..., a:b].contiguous(), wc[:, a:b].contiguous(), E4M3,
                k_offset=a, k_total=K, schedule=schedule, **kw)
                for a, b in zip(edges[:-1], edges[1:])]
            assert LAUNCHES["mgs_matmul_stationary_partials"] == \
                n0 + len(cut)
            a, b = edges[1], edges[2]
            assert torch.equal(parts[1].cpu(), mgs_matmul_exact_partials_plain(
                xc[..., a:b].cpu(), wc[:, a:b].cpu(), E4M3, k_offset=a,
                k_total=K, schedule=schedule, **kw))
            got = mgs_matmul_exact_flush(sum(parts), E4M3, scale=s,
                                         activation="silu")
            torch.cuda.synchronize()
            assert torch.equal(got, one) and torch.equal(one, twin), (fp, cut)
    with pytest.raises(ValueError, match="outside"):
        mgs_matmul_exact_partials(xc[..., :100], wc[:, :100], E4M3,
                                  k_offset=950, k_total=K, schedule=schedule)
    big = _codes((1, 80, 4000), E4M3, 6, dev)
    with pytest.raises(ValueError, match="stripe"):
        mgs_matmul_exact_partials(big, _codes((1, 4000, 8), E4M3, 7, dev),
                                  E4M3, schedule=schedule)


@pytest.mark.parametrize("M", [1, 4, 16, 70])
@pytest.mark.parametrize("fmt", [E4M3, E3M4])
def test_b4_partials_flushed_equal_b4_b1_and_the_twin(dev, M, fmt):
    """B4's partials entry over cuts of K off block_k (and off 16: the
    plain-load staging path), the pieces' partials summed and B1's flush ==
    one B4 call == B1 == the twins."""
    from repro_torch.kernels.mgs_matmul import (
        mgs_matmul_exact_flush, mgs_matmul_exact_limb_partials,
        mgs_matmul_exact_limb_partials_plain)
    K, N = 1000, 208
    xc, wc = _codes((2, M, K), fmt, 8, dev), _codes((2, K, N), fmt, 9, dev)
    xl = limb_decompose(decode_bits(xc, fmt), fmt).movedim(0, 1).contiguous()
    wl = limb_decompose(decode_bits(wc, fmt), fmt).movedim(0, -3).contiguous()
    for fp in (None, 1, 3):
        kw = dict(block_k=64, flush_period=fp)
        one = mgs_matmul_exact(xl, wl, fmt, **kw)
        b1 = mgs_matmul_exact_fused(xc, wc, fmt, **kw)
        for cut in ((0, 37), (0, 333, 555), (0, 16, 48)):
            edges = list(cut) + [K]
            n0 = LAUNCHES["mgs_matmul_exact_limb_partials"]
            parts = [mgs_matmul_exact_limb_partials(
                xl[..., a:b].contiguous(), wl[..., a:b, :].contiguous(), fmt,
                k_offset=a, k_total=K, **kw)
                for a, b in zip(edges[:-1], edges[1:])]
            assert LAUNCHES["mgs_matmul_exact_limb_partials"] == \
                n0 + len(cut)
            a, b = edges[1], edges[2]
            assert torch.equal(parts[1].cpu(),
                               mgs_matmul_exact_limb_partials_plain(
                                   xl[..., a:b].cpu(), wl[..., a:b, :].cpu(),
                                   fmt, k_offset=a, k_total=K, **kw))
            got = mgs_matmul_exact_flush(sum(parts), fmt)
            torch.cuda.synchronize()
            assert torch.equal(got, one) and torch.equal(one, b1), (fp, cut)


@pytest.mark.parametrize("M", [1, 4, 13, 70])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e3m4"])
def test_b5_partials_and_combine_equal_b5_and_the_twin(dev, M, fmt):
    """B5's partials entry over cuts of K off its 128-code tile, the
    pieces' bins summed and its combine (scale, bias, silu) == one B5 call
    with the dMAC epilogue == the twins, the gate on and off."""
    from repro_torch.kernels.mgs_matmul import (
        ACTIVATIONS, mgs_matmul_dmac_combine, mgs_matmul_dmac_combine_plain,
        mgs_matmul_dmac_partials, mgs_matmul_dmac_partials_plain)
    fmt = get_format(fmt)
    K, N = 700, 197
    xc, wc = _codes((2, M, K), fmt, 10, dev), _codes((2, K, N), fmt, 11, dev)
    s = torch.rand(2, M, 1, device=dev) * 1e-2
    bias = torch.randn(N, device=dev)
    for gate in (True, False):
        one = mgs_matmul_dmac_codes(xc, wc, fmt, gate)
        want = ACTIVATIONS["silu"](one * s + bias)
        for cut in ((0, 37), (0, 129, 300), (0, 16, 48)):
            edges = list(cut) + [K]
            n0 = LAUNCHES["mgs_matmul_dmac_partials"]
            parts = [mgs_matmul_dmac_partials(
                xc[..., a:b].contiguous(), wc[:, a:b].contiguous(), fmt,
                gate, k_offset=a, k_total=K)
                for a, b in zip(edges[:-1], edges[1:])]
            assert LAUNCHES["mgs_matmul_dmac_partials"] == n0 + len(cut)
            a, b = edges[1], edges[2]
            assert torch.equal(parts[1].cpu(), mgs_matmul_dmac_partials_plain(
                xc[..., a:b].cpu(), wc[:, a:b].cpu(), fmt, gate, k_offset=a,
                k_total=K))
            bins = sum(parts)
            n0 = LAUNCHES["mgs_matmul_dmac_combine"]
            got = mgs_matmul_dmac_combine(bins, fmt, scale=s, bias=bias,
                                          activation="silu")
            assert LAUNCHES["mgs_matmul_dmac_combine"] == n0 + 1
            plain = mgs_matmul_dmac_combine_plain(bins, fmt, scale=s,
                                                  bias=bias,
                                                  activation="silu")
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(got, plain), (
                gate, cut)


def test_float_decode_attention_of_a_head_share_is_the_whole_ones(dev):
    """The float path's decode attention over a rank's share of the kv
    heads (``kv_heads=`` the model's: contracted at the whole count, the
    rest zero) == those heads of the whole, bitwise; a share contracted
    alone is the batched GEMV whose bits the card lets follow the batch
    count."""
    from repro_torch.models.attention import _sdpa_dense
    g = torch.Generator().manual_seed(12)
    B, KV, hd, S = 4, 32, 128, 49
    q = (torch.randn(B, 1, KV, 1, hd, generator=g)).to(torch.bfloat16)
    k = (torch.randn(B, S, KV, hd, generator=g)).to(torch.bfloat16)
    v = (torch.randn(B, S, KV, hd, generator=g)).to(torch.bfloat16)
    bias = torch.zeros(B, 1, 1, 1, S)
    q, k, v, bias = (t.to(dev) for t in (q, k, v, bias))
    whole = _sdpa_dense(q, k, v, bias, kv_heads=KV)
    for lo, hi in ((0, 16), (16, 32), (0, 8)):
        share = _sdpa_dense(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                            bias, kv_heads=KV)
        torch.cuda.synchronize()
        assert torch.equal(share, whole[:, :, lo:hi]), (lo, hi)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _shared_card_rank(rank, cfg, params):
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.parallel.comm import rank_device
    return _served(ServeEngine(cfg, batch=2, max_len=24,
                               params=_to(params, rank_device()),
                               device=rank_device(), mesh=make_serve_mesh()))


def _served(eng):
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, eng.cfg.vocab, 8).astype(
        np.int32), max_new_tokens=4) for i in range(4)]
    st = eng.run(reqs, record_logits=True)
    return [r.out_tokens for r in reqs], {
        k: np.stack(v) for k, v in st["logits"].items()}


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_two_ranks_sharing_the_card_equal_the_cpu_run(dev, arch, tmp_path):
    """Tokens equal the CPU's (the twins); logits bitwise one engine on the
    card (the card's float ops are not the CPU's)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import init_params
    from repro_torch.parallel.comm import launch
    from repro_torch.quant import FP8_MGS_SERVE_KV
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32",
                              quant=FP8_MGS_SERVE_KV.replace(block_k=32))
    params = init_params(cfg, 0)
    toks, _ = _served(ServeEngine(cfg, batch=2, max_len=24, params=params,
                                  device="cpu"))
    card_toks, logits = _served(ServeEngine(
        cfg, batch=2, max_len=24, params=_to(params, dev), device=dev))
    assert card_toks == toks
    res = launch(_shared_card_rank, 2, args=(cfg, params), device="cuda",
                 share_device=True, timeout=300.0, store_dir=str(tmp_path))
    for got_toks, got_logits in res:
        assert got_toks == toks
        for k in logits:
            np.testing.assert_array_equal(got_logits[k], logits[k])


def _train_on_card(rank, shape):
    """One rank of a ``shape`` train mesh on the card (``None``: the
    one-card ``grad_accum = 2`` step), deterministic algorithms on: two
    steps of reduced deepseek-7b on a 4 x 16 batch."""
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.comm import rank_device
    from repro_torch.parallel.sharding import train_rules
    from repro_torch.runtime.elastic import reshard
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import flatten_with_paths
    torch.use_deterministic_algorithms(True)
    dev = rank_device()
    cfg = reduced_config("deepseek-7b")
    opt = OptConfig(lr=1e-2, warmup_steps=0, schedule="const")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)).to(dev) for k in ("tokens", "labels")}
    state = init_train_state(init_params(cfg, 0, device=dev))
    mesh = None
    if shape is not None:
        mesh = make_mesh(shape, ("data", "model"))
        state = reshard(state, train_state_specs(cfg, train_rules(mesh)),
                        mesh)
    step = make_train_step(cfg, opt, grad_accum=2 if mesh is None else 1,
                           mesh=mesh)
    ms = []
    for _ in range(2):
        state, m = step(state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, {k: v.float().cpu().numpy() for k, v in
                flatten_with_paths(state).items()}, (
        mesh.coord if mesh is not None else None)


def test_two_ranks_sharing_the_card_train_as_grad_accum_2(dev, tmp_path,
                                                          monkeypatch):
    """A 1x2 train mesh on one card (gloo; batch over model: D = 2) is
    bitwise the one-card ``grad_accum = 2`` step: metrics and each rank's
    slice of the state (each run a process of its own)."""
    from types import SimpleNamespace
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.parallel.comm import launch
    from repro_torch.parallel.sharding import (MeshShape, local_slices,
                                               train_rules)
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import flatten_with_paths
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    (one_ms, one_state, _), = launch(_train_on_card, 1, args=(None,),
                                     device="cuda", share_device=True,
                                     timeout=300.0, store_dir=str(tmp_path))
    res = launch(_train_on_card, 2, args=((1, 2),), device="cuda",
                 share_device=True, timeout=300.0, store_dir=str(tmp_path))
    specs = flatten_with_paths(train_state_specs(
        reduced_config("deepseek-7b"),
        train_rules(MeshShape(("data", "model"), (1, 2)))))
    for ms, state, coord in res:
        assert ms == one_ms
        mesh = SimpleNamespace(shape={"data": 1, "model": 2}, coord=coord)
        for k, w in one_state.items():
            np.testing.assert_array_equal(
                state[k], w[local_slices(specs[k], w.shape, mesh)],
                err_msg=k)
