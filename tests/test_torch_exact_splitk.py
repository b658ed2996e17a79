"""The exactness argument of B1's and B4's split-K, on the CPU.

At decode the card cuts K across blocks (``split_plan``): no split crosses
a flush boundary, each split's int32 class partials are added into its
segment's workspace slice in whatever order the blocks arrive, and the
last split flushes the segments in ascending order. A plain model of that
reduction, built on the twin's own ``_accumulate_classes`` /
``_flush_classes``, sums the partials in a shuffled order and must give
the bits of both twins (``mgs_matmul_exact_fused_plain``,
``mgs_matmul_exact_plain``) and, at one shape with several segments, of
the reference's Pallas kernel in interpret mode.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_matmul import mgs_matmul_exact_pallas  # noqa: E402

from repro_torch.core.formats import (E4M3, decode_bits,  # noqa: E402
                                      encode_bits, round_to_format)
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    SplitPlan, limb_decompose, mgs_matmul_exact_fused_plain,
    mgs_matmul_exact_plain, split_plan, split_ranges)

tmm = importlib.import_module("repro_torch.kernels.mgs_matmul")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of tiny matmuls: one intra-op thread each, so that test
    workers running side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 40
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    return encode_bits(round_to_format(torch.from_numpy(x), E4M3), E4M3)


def _limbs64(limbs):
    """(Bt, 3, R, C) int8 limb planes -> 3 float64 (Bt, R, C) planes."""
    return [limbs[:, a].to(torch.float64) for a in range(3)]


def _split_model(x_limbs, w_limbs, K, plan, seed):
    """The kernel's split reduction over (Bt, 3, M, K) / (Bt, 3, K, N) limb
    planes: per-split int32 class partials, summed per segment in a
    shuffled order (wrapping modulo 2^32 like the workspace's atomic
    adds), then flushed segment by segment in ascending order."""
    lx, lw = _limbs64(x_limbs), _limbs64(w_limbs)
    seg_len = 32 * plan.segment
    nseg = -(-K // seg_len)
    parts = [[] for _ in range(nseg)]
    for k0, k1 in split_ranges(plan, K):
        if k0 == k1:
            continue
        seg = k0 // seg_len
        acc = [torch.zeros(lx[0].shape[:-1] + lw[0].shape[-1:],
                           dtype=torch.float64)] * 5
        tmm._accumulate_classes(acc, [l[..., k0:k1] for l in lx],
                                [l[..., k0:k1, :] for l in lw])
        parts[seg].append([tmm._class_int32(c) for c in acc])
    rng = np.random.default_rng(seed)
    tot = torch.zeros(lx[0].shape[:-1] + lw[0].shape[-1:],
                      dtype=torch.float32)
    for seg in range(nseg):
        sums = [torch.zeros_like(tot, dtype=torch.int64)] * 5
        for i in rng.permutation(len(parts[seg])):
            sums = [s + p.to(torch.int64) for s, p in zip(sums, parts[seg][i])]
        tot = tmm._flush_classes(sums, tot)
    return tot


def _check_ranges(plan, K):
    """The splits cover K exactly, in order, and none crosses a flush
    boundary."""
    seg_len = 32 * plan.segment
    ranges = [r for r in split_ranges(plan, K) if r[0] < r[1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 // seg_len == (k1 - 1) // seg_len, (k0, k1, seg_len)


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("flush_period", [None, 1, 2])
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("K", [300, 4100])
@pytest.mark.parametrize("layout", ["one slice", "two slices", "shared w"])
def test_split_reduction_equals_both_twins(layout, K, block_k, flush_period,
                                           M):
    Bt, N = (1, 70) if layout == "one slice" else (2, 70)
    xc = _codes((Bt, M, K), 1 + M)
    wc = _codes((1 if layout == "shared w" else Bt, K, N), 2 + K)
    plan = split_plan(Bt, M, K, N, block_k, flush_period)
    assert plan.splits > 1            # these decode shapes split K
    _check_ranges(plan, K)
    xl = limb_decompose(decode_bits(xc, E4M3)).movedim(0, 1)
    wl = limb_decompose(decode_bits(wc, E4M3)).movedim(0, 1)
    model = _split_model(xl, wl, K, plan, seed=K + M) * tmm.out_scale(E4M3)

    x_in = xc[0] if layout == "one slice" else xc
    w_in = wc[0] if layout != "two slices" else wc
    kw = dict(block_k=block_k, flush_period=flush_period)
    b1 = mgs_matmul_exact_fused_plain(x_in, w_in, E4M3, **kw)
    b4 = mgs_matmul_exact_plain(xl[0] if layout == "one slice" else xl,
                                wl[0] if layout != "two slices" else wl,
                                E4M3, **kw)
    want = model[0] if layout == "one slice" else model
    assert torch.equal(b1, want)
    assert torch.equal(b4, want)
    if layout != "two slices" or M != 4:
        return
    # the fused epilogue runs once, after the last flush
    s = torch.rand(N, generator=torch.Generator().manual_seed(K)) * 1e-2
    b = torch.randn(N, generator=torch.Generator().manual_seed(M))
    fused = mgs_matmul_exact_fused_plain(x_in, w_in, E4M3, scale=s, bias=b,
                                         activation="silu", **kw)
    assert torch.equal(fused, tmm.ACTIVATIONS["silu"](want * s + b))


def test_split_plan_at_the_serving_shapes():
    # decode: the 128-column tiles cut K into one wave of 2 blocks per SM
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        p = split_plan(1, 4, K, N, 128, None)
        tiles = -(-N // 128)
        assert p.splits > 1 and p.per_segment == p.splits
        assert 264 - tiles < tiles * p.splits <= 264
        _check_ranges(p, K)
    # the logits head fills the card with tiles; prefill never splits
    assert split_plan(1, 4, 4096, 102400, 128, None).splits == 1
    assert split_plan(1, 64, 4096, 4096, 128, None).splits == 1
    assert split_plan(1, 17, 4096, 4096, 128, None).splits == 1
    # verify rows split like decode
    assert split_plan(1, 16, 4096, 4096, 128, None) == split_plan(
        1, 4, 4096, 4096, 128, None)
    # one split per segment once segments alone fill the card
    p = split_plan(1, 4, 4096, 11008, 128, 1)
    assert p == SplitPlan(32, 1, 4, 4)
    assert split_ranges(p, 4096)[5] == (640, 768)
    # every split is at least 4 units long, unless its segment is shorter
    p = split_plan(1, 1, 300, 8, 64, 1)
    assert p.segment == 2 and p.run == 4 and p.per_segment == 1
    _check_ranges(p, 300)


def test_split_reduction_equals_the_reference_kernel():
    """Several segments (K = 300, block_k 64, flush_period 2: 3 segments),
    against mgs_matmul_exact_pallas in interpret mode."""
    M, K, N, block_k, fp = 4, 300, 24, 64, 2
    xc, wc = _codes((1, M, K), 7), _codes((1, K, N), 8)
    xv, wv = decode_bits(xc, E4M3)[0], decode_bits(wc, E4M3)[0]
    plan = split_plan(1, M, K, N, block_k, fp)
    assert plan.splits // plan.per_segment == 3
    model = _split_model(limb_decompose(xv)[None], limb_decompose(wv)[None],
                         K, plan, seed=3)[0] * tmm.out_scale(E4M3)
    ref = np.asarray(mgs_matmul_exact_pallas(
        jnp.asarray(xv.numpy()), jnp.asarray(wv.numpy()), rf.E4M3,
        block_m=8, block_n=8, block_k=block_k, flush_period=fp,
        interpret=True))
    np.testing.assert_array_equal(model.numpy(), ref)
