"""B3's plan and the exactness of its split reduction, on the CPU.

On the card B3 (``mgs_matmul_exact_fused(schedule="weight" |
"activation")``) keeps its cached operand's limb fragments resident for
each block's part of K and sweeps the other operand's tiles
(``stationary_plan``, mirrored line for line in ``csrc/mgs_matmul.cu``).
Here: at every B3 shape of ``chip_smoke.py``, in both schedules and at
three flush periods, a shape the admission rule takes gets a plan whose
splits cover K without crossing a flush boundary and whose blocks fit in
shared memory (ring, fragments, table and resident stripe), and a shape it
refuses falls back. Then a plain model of the kernel's reduction, block by
block in a shuffled order over the plan's tiles and K ranges, per-split
int32 class partials summed per segment and the segments flushed in
ascending order, must give the bits of the stationary twin and, at one
small ragged shape, of the reference's Pallas kernel in interpret mode.
"""

import importlib
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_matmul import \
    mgs_matmul_exact_fused_pallas  # noqa: E402

from repro_torch.core.formats import (E4M3, decode_bits,  # noqa: E402
                                      encode_bits, round_to_format)
from repro_torch.kernels import _cuda, ops  # noqa: E402

tmm = importlib.import_module("repro_torch.kernels.mgs_matmul")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
B3_SHAPES = _CS.B3_DECODE + _CS.B3_OTHER


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small matmuls: one intra-op thread each, so that test workers
    running side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 40
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    return encode_bits(round_to_format(torch.from_numpy(x), E4M3), E4M3)


def _check_ranges(plan, K):
    """The splits cover K exactly, in order, none longer than the plan's
    run and none crossing a flush boundary."""
    seg_len = 32 * plan.segment
    ranges = [r for r in tmm.split_ranges(plan, K) if r[0] < r[1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k1 - k0 <= 32 * plan.run
        if plan.splits > 1:
            assert k0 // seg_len == (k1 - 1) // seg_len, (k0, k1, seg_len)


def _sweep(plan, schedule, M, N):
    """(cached tiles, swept tiles) of the kernel's grid."""
    bm, bn = tmm.exact_tile(M)
    mt, nt = -(-M // bm), -(-N // bn)
    return (nt, mt) if schedule == "weight" else (mt, nt)


@pytest.mark.parametrize("flush_period", [None, 1, 2])
@pytest.mark.parametrize("schedule", ["activation", "weight"])
@pytest.mark.parametrize("shape", B3_SHAPES, ids=[s[0] for s in B3_SHAPES])
def test_plan_at_the_chip_smoke_shapes(shape, schedule, flush_period):
    name, Bt, M, K, N = shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        route = ops._fused_schedule(schedule, M, K, 128)
    if name.startswith("decode") and schedule == "activation":
        assert route == schedule        # the continuous decode path's B3
    if route != schedule:               # refused by the admission rule
        with pytest.raises(ValueError, match="shared-memory budget"):
            tmm.check_stripe(schedule, M, K, 128)
        return
    plan = tmm.stationary_plan(Bt, M, K, N, 128, flush_period, schedule)
    _check_ranges(plan, K)
    fp = tmm.flush_steps(flush_period, 128, -(-K // 128))
    assert plan.segment == fp * 4
    # each block's part of the stripe beside its ring, stage fragments and
    # table: in half an SM at decode (two blocks share one), else the opt-in
    fixed, lines, minb = tmm._stationary_layout(M, N, schedule)
    assert plan.lines == lines and lines >= 1
    assert plan.smem_bytes == fixed + 3 * 32 * plan.run * lines
    assert plan.smem_bytes <= (tmm._PAIR_BYTES if minb == 2
                               else tmm._STAT_BYTES) < _cuda.SMEM_LIMIT
    # the sweep groups cover the swept tiles, none empty; a block sweeps
    # more than one tile only where one tile a block would overfill the SMs
    cached, sweep = _sweep(plan, schedule, M, N)
    assert plan.groups * plan.tiles_per_group >= sweep
    assert (plan.groups - 1) * plan.tiles_per_group < sweep
    if plan.tiles_per_group > 1:
        assert Bt * cached * plan.splits * sweep > minb * 132


def test_plan_at_the_decode_shapes():
    """The continuous decode step's four activation-stationary shapes: the
    4 live rows take 12 bytes of stripe per K element, the resident part
    fits beside the ring of two blocks per SM, and wq / wg-wu / wd split
    like B1 while the head (800 tiles) sweeps 10 tiles a block."""
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        p = tmm.stationary_plan(1, 4, K, N, 128, None, "activation")
        assert p.lines == 4 and p.tiles_per_group == 1
        assert (p.splits, p.per_segment) == tuple(
            tmm.split_plan(1, 4, K, N, 128, None)[:2])
        assert p.smem_bytes <= tmm._PAIR_BYTES
    head = tmm.stationary_plan(1, 4, 4096, 102400, 128, None, "activation")
    assert head == tmm.StationaryPlan(3, 3, 43, 128, 80, 10, 4, 111744)
    # the 16-row verify stripe at K = 4096 (196 KB whole) fits in tenths
    verify = tmm.stationary_plan(1, 16, 4096, 4096, 128, None, "activation")
    assert verify.lines == 16 and verify.splits == 10
    assert verify.smem_bytes <= tmm._PAIR_BYTES
    # the prefill score / value stripes of 64 rows, K = 1024, split in two
    values = tmm.stationary_plan(32, 64, 1024, 128, 128, None, "activation")
    assert values.splits == 2 and values.smem_bytes <= _cuda.SMEM_LIMIT


def _model(xc, wc, plan, schedule, block_k, seed):
    """B3's reduction, block by block as the card's grid runs it: each
    block (slice, cached tile, split, sweep group) walks its swept tiles
    over its K range and adds each flush segment's int32 class partials
    into that segment's workspace (wrapping like the atomic adds), in a
    shuffled block order; then every tile flushes its segments in
    ascending order."""
    Bt, M, K = xc.shape
    N = wc.shape[-1]
    lx = [l.to(torch.float64) for l in tmm._decode_limbs(xc, E4M3)]
    lw = [l.to(torch.float64) for l in tmm._decode_limbs(wc, E4M3)]
    bm, bn = tmm.exact_tile(M)
    cached, sweep = _sweep(plan, schedule, M, N)
    seg_len = 32 * plan.segment
    nseg = -(-K // seg_len)
    ws = torch.zeros((nseg, 5, Bt, M, N), dtype=torch.int64)
    blocks = [(b, c, s, g) for b in range(Bt) for c in range(cached)
              for s in range(plan.splits) for g in range(plan.groups)]
    ranges = tmm.split_ranges(plan, K)
    for i in np.random.default_rng(seed).permutation(len(blocks)):
        b, c, s, g = blocks[i]
        k0, k1 = ranges[s]
        for t in range(g * plan.tiles_per_group,
                       min(sweep, (g + 1) * plan.tiles_per_group)):
            mt, nt = (t, c) if schedule == "weight" else (c, t)
            ms = slice(mt * bm, min(M, (mt + 1) * bm))
            ns = slice(nt * bn, min(N, (nt + 1) * bn))
            for a0 in range(k0, k1, seg_len):     # one block walks all K
                a1 = min(k1, (a0 // seg_len + 1) * seg_len)
                acc = [torch.zeros((ms.stop - ms.start, ns.stop - ns.start),
                                   dtype=torch.float64)] * 5
                tmm._accumulate_classes(
                    acc, [l[b % l.shape[0], ms, a0:a1] for l in lx],
                    [l[b % l.shape[0], a0:a1, ns] for l in lw])
                for cl in range(5):
                    ws[a0 // seg_len, cl, b, ms, ns] += tmm._class_int32(
                        acc[cl]).to(torch.int64)
    tot = torch.zeros((Bt, M, N), dtype=torch.float32)
    for seg in range(nseg):
        tot = tmm._flush_classes([ws[seg, cl].to(torch.int32)
                                  for cl in range(5)], tot)
    return tot * tmm.out_scale(E4M3)


# small ragged shapes: K split with ragged segments (decode and prefill
# tiles, both schedules); blocks sweeping several tiles, each walking all
# of K (flush_period None) or split at the flush boundaries
MODEL_SHAPES = [
    ("decode ragged", (2, 4, 300, 197), ("activation", "weight")),
    ("prefill ragged", (1, 70, 300, 197), ("activation", "weight")),
    ("decode sweep", (1, 4, 128, 128 * 300), ("activation",)),
    ("prefill sweep", (1, 192, 128, 64 * 50), ("activation",)),
    ("weight sweep", (1, 64 * 40, 96, 256), ("weight",)),
]
MODEL_CASES = [(name, shape, schedule, fp)
               for name, shape, schedules in MODEL_SHAPES
               for schedule in schedules
               for fp in ((None, 1, 2) if "ragged" in name else (None, 1))]


@pytest.mark.parametrize("name,shape,schedule,flush_period", MODEL_CASES,
                         ids=[f"{c[0]}-{c[2]}-fp{c[3]}" for c in MODEL_CASES])
def test_split_model_equals_the_stationary_twin(name, shape, schedule,
                                                flush_period):
    Bt, M, K, N = shape
    block_k = 128 if flush_period is None else 64
    plan = tmm.stationary_plan(Bt, M, K, N, block_k, flush_period, schedule)
    if "sweep" in name:
        assert plan.tiles_per_group > 1
    assert (plan.splits == 1) == ("sweep" in name and flush_period is None)
    _check_ranges(plan, K)
    xc = _codes((Bt, M, K), 1 + M)
    wc = _codes((Bt, K, N), 2 + K)
    model = _model(xc, wc, plan, schedule, block_k, seed=K + M)
    kw = dict(block_k=block_k, flush_period=flush_period)
    twin = tmm.mgs_matmul_stationary_plain(xc, wc, E4M3, schedule=schedule,
                                           **kw)
    assert torch.equal(twin, model)
    if name != "decode ragged" or flush_period != 1:
        return
    # the fused epilogue runs once, after the last segment's flush
    s = torch.rand(N, generator=torch.Generator().manual_seed(K)) * 1e-2
    b = torch.randn(N, generator=torch.Generator().manual_seed(M))
    fused = tmm.mgs_matmul_stationary_plain(xc, wc, E4M3, schedule=schedule,
                                            scale=s, bias=b,
                                            activation="silu", **kw)
    assert torch.equal(fused, tmm.ACTIVATIONS["silu"](model * s + b))


@pytest.mark.parametrize("schedule", ["activation", "weight"])
def test_split_model_equals_the_reference_kernel(schedule):
    """Three flush segments split across blocks (M = 4, K = 300, block_k
    64, flush_period 2), against the reference's
    mgs_matmul_exact_fused_pallas in interpret mode."""
    M, K, N, block_k, fp = 4, 300, 24, 64, 2
    xc, wc = _codes((1, M, K), 7), _codes((1, K, N), 8)
    plan = tmm.stationary_plan(1, M, K, N, block_k, fp, schedule)
    assert plan.splits // plan.per_segment == 3
    model = _model(xc, wc, plan, schedule, block_k, seed=3)[0]
    xv, wv = decode_bits(xc, E4M3)[0], decode_bits(wc, E4M3)[0]
    ref = np.asarray(mgs_matmul_exact_fused_pallas(
        jnp.asarray(rf.encode_bits(jnp.asarray(xv.numpy()), rf.E4M3)),
        jnp.asarray(rf.encode_bits(jnp.asarray(wv.numpy()), rf.E4M3)),
        rf.E4M3, schedule=schedule, block_m=8, block_n=8, block_k=block_k,
        flush_period=fp, interpret=True))
    np.testing.assert_array_equal(model.numpy(), ref)
