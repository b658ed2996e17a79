"""Calibration on the port's serving engines: the fourth contract, replay
by calibration-table version (the counterpart of
``tests/test_streaming_calib.py``'s engine suites).

The reduced deepseek-7b at float32 compute, ``block_k=32`` (as the
reference's suite), on the CPU twins.

* ``calibrate()`` against the reference's on the same numpy weights and
  prompts: the same site set, every sigma and the ``attn.q.amax`` within
  1% relative.
* Inside the port, bitwise: the group engine's versioned hot swaps, a swap
  landing mid-group (the group keeps its snapshot), replay of every
  version; the streaming refresh; the continuous engine's fenced,
  plan-changing swap (no torn request, zero drops, late arrivals on the
  new version), a bit-inert swap installed at once, and replay of
  requests on both sides of the fence. ``PREP_STATS`` and the kernel
  builds stay flat.

At these widths every Markov-planned period exceeds K (the plan is never
shorter than the worst case, 5461 K-steps at ``block_k=32``), so under the
real plan the bits of a version move through the static decode-query
scale alone. The ``short`` variant plans 1 or 4 K-steps from each table's
content instead, with the static scale off, so there the bits of a version
move through the runtime flush periods that reach the exact kernels'
twins alone. Refresh factors that are powers of two
scale the static query scale exactly (a bit-inert change), so the swaps
that must move bits use others.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.quant import QuantConfig as RQuantConfig  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import BUILDS  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServeEngine)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.quant import PREP_STATS  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_KV  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread each, so that test workers
    running side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    kw.setdefault("static_q_scale", True)
    quant = FP8_MGS_SERVE_KV.replace(flush_target=1e-6, block_k=32, **kw)
    return dataclasses.replace(reduced_config("deepseek-7b"),
                               compute_dtype="float32", quant=quant)


def _short_plan(self, table):
    """A flush every K-step or every 4 for every site, from the table's
    ``ffn.wd`` sigma (the uncalibrated plan: 4, one flush at K <= 128)."""
    if table is None:
        return {s: 4 for s in self._flush_sites}
    return {s: 1 + 3 * (int(np.log2(table.sigma("ffn.wd")) / 2) % 2)
            for s in self._flush_sites}


class _ShortGroup(ServeEngine):
    _plan_flush_host = _short_plan


class _ShortContinuous(ContinuousBatchingEngine):
    _plan_flush_host = _short_plan


#: plan -> (group engine, continuous engine, static_q_scale): under the
#: short plan the static scale is off, so only flush periods move bits
_ENGINES = {"markov": (ServeEngine, ContinuousBatchingEngine, True),
            "short": (_ShortGroup, _ShortContinuous, False)}


@pytest.fixture(scope="module")
def weights():
    """Seed-0 weights, the residual output projections scaled by 8 so the
    layers move the residual (``tests/test_torch_continuous.py``)."""
    params = init_params(_cfg(), 0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0

    def to_np(t):
        return ({k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
                else t.numpy())

    return to_np(params)


def _requests(rids, plen=12, max_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid, prompt=rng.integers(1, 256, plen).astype(
        np.int32), max_new_tokens=max_new) for rid in rids]


def _logits_of(stats, reqs):
    return {r.rid: [x.copy() for x in stats["logits"][r.rid]] for r in reqs}


def _bitwise(got, want):
    return len(got) == len(want) and all(
        a.tobytes() == b.tobytes() for a, b in zip(got, want))


def _flat():
    return dict(PREP_STATS), dict(BUILDS)


def test_calibrate_matches_reference(weights):
    """One recording pass over the same prompts in both packages: the
    reference's site set, sigmas and decode-query amax within 1%."""
    cfg = _cfg()
    prompts = [np.random.default_rng(3).integers(1, 256, 16).astype(np.int32)
               for _ in range(2)]
    eng = ServeEngine(cfg, batch=2, max_len=64,
                      params=params_from_numpy(weights), device="cpu")
    got = eng.calibrate(prompts, update=False)
    rcfg = dataclasses.replace(
        r_reduced("deepseek-7b"), compute_dtype="float32",
        quant=RQuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                           kv_cache="packed", flush_target=1e-6,
                           static_q_scale=True, block_m=32, block_n=32,
                           block_k=32))
    reng = RServeEngine(rcfg, make_mesh((1, 1), ("data", "model")), batch=2,
                        max_len=64, params=jax.tree.map(jnp.asarray,
                                                        weights))
    want = reng.calibrate(prompts, update=False)
    assert [s for s, _ in got.to_pairs()] == [s for s, _ in want.to_pairs()]
    assert {s for s, _ in got.to_pairs()} >= {
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wg", "ffn.wu",
        "ffn.wd", "logits", "attn.scores", "attn.values", "attn.q.amax"}
    for (s, a), (_, b) in zip(got.to_pairs(), want.to_pairs()):
        assert a == pytest.approx(b, rel=1e-2), s
    assert eng.table_version == 0 and not eng._tables


class _SwapAtDecode:
    """Injector-shaped probe: a swap at a decode step inside a group."""

    def __init__(self, engine, table, step):
        self.engine, self.table, self.step = engine, table, step
        self.fired = False

    def before_group(self):
        pass

    def on_decode(self, step):
        if step == self.step and not self.fired:
            self.fired = True
            self.engine.apply_calibration(self.table)


@pytest.mark.parametrize("plan", list(_ENGINES))
def test_group_engine_versioned_hot_swap_and_replay(weights, plan):
    group, _, static = _ENGINES[plan]
    eng = group(_cfg(static_q_scale=static), batch=2, max_len=64,
                params=params_from_numpy(weights), device="cpu")
    eng.warmup([16], max_new=2)
    flat = _flat()

    r0 = _requests([0, 1], seed=0)
    l0 = _logits_of(eng.run(r0, record_logits=True), r0)
    assert [r.table_version for r in r0] == [0, 0]

    t1 = eng.calibrate()
    assert eng.table_version == 1 and (eng._amax_value > 0.0) == static
    r1 = _requests([2, 3], seed=1)
    l1 = _logits_of(eng.run(r1, record_logits=True), r1)
    assert [r.table_version for r in r1] == [1, 1]
    # the versions differ in bits: r0 replayed under v1 is not r0's run
    _, moved = eng.replay(r0[0], version=1, group=r0)
    assert not _bitwise(moved["logits"][0], l0[0])

    t2 = t1.refreshed([(s, v * 1.5) for s, v in t1.to_pairs()])
    assert eng.apply_calibration(t2) == 2
    r2 = _requests([4, 5], seed=2)
    eng.run(r2)
    assert [r.table_version for r in r2] == [2, 2]
    t3 = t2.refreshed([(s, v * 0.5) for s, v in t2.to_pairs()])
    assert eng.apply_calibration(t3) == 3

    # a mid-group swap lands at the next group: the group keeps its
    # snapshotted state and stamp
    t4 = t3.refreshed([(s, v * 5.0) for s, v in t3.to_pairs()])
    r4 = _requests([8, 9], seed=4)
    probe = _SwapAtDecode(eng, t4, step=2)
    l4 = _logits_of(eng.run(r4, record_logits=True, injector=probe), r4)
    assert probe.fired and eng.table_version == 4
    assert [r.table_version for r in r4] == [3, 3]
    _, moved = eng.replay(r4[0], version=4, group=r4)
    assert not _bitwise(moved["logits"][8], l4[8])

    # every retained version replays its logged bits, the torn group too
    for reqs, logged in ((r0, l0), (r1, l1), (r4, l4)):
        for r in reqs:
            rep, st = eng.replay(r, group=reqs)
            assert rep.out_tokens == r.out_tokens
            assert _bitwise(st["logits"][r.rid], logged[r.rid])
    assert eng.table_version == 4          # replay never moves the head
    with pytest.raises(KeyError):
        eng.replay(r1[0], version=99, group=r1)
    with pytest.raises(ValueError):
        eng.replay(r1[0])                  # per-tensor scales need the group
    assert _flat() == flat


def test_group_engine_streaming_refresh(weights):
    eng = _ShortGroup(_cfg(), batch=2, max_len=64,
                      params=params_from_numpy(weights), device="cpu")
    eng.warmup([16], max_new=2)
    eng.calibrate()
    flat = _flat()
    cal = eng.enable_streaming(seed=5, sample_period=2, sigma_rtol=0.0,
                               min_calls=1)
    r1 = _requests([0, 1, 2, 3], seed=0)
    l1 = _logits_of(eng.run(r1, record_logits=True), r1)
    # two groups, gate (index + 5) % 2: the second group was shadowed
    assert eng._stream_index == 2
    assert any(cal.recorder.calls(s) for s in cal.recorder.sites)
    report = eng.maybe_refresh_calibration()
    assert report is not None and eng.table_version == 2
    assert cal.table.version == 2 and eng._tables[2] is cal.table
    r2 = _requests([4, 5], seed=1)
    eng.run(r2)
    assert [r.table_version for r in r2] == [2, 2]
    calls = {s: cal.recorder.calls(s) for s in cal.recorder.sites}
    rep, st = eng.replay(r1[0], group=r1[:2])
    assert _bitwise(st["logits"][0], l1[0])
    # replay is muted and ungated
    assert {s: cal.recorder.calls(s) for s in cal.recorder.sites} == calls
    assert eng._stream_index == 3
    cal.sigma_rtol = 10.0
    cal.tv_threshold = cal.amax_rtol = 10.0
    assert eng.maybe_refresh_calibration() is None
    assert eng.table_version == 2
    assert _flat() == flat


@pytest.mark.parametrize("plan", list(_ENGINES))
def test_continuous_engine_fenced_swap_and_straddling_replay(weights, plan):
    _, continuous, static = _ENGINES[plan]
    eng = continuous(_cfg(per_row_act=True, static_q_scale=static), slots=2,
                     max_len=64, params=params_from_numpy(weights),
                     device="cpu")
    eng.warmup([8, 16], max_new=2)
    flat = _flat()
    rng = np.random.default_rng(1)

    def mk(rid, n=10, m=4):
        return Request(rid=rid, prompt=rng.integers(1, 256, n).astype(
            np.int32), max_new_tokens=m)

    r0 = [mk(0), mk(1)]
    l0 = _logits_of(eng.serve(r0, record_logits=True), r0)
    assert [r.table_version for r in r0] == [0, 0]

    t1 = eng.calibrate()
    # the versioned static q scale
    assert (eng._amax_value > 0.0) == static
    r1 = [mk(2), mk(3)]
    l1 = _logits_of(eng.serve(r1, record_logits=True), r1)
    assert [r.table_version for r in r1] == [1, 1]
    # the versions differ in bits: under v1 some request of r0 moves (one
    # row's sums are often exact in float32 at these widths, where a
    # flush period cannot move them)
    assert not all(_bitwise(eng.replay(r, version=1)[1]["logits"][r.rid],
                            l0[r.rid]) for r in r0)

    # a plan-changing swap mid-traffic fences: the residents finish on v1,
    # the late arrivals are admitted on v2, nothing is dropped
    t2 = t1.refreshed([(s, v * 4.0) for s, v in t1.to_pairs()])
    assert eng._plan_flush_host(t2) != eng._flush_host
    if plan == "short":
        assert eng._flush_host["ffn.wd"] == 1
    state = {"round": 0, "late": None, "fenced": None}

    def feed():
        state["round"] += 1
        if state["round"] == 3:
            eng.apply_calibration(t2)
            state["fenced"] = eng._pending is not None
            state["late"] = [mk(10, 9, 3), mk(11, 10, 3)]
            return state["late"]
        return []

    resident = [mk(4, 12, 5), mk(5, 11, 5)]
    s2 = eng.serve(resident, record_logits=True, feed=feed)
    late = state["late"]
    assert state["fenced"] is True
    assert all(len(r.out_tokens) == r.max_new_tokens
               for r in resident + late)
    assert [r.table_version for r in resident] == [1, 1]
    assert [r.table_version for r in late] == [2, 2]
    assert eng._pending is None and eng.table_version == 2
    li = _logits_of(s2, resident + late)

    # a bit-inert swap (same content, new version) installs at once
    t3 = t2.refreshed([])
    assert t3.content_hash == t2.content_hash
    eng._serving = True                    # as if called mid-serve
    try:
        assert eng.apply_calibration(t3) == 3
    finally:
        eng._serving = False
    assert eng._pending is None

    # every era replays bitwise: before calibration, v1, both sides of
    # the fence
    for req, logged in ((r0[0], l0[0]), (r1[0], l1[2]),
                        (resident[0], li[4]), (late[0], li[10])):
        rep, st = eng.replay(req)
        assert rep.out_tokens == req.out_tokens
        assert _bitwise(st["logits"][req.rid], logged)
    assert eng.table_version == 3
    assert _flat() == flat
