"""Port parity for calibration's modules: ``core.markov``,
``quant.calibrate``, ``quant.streaming``, the static decode-query scale,
the flush-period resolution of ``qmatmul`` and ``PreparedWeight``'s limb
sigma.

Same inputs (numpy seeds) through both packages. Compared with ``==``: the
Markov analysis and planners (a numpy copy), the sampling gate, recorder
histograms, tables, content hashes and versions, the streaming EMA and
drift reports, ``observe``'s histogram of the same quantized values, the
decode-query codes and scales (scalar amax, a per-slot vector with ``<= 0``
entries, the flag off) and ``qmatmul``'s bits at explicit flush periods
1 / 2 / 3 and under ``flush_target``. ``limb_sigma`` is the std of the
same limb values, taken in float64 from a histogram: equal to the float64
std of the reference's limb values, and within ``5e-5`` of the
reference's float32 reduction.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.core import markov as rm  # noqa: E402
from repro.models.attention import _quantize_decode_q as r_qdq  # noqa: E402
from repro.quant import calibrate as rc  # noqa: E402
from repro.quant import config as rq  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402
from repro.quant import streaming as rs  # noqa: E402
from repro.quant.qmatmul import qmatmul as r_qmatmul  # noqa: E402

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.core import markov as tm  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    _quantize_decode_q as t_qdq)
from repro_torch.quant import calibrate as tc  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant import streaming as ts  # noqa: E402
from repro_torch.quant.qmatmul import qmatmul  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread each, so that test workers
    running side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# core.markov (the cases of tests/test_markov.py)
# ---------------------------------------------------------------------------


def _pmf_eq(a, b):
    assert a.lo == b.lo
    np.testing.assert_array_equal(a.probs, b.probs)


def test_markov_analysis_equals_reference():
    for m in (rm, tm):
        assert m.__all__ == rm.__all__
    k = np.array([1, 10, 100, 1000])
    np.testing.assert_array_equal(tm.clt_overflow_prob(k, 10, 105.0),
                                  rm.clt_overflow_prob(k, 10, 105.0))
    for a in (8, 10, 12, 16, 24):
        assert float(tm.clt_overflow_prob(10, a, 105.0)) == float(
            rm.clt_overflow_prob(10, a, 105.0))
    pmfs = {}
    for m in (rm, tm):
        pw = m.gaussian_quantized_pmf(5)
        px = m.gaussian_quantized_pmf(7, half=True)
        pp = m.product_pmf(pw, px)
        p4 = m.product_pmf(m.gaussian_quantized_pmf(4),
                           m.gaussian_quantized_pmf(4))
        pmfs[m] = dict(
            pw=pw, px=px, pp=pp, p4=p4,
            clip=m.product_pmf(pw, px, max_abs=200),
            exp=m.expected_sums_before_overflow(pp, 10),
            abs5=m.absorption_prob_after_k(p4, 8, 5),
            abs50=m.absorption_prob_after_k(p4, 8, 50),
            tm=m.transition_matrix(m.gaussian_quantized_pmf(4), 6),
            sim=m.simulate_walk(p4, 8, n_trials=40, max_steps=3000, seed=3),
            moments=(pp.mean, pp.std, pp.hi),
            sample=pp.sample(np.random.default_rng(1), 64))
    r, t = pmfs[rm], pmfs[tm]
    for key in ("pw", "px", "pp", "p4", "clip"):
        _pmf_eq(t[key], r[key])
    for key in ("exp", "abs5", "abs50", "moments"):
        assert t[key] == r[key]
    for a, b in zip(t["tm"], r["tm"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t["sim"], r["sim"])
    np.testing.assert_array_equal(t["sample"], r["sample"])
    vals = np.random.default_rng(0).integers(-20, 21, 5000)
    _pmf_eq(tm.empirical_pmf(vals), rm.empirical_pmf(vals))


def test_markov_planners_equal_reference():
    for sp, target in ((30.0, 1e-4), (105.0, 1e-6), (5.0, 1e-3)):
        assert tm.plan_chunk_length_clt(10, sp, target) == \
            rm.plan_chunk_length_clt(10, sp, target)
    assert tm.plan_chunk_length_worst_case(64 * 64, 32) == \
        rm.plan_chunk_length_worst_case(64 * 64, 32)
    assert tm.limb_sigma_default() == rm.limb_sigma_default()
    assert tm.limb_sigma_default(5) == rm.limb_sigma_default(5)
    for block_k in (32, 64, 128):
        for target in (None, 1e-9, 1e-6, 1e-3):
            for sx in (None, 5.0, 36.9, 80.0):
                for sw in (None, 5.0, 36.9, 80.0):
                    kw = dict(target_overflow=target, sigma_limb_x=sx,
                              sigma_limb_w=sw)
                    assert tm.plan_flush_period(block_k, **kw) == \
                        rm.plan_flush_period(block_k, **kw), (block_k, kw)
    with pytest.raises(ValueError):
        tm.plan_flush_period(128, target_overflow=0.0)


def test_sample_gate_equals_reference():
    for seed in (0, 3, 7, 123):
        for period in (0, 1, 2, 4, 5):
            got = [ts.sample_gate(seed, i, period) for i in range(64)]
            assert got == [rs.sample_gate(seed, i, period)
                           for i in range(64)]


# ---------------------------------------------------------------------------
# recorders, tables, streaming (the streams of tests/test_streaming_calib.py)
# ---------------------------------------------------------------------------


def _limb_stream(rng, n, lo=-12, hi=13):
    return rng.integers(lo, hi, n).astype(np.int64)


def _tables_equal(a, b):
    assert a.to_pairs() == b.to_pairs()
    assert a.content_hash == b.content_hash
    assert a.version == b.version
    assert repr(a) == repr(b)


def test_recorder_tables_hashes_and_versions_equal_reference():
    rng = np.random.default_rng(0)
    recs = (rc.ActivationRecorder(), tc.ActivationRecorder())
    for i in range(12):
        site = ("ffn.wg", "attn.scores", "logits")[i % 3]
        limbs = _limb_stream(rng, 300, -64 + i, 40 - i)
        for r in recs:
            r.record(site, limbs)
            r.record_amax("attn.q", float(i) * 0.7)
    r, t = recs
    assert t.sites == r.sites
    for s in r.sites:
        assert t.calls(s) == r.calls(s)
        _pmf_eq(t.pmf(s), r.pmf(s))
    _tables_equal(t.table(), r.table())
    t1 = tc.CalibrationTable.from_pairs(t.table().to_pairs(), version=1)
    r1 = rc.CalibrationTable.from_pairs(r.table().to_pairs(), version=1)
    _tables_equal(t1, r1)
    upd = [("ffn.wg", 3.5), ("new.site", 1.25)]
    _tables_equal(t1.refreshed(upd), r1.refreshed(upd))
    _tables_equal(t1.refreshed([]), r1.refreshed([]))
    _tables_equal(t1.refreshed(upd, version=9), r1.refreshed(upd, version=9))
    assert t1.refreshed([]).content_hash == t1.content_hash
    for site in ("ffn.wg", "missing"):
        assert t1.flush_period(site, 32, target_overflow=1e-6,
                               sigma_limb_w=20.0) == r1.flush_period(
            site, 32, target_overflow=1e-6, sigma_limb_w=20.0)
    for rec in (tc.ActivationRecorder(), ts.StreamingRecorder()):
        with pytest.raises(ValueError):
            rec.record("q", np.full(4, tc._LIMB_LO + tc._N_LEVELS))


def _streams():
    """The reference suite's streams: stationary, narrow then wide,
    degenerate, and the 2x-stale refresh."""
    rng = np.random.default_rng(1)
    out = [("s", _limb_stream(rng, 512)) for _ in range(30)]
    out += [("s", _limb_stream(rng, 512, -3, 4)) for _ in range(20)]
    out += [("s", _limb_stream(rng, 512, -40, 41)) for _ in range(20)]
    out += [("c", np.full(64, 5, np.int64)) for _ in range(5)]
    return out


def test_streaming_recorder_and_drift_equal_reference():
    recs = (rs.StreamingRecorder(decay=0.9), ts.StreamingRecorder(decay=0.9))
    stream = _streams()
    for i, (site, limbs) in enumerate(stream):
        for r in recs:
            r.record(site, limbs)
            r.record_amax(site, 1.0 + (i % 7) * 0.25)
        if i == 40:
            for r in recs:
                r.muted = True
                r.record("s", limbs[:8])
                r.record_amax("s", 100.0)
                r.muted = False
    r, t = recs
    assert t.sites == r.sites
    for s in r.sites:
        assert t.calls(s) == r.calls(s)
        _pmf_eq(t.pmf(s), r.pmf(s))
    assert t._amax == r._amax
    _tables_equal(t.table(), r.table())

    rng = np.random.default_rng(0)
    calm = [_limb_stream(rng, 1024) for _ in range(20)]
    wide = [_limb_stream(rng, 1024, -50, 51) for _ in range(20)]
    got = []
    for mod in (rs, ts):
        base, shifted = mod.StreamingRecorder(), mod.StreamingRecorder()
        for a, b in zip(calm, wide):
            base.record("s", a)
            shifted.record("s", b)
        base.record_amax("s", 2.0)
        shifted.record_amax("s", 4.0)
        table = base.table()
        reps = [mod.detect_drift(base, table, sigma_rtol=0.10),
                mod.detect_drift(shifted, table, sigma_rtol=0.10),
                mod.detect_drift(shifted, table,
                                 baseline={"s": base.pmf("s")},
                                 sigma_rtol=np.inf, tv_threshold=0.05),
                mod.detect_drift(shifted, table, sigma_rtol=0.10,
                                 min_calls=99)]
        got.append([dataclasses.astuple(x) for x in reps]
                   + [mod.tv_distance(base.pmf("s"), shifted.pmf("s"))])
    assert got[0] == got[1]
    assert got[1][1][0] and not got[1][0][0]


def test_streaming_calibrator_refresh_equals_reference():
    runs = []
    for mod, cmod in ((rs, rc), (ts, tc)):
        rng = np.random.default_rng(0)
        rec = mod.StreamingRecorder(decay=0.9)
        for _ in range(20):
            rec.record("s", _limb_stream(rng, 1024))
        stale = cmod.CalibrationTable.from_pairs(
            [(s, v * 2.0) for s, v in rec.table().to_pairs()], version=1)
        cal = mod.StreamingCalibrator(stale, recorder=rec, sigma_rtol=0.10,
                                      seed=3, sample_period=4)
        installed = []
        report = cal.maybe_refresh(installed.append)
        for _ in range(20):
            rec.record("s", _limb_stream(rng, 1024))
        again = cal.maybe_refresh(installed.append)
        gate = [cal.should_sample(i) for i in range(16)]
        runs.append((dataclasses.astuple(report), again, cal.refreshes,
                     [(x.to_pairs(), x.version, x.content_hash)
                      for x in installed],
                     {k: (v.lo, v.probs.tolist())
                      for k, v in cal._baseline.items()}, gate))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# observe / observe_amax on the same quantized values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["e4m3", "e3m4"])
@pytest.mark.parametrize("recorder", ["batch", "streaming"])
def test_observe_records_the_reference_histogram(fmt, recorder):
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (6, 96)) * np.exp(rng.normal(0, 2, (1, 96)))
         ).astype(np.float32)
    q = tf.round_to_format(torch.from_numpy(x), tf.get_format(fmt))
    qb = q.reshape(3, 2, 96)
    recs = []
    for mod, obs, args in (
            (rc, rc.observe, (jnp.asarray(q.numpy()), rf.get_format(fmt))),
            (tc, tc.observe, (q, tf.get_format(fmt)))):
        rec = (mod.ActivationRecorder() if recorder == "batch"
               else (rs if mod is rc else ts).StreamingRecorder(0.8))
        with mod.calibrating(rec):
            obs("whole", *args)
            if mod is rc:
                jax.vmap(lambda a: rc.observe("sliced", a, args[1]))(
                    jnp.asarray(qb.numpy()))
            else:
                tc.observe("sliced", qb, args[1], batched=True)
            obs(None, *args)                       # untagged: no record
        recs.append(rec)
    r, t = recs
    assert t.sites == r.sites == ("sliced", "whole")
    for s in r.sites:
        assert t.calls(s) == r.calls(s)
        np.testing.assert_array_equal(t._counts[s], r._counts[s])
    assert t.calls("sliced") == 3
    # no recorder: observing is a no-op
    tc.observe("whole", q, tf.get_format(fmt))
    tc.observe_amax("attn.q", q)


def test_observe_amax_equals_reference():
    x = np.random.default_rng(5).normal(0, 3, (8, 64)).astype(np.float32)
    with rc.calibrating() as r:
        rc.observe_amax("attn.q", jnp.asarray(x))
        rc.observe_amax("attn.q", jnp.asarray(x[:2] * 0.5))
    with tc.calibrating() as t:
        tc.observe_amax("attn.q", torch.from_numpy(x))
        tc.observe_amax("attn.q", torch.from_numpy(x[:2] * 0.5))
    assert t.amax("attn.q") == r.amax("attn.q") > 0
    _tables_equal(t.table(), r.table())


# ---------------------------------------------------------------------------
# the static decode-query scale (tests/test_kvcache.py:375-415)
# ---------------------------------------------------------------------------


_PACKED = dict(dtype="fp8_e4m3", accum="mgs_exact", kv_cache="packed",
               per_row_act=True, block_k=32)


def _qdq_pair(q2, r_cfg, t_cfg, state=None, batch=1):
    if state is None:
        r = r_qdq(jnp.asarray(q2), r_cfg)
        t = t_qdq(torch.from_numpy(q2), t_cfg)
    else:
        with rc.applied_calib_state({"q_amax": jnp.asarray(state)}):
            r = r_qdq(jnp.asarray(q2), r_cfg, batch=batch)
        a = np.asarray(state, np.float32)
        ts_ = {"q_amax": torch.from_numpy(a.copy()),
               "q_amax_min": float(a.min()), "q_amax_max": float(a.max())}
        with tc.applied_calib_state(ts_):
            t = t_qdq(torch.from_numpy(q2), t_cfg, batch=batch)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale))
    return t


def test_static_decode_q_scale_equals_reference():
    rng = np.random.default_rng(0)
    q2 = rng.normal(0, 3, (12, 32)).astype(np.float32)
    amax = float(np.abs(q2).max())
    dyn_r, dyn_t = rq.QuantConfig(**_PACKED), tq.QuantConfig(**_PACKED)
    table = {"attn.q.amax": amax * 0.6}
    st_r = dataclasses.replace(dyn_r, static_q_scale=True).with_calibration(
        rc.CalibrationTable(table))
    st_t = dataclasses.replace(dyn_t, static_q_scale=True).with_calibration(
        tc.CalibrationTable(table))
    dyn = _qdq_pair(q2, dyn_r, dyn_t)
    st = _qdq_pair(q2, st_r, st_t)                 # the config's scalar
    assert not torch.equal(st.q, dyn.q)            # clipped, rescaled
    # the flag on without a table, and a degenerate amax: dynamic
    for amx in (None, 0.0):
        r_cfg = dataclasses.replace(dyn_r, static_q_scale=True)
        t_cfg = dataclasses.replace(dyn_t, static_q_scale=True)
        if amx is not None:
            r_cfg = r_cfg.with_calibration({"attn.q.amax": amx})
            t_cfg = t_cfg.with_calibration({"attn.q.amax": amx})
        fb = _qdq_pair(q2, r_cfg, t_cfg)
        assert torch.equal(fb.q, dyn.q) and torch.equal(fb.scale, dyn.scale)
    # runtime state: a scalar, and per-slot vectors (4 slots x 3 rows)
    # with <= 0 entries (those rows take the dynamic reduce)
    _qdq_pair(q2, st_r, st_t, state=np.float32(amax * 0.8))
    _qdq_pair(q2, st_r, st_t, state=np.float32(0.0))
    for vec in ([amax, 0.0, amax * 0.5, -1.0], [0.0, 0.0, 0.0, 0.0],
                [amax * 0.3, amax, 2 * amax, amax * 0.9]):
        got = _qdq_pair(q2, st_r, st_t, state=np.asarray(vec, np.float32),
                        batch=4)
        for slot, v in enumerate(vec):
            rows = slice(3 * slot, 3 * slot + 3)
            if v <= 0:
                assert torch.equal(got.q[rows], dyn.q[rows])
                assert torch.equal(got.scale[rows], dyn.scale[rows])
    # static_q_scale off ignores the state
    _qdq_pair(q2, dyn_r, dyn_t, state=np.float32(amax * 0.5))


# ---------------------------------------------------------------------------
# qmatmul's flush period
# ---------------------------------------------------------------------------


def _acts(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, shape) * np.exp(rng.normal(0, 2, shape[-1:]))
    return x.astype(np.float32)


def test_qmatmul_flush_period_from_state_and_plan_equals_reference():
    """At K = 160 (5 K-steps of 32) a period of 1, 2 or 3 moves bits; the
    reference runs its fused Pallas kernel in interpret mode at the same
    period, the port its twin."""
    x, w = _acts((6, 160), 1), _acts((160, 40), 2, 0.1)
    r_cfg = rq.FP8_MGS_SERVE.replace(block_k=32, block_m=8, block_n=128)
    t_cfg = tq.FP8_MGS_SERVE.replace(block_k=32)
    pw = tprep.prepare_weight(torch.from_numpy(w), t_cfg)
    outs = {}
    for p in (1, 2, 3):
        with rc.applied_calib_state(
                {"flush": {"ffn.wd": jnp.asarray(p, jnp.int32)}}):
            want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w),
                                        r_cfg, site="ffn.wd"))
        with tc.applied_calib_state({"flush": {"ffn.wd": p}}):
            got = qmatmul(torch.from_numpy(x), pw, t_cfg,
                          site="ffn.wd").numpy()
            # another site is not in the state: worst case
            other = qmatmul(torch.from_numpy(x), pw, t_cfg,
                            site="ffn.wg").numpy()
        np.testing.assert_array_equal(got, want)
        outs[p] = got
    once = qmatmul(torch.from_numpy(x), pw, t_cfg).numpy()
    np.testing.assert_array_equal(other, once)
    assert all((outs[p] != once).any() for p in (1, 2, 3))
    # flush_target: the planned period (>= the worst case: one flush)
    for cfg_r, cfg_t in ((r_cfg, t_cfg),
                         (r_cfg.with_calibration({"ffn.wd": 3.0}),
                          t_cfg.with_calibration({"ffn.wd": 3.0}))):
        want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w),
                                    cfg_r.replace(flush_target=1e-6),
                                    site="ffn.wd"))
        got = qmatmul(torch.from_numpy(x), pw,
                      cfg_t.replace(flush_target=1e-6), site="ffn.wd")
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), once)


# ---------------------------------------------------------------------------
# PreparedWeight.limb_sigma / act_sigma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spread", [0.0, 1.0, 3.0])
def test_prepared_limb_sigma_matches_reference(spread):
    """Per-tensor and per-channel scales, limb planes kept or not; the
    columns' spread moves the limb distribution. The port's sigma is the
    float64 std of the reference's own limb values (to 1e-12). The
    reference's ``limb_sigma`` is a float32 ``jnp.std`` inside its
    preparation graph, 1.5e-5 to 2.1e-5 off that exact std on these
    27,648 limbs: held within 5e-5 of it."""
    from repro.kernels.mgs_matmul import limb_decompose as r_limbs
    rng = np.random.default_rng(6)
    w = (rng.normal(0, 0.05, (3, 64, 48))
         * np.exp(rng.normal(0, spread, (3, 1, 48)))).astype(np.float32)
    e = rng.normal(0, 1, (96, 64)).astype(np.float32)
    for kw in (dict(use_kernel=True, fused=True),
               dict(use_kernel=True, fused=False, per_channel=True)):
        r_cfg = rq.QuantConfig(dtype="fp8_e4m3", accum="mgs_exact", **kw)
        t_cfg = tq.QuantConfig(dtype="fp8_e4m3", accum="mgs_exact", **kw)
        pairs = [(rprep.prepare_weight(jnp.asarray(w), r_cfg, stack_ndim=1),
                  tprep.prepare_weight(torch.from_numpy(w), t_cfg,
                                       stack_ndim=1)),
                 (rprep.prepare_unembed(jnp.asarray(e), r_cfg),
                  tprep.prepare_unembed(torch.from_numpy(e), t_cfg))]
        for r, t in pairs:
            assert (t.limbs is not None) == (r.limbs is not None)
            exact = np.asarray(r_limbs(r.values(), r.fmt), np.float64).std()
            assert t.limb_sigma == pytest.approx(exact, rel=1e-12)
            assert t.limb_sigma == pytest.approx(r.limb_sigma, rel=5e-5)
            assert t.act_sigma is None
            s = t.with_act_sigma(7.5)
            assert (s.codes is t.codes and s.act_sigma == 7.5
                    and s.limb_sigma == t.limb_sigma)
            if t.codes.dim() == 3:
                one = s.slice(1)
                assert (one.limb_sigma, one.act_sigma) == (t.limb_sigma,
                                                           7.5)
