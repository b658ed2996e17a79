"""Port parity for the swamp and integer accumulations: the integer
quantizers (``quant.quantize``), ``kernels.ref.swamp_matmul_ref``,
``qmatmul`` under fp8 ``swamp`` and ``int8`` / ``int5`` / ``int4`` with
``wide`` / ``mgs_exact`` / ``mgs_dmac`` / ``clip`` / ``wrap``, and the group
engine under ``INT8_DMAC`` and fp8 ``swamp``, against the reference.

Quantizers, the swamp matmul and every ``qmatmul`` configuration are held
bitwise, plain and ``batched`` (the reference ``vmap``\\ s ``qmatmul`` per
slice, so its scales are per slice). ``quantize_int``'s ``amax / (2**(b-1)
- 1)`` is a multiply by the float32 reciprocal in the reference's compiled
graph, and so in the port. The integer sum is a float64 matmul over
integer values in the port (exact: no partial sum reaches ``2**53``) where
the reference runs an int32 ``jnp.dot``; both give the same int32.

Reduced deepseek-7b on the group engine (float32 compute, the residual
output projections scaled by 8 so that tokens vary), under ``INT8_DMAC``
and under fp8 ``swamp`` against the reference's engine: greedy tokens
equal and logits within 5% of the scale at most and 1% on average; and
under swamp the engine equals the model-level prefill + decode loop
bitwise. The continuous engine
refuses both configs as the reference's does, with the same error type.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import ContinuousBatchingEngine as RCont  # noqa: E402
from repro.launch.serve import Request as RRequest  # noqa: E402
from repro.launch.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.quant import config as rq  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402
from repro.quant import quantize as rquant  # noqa: E402
from repro.quant.qmatmul import qmatmul as r_qmatmul  # noqa: E402

import repro_torch.quant as tquant_pkg  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServeEngine)
from repro_torch.models import (  # noqa: E402
    decode_step, init_cache, init_params, prefill)
from repro_torch.quant import PREP_STATS  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant import quantize as tquant  # noqa: E402
from repro_torch.quant.qmatmul import qmatmul  # noqa: E402

from test_torch_model import _prompts  # noqa: E402

SWAMP = dict(dtype="fp8_e4m3", accum="swamp")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---------------------------------------------------------------------------
# quantizers and the swamp oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 5, 4])
def test_quantize_int_both_ways(bits):
    rng = np.random.default_rng(bits)
    for axis in (None, 0, 1):
        for sym in (True, False):
            # magnitudes over six decades: the reciprocal multiply and a
            # true division differ in the last bit of some scales
            x = (rng.normal(0.3, 1.0, (48, 33))
                 * 10.0 ** rng.uniform(-3, 3, (48, 1))).astype(np.float32)
            r = rquant.quantize_int(jnp.asarray(x), bits, axis, sym)
            t = tquant.quantize_int(_t(x), bits, axis, sym)
            assert t.q.dtype == torch.int32
            _eq(r.q, t.q)
            _eq(r.scale, t.scale)
            assert (t.offset is None) == sym
            if not sym:
                assert t.offset.dtype == torch.int32
                _eq(r.offset, t.offset)
            _eq(rquant.dequantize_int(r), tquant.dequantize_int(t))
            _eq(rquant.fake_quant_int(jnp.asarray(x), bits, axis, sym),
                tquant.fake_quant_int(_t(x), bits, axis, sym))
        _eq(rquant.fake_quant_fp8(jnp.asarray(x), rq.QuantConfig(
            dtype="fp8_e4m3").fmt, axis),
            tquant.fake_quant_fp8(_t(x), tf.E4M3, axis))


@pytest.mark.parametrize("mant", [3, 4])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_swamp_matmul_ref_bitwise(fmt, mant):
    rng = np.random.default_rng(mant)
    f = tf.get_format(fmt)
    x = tf.round_to_format(_t(rng.normal(0, 3, (7, 150)).astype(
        np.float32)), f).numpy()
    w = tf.round_to_format(_t(rng.normal(0, 3, (150, 9)).astype(
        np.float32)), f).numpy()
    want = rref.swamp_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                 rq.QuantConfig(dtype=f"fp8_{fmt}").fmt,
                                 mant)
    _eq(want, tref.swamp_matmul_ref(_t(x), _t(w), f, mant))


# ---------------------------------------------------------------------------
# qmatmul
# ---------------------------------------------------------------------------

CONFIGS = {
    "fp8-swamp": SWAMP,
    "fp8-e5m2-swamp-n6": dict(dtype="fp8_e5m2", accum="swamp",
                              narrow_bits=6),
    "int8-dmac": dict(dtype="int8", accum="mgs_dmac"),
    "int8-wide-rows-channels": dict(dtype="int8", accum="wide",
                                    per_row_act=True, per_channel=True),
    "int5-exact": dict(dtype="int5", accum="mgs_exact"),
    "int4-wide-act3": dict(dtype="int4", accum="wide", act_bits=3),
    "int8-clip16": dict(dtype="int8", accum="clip", narrow_bits=16),
    "int8-wrap16": dict(dtype="int8", accum="wrap", narrow_bits=16),
    "int4-clip8-channels": dict(dtype="int4", accum="clip", narrow_bits=8,
                                per_channel=True),
    "int5-wrap9-rows": dict(dtype="int5", accum="wrap", narrow_bits=9,
                            per_row_act=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_qmatmul_plain_and_batched_bitwise(name):
    kw = CONFIGS[name]
    rcfg, tcfg = rq.QuantConfig(**kw), tq.QuantConfig(**kw)
    rng = np.random.default_rng(len(name))
    x = rng.normal(0, 1, (2, 3, 96)).astype(np.float32)
    w = rng.normal(0, 0.1, (96, 20)).astype(np.float32)
    b = rng.normal(0, 0.1, (20,)).astype(np.float32)
    _eq(r_qmatmul(jnp.asarray(x), jnp.asarray(w), rcfg),
        qmatmul(_t(x), _t(w), tcfg))
    _eq(r_qmatmul(jnp.asarray(x), jnp.asarray(w), rcfg, bias=jnp.asarray(b)),
        qmatmul(_t(x), _t(w), tcfg, bias=_t(b)))
    # silu's exp rounds differently in the last ulp in the two packages
    np.testing.assert_allclose(
        qmatmul(_t(x), _t(w), tcfg, bias=_t(b), activation="silu").numpy(),
        np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w), rcfg,
                             bias=jnp.asarray(b), activation="silu")),
        rtol=1e-6, atol=1e-7)
    xb = rng.normal(0, 1, (3, 5, 64)).astype(np.float32)
    wb = rng.normal(0, 0.1, (3, 64, 12)).astype(np.float32)
    xb[1] *= 40.0                      # per-slice scales must differ
    want = jax.vmap(lambda a, c: r_qmatmul(a, c, rcfg))(jnp.asarray(xb),
                                                        jnp.asarray(wb))
    _eq(want, qmatmul(_t(xb), _t(wb), tcfg, batched=True))


def test_int_and_swamp_refusals():
    x, w = torch.ones(2, 8), torch.ones(8, 4)
    pw = tprep.prepare_weight(w, tq.FP8_MGS_EXACT)
    rpw = rprep.prepare_weight(jnp.ones((8, 4)), rq.FP8_MGS_EXACT)
    for kw in (dict(dtype="int8", accum="wide"), dict(dtype="int4",
                                                      accum="clip")):
        with pytest.raises(ValueError, match="PreparedWeight requires"):
            qmatmul(x, pw, tq.QuantConfig(**kw))
        with pytest.raises(ValueError, match="PreparedWeight requires"):
            r_qmatmul(jnp.ones((2, 8)), rpw, rq.QuantConfig(**kw))
    with pytest.raises(ValueError, match="fp8 dtype"):
        tprep.prepare_weight(w, tq.INT8_DMAC)
    with pytest.raises(NotImplementedError, match="accum=clip for fp8"):
        qmatmul(x, w, tq.QuantConfig(dtype="fp8_e4m3", accum="clip"))
    with pytest.raises(NotImplementedError, match="accum=swamp for int"):
        qmatmul(x, w, tq.QuantConfig(dtype="int8", accum="swamp"))
    # past K * 2**14 = 2**31 the reference's int32 dot wraps: refused
    K = 2**17
    with pytest.raises(ValueError, match="leave int32"):
        qmatmul(torch.ones(1, K), torch.ones(K, 1), tq.INT8_DMAC)
    assert tquant_pkg.INT8_DMAC == tq.INT8_DMAC
    assert (tq.INT8_DMAC.dtype, tq.INT8_DMAC.accum) == ("int8", "mgs_dmac")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Reduced deepseek-7b at float32, ``wo`` and ``wd`` scaled by 8, as
    numpy (drawn once by the port)."""
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32")
    params = init_params(cfg, seed=0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0

    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        return tree.numpy()
    return to_np(params)


def _cfgs(quant_kw):
    return (dataclasses.replace(reduced_config("deepseek-7b"),
                                compute_dtype="float32",
                                quant=tq.QuantConfig(**quant_kw)),
            dataclasses.replace(r_reduced("deepseek-7b"),
                                compute_dtype="float32",
                                quant=rq.QuantConfig(**quant_kw)))


def _engine_parity(weights, quant_kw):
    """The reference's group engine and the port's on the same weights and
    requests: greedy tokens equal, logits within the engine bar,
    ``PREP_STATS`` flat. Returns the port's engine."""
    tcfg, rcfg = _cfgs(quant_kw)
    renv = RServeEngine(rcfg, make_mesh((1, 1), ("data", "model")), batch=2,
                        max_len=16, params=jax.tree.map(jnp.asarray, weights))
    rreqs = [RRequest(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(_prompts())]
    rstats = renv.run(rreqs, record_logits=True)
    eng = ServeEngine(tcfg, batch=2, max_len=16,
                      params=params_from_numpy(weights), device="cpu")
    before = dict(PREP_STATS)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(_prompts())]
    tstats = eng.run(treqs, record_logits=True)
    assert PREP_STATS == before
    toks = set()
    for rr, tr in zip(rreqs, treqs):
        assert rr.out_tokens == tr.out_tokens, (rr.rid, rr.out_tokens,
                                                tr.out_tokens)
        toks.update(tr.out_tokens)
        rl = np.stack(rstats["logits"][rr.rid])
        tl = np.stack(tstats["logits"][tr.rid])
        scale = np.abs(rl).max()
        err = np.abs(tl - rl)
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
            err.max() / scale, err.mean() / scale)
    assert len(toks) > 3
    assert tstats["decode_tokens"] == rstats["decode_tokens"] == 12
    return eng


def test_int8_dmac_engine_matches_reference(weights):
    eng = _engine_parity(weights, dict(dtype="int8", accum="mgs_dmac"))
    assert eng.cfg.quant == tq.INT8_DMAC
    # an integer config leaves the weights raw, as the reference's does
    assert isinstance(eng.params["layers"]["attn"]["wq"], torch.Tensor)
    assert "unembed_prepared" not in eng.params


def test_swamp_engine_matches_reference(weights):
    """fp8 ``swamp``: every projection, the logits head and the attention
    contractions (per-slice scales) through the swamp accumulation, the
    float KV cache."""
    _engine_parity(weights, SWAMP)


def test_swamp_engine_equals_model_loop(weights):
    """The group engine under fp8 ``swamp`` == the model-level prefill +
    decode loop on its weights, bitwise (float cache)."""
    tcfg, _ = _cfgs(SWAMP)
    eng = ServeEngine(tcfg, batch=2, max_len=12,
                      params=params_from_numpy(weights), device="cpu")
    assert init_cache(tcfg, 2, 12)["k"].is_floating_point()   # not packed
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(_prompts()[:2])]
    logged = eng.run(reqs, record_logits=True)["logits"]
    toks = np.zeros((2, 8), np.int64)
    for j, r in enumerate(reqs):
        toks[j, 8 - len(r.prompt):] = r.prompt
    logits, cache = prefill(eng.params, tcfg, {"tokens": _t(toks)},
                            init_cache(tcfg, 2, 12))
    for step in range(3):
        for j, r in enumerate(reqs):
            assert np.array_equal(logits[j].numpy(), logged[r.rid][step])
        if step < 2:
            logits, cache = decode_step(eng.params, tcfg,
                                        logits.argmax(-1)[:, None], cache)


def test_continuous_engine_refuses_as_the_reference():
    """``INT8_DMAC`` and fp8 ``swamp`` (per-tensor activation scales, float
    cache) and their per-row variants: the continuous engine raises
    ``ValueError`` in both packages."""
    mesh = make_mesh((1, 1), ("data", "model"))
    for kw in (dict(dtype="int8", accum="mgs_dmac"), SWAMP,
               dict(dtype="int8", accum="mgs_dmac", per_row_act=True),
               dict(SWAMP, per_row_act=True)):
        tcfg, rcfg = _cfgs(kw)
        with pytest.raises(ValueError):
            RCont(rcfg, mesh, slots=2, max_len=16)
        with pytest.raises(ValueError):
            ContinuousBatchingEngine(tcfg, slots=2, max_len=16,
                                     device="cpu")
