"""Port parity for continuous batching and speculative decoding
(``repro_torch.launch.serve.ContinuousBatchingEngine``).

The reduced deepseek-7b of ``tests/test_continuous.py`` (block 32, 3 slots,
buckets [8, 16], max_len 48) at float32 compute under
``FP8_MGS_SERVE_PAGED`` (the port runs its kernel wrappers, which take
the twins on CPU tensors). Weights are drawn once as numpy and given to
both packages.

Against the reference's ``ContinuousBatchingEngine`` (``use_kernel=False``,
as its own tests run it): greedy tokens equal; logits within the bound of
``tests/test_torch_model.py`` — 5% of the logit scale at most and 1% on
average — because ``exp``, ``rsqrt`` and ``cos``/``sin`` round differently
in the last ulp between XLA:CPU and PyTorch, and a one-ulp move can flip
one FP8 code of a re-quantized operand (with the plain seed-0 weights
one prompt of this traffic takes such a flip in its prefill, through the
one-ulp ``rsqrt`` of an RMS norm, and lands at 1.04% on average; on the
weights below every request agrees within 3e-7 of its scale).

Inside the port, bitwise: against each request served alone on the same
engine, under permuted admission and another slot count, under
mid-flight admission, speculation at k in {1, 2, 4} against sequential
decode, a full-depth draft accepting every token, and the stationary
schedules (B3) against ``"output"`` (B1). Also the constructor guards,
``bucket_for`` and flat ``PREP_STATS`` / kernel builds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import (  # noqa: E402
    ContinuousBatchingEngine as RContinuous, Request as RRequest)
from repro.quant import QuantConfig as RQuantConfig  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    ContinuousBatchingEngine, Request, bucket_for, make_engine)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.quant import PREP_STATS  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_PAGED  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BUCKETS = [8, 16]
_MAXLEN = 48
_PLENS = (5, 11, 3, 8, 14, 6)
_MAXNEW = (4, 3, 5, 2, 4, 3)


def _cfg(**quant):
    return dataclasses.replace(
        reduced_config("deepseek-7b"), compute_dtype="float32",
        quant=FP8_MGS_SERVE_PAGED.replace(block_k=32, **quant))


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, 256, n).astype(np.int32) for n in _PLENS]


def _reqs(prompts, rid0=0, cls=Request):
    return [cls(rid=rid0 + i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, _MAXNEW))]


def _logits_equal(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and (x == y).all() for x, y in zip(a, b))


def _engine(h, slots=3, spec_k=None, **quant):
    eng = ContinuousBatchingEngine(_cfg(**quant), slots=slots,
                                   max_len=_MAXLEN, params=h["eng"].params,
                                   spec_k=spec_k, device="cpu")
    eng.warmup(_BUCKETS, max_new=2)
    return eng


@pytest.fixture(scope="module")
def harness():
    """One warmed 3-slot port engine, its baseline run over the traffic,
    and each request served alone on it."""
    cfg = _cfg()
    np_params = _weights()
    eng = ContinuousBatchingEngine(cfg, slots=3, max_len=_MAXLEN,
                                   params=params_from_numpy(np_params),
                                   device="cpu")
    eng.warmup(_BUCKETS, max_new=2)
    prompts = _prompts()
    base_reqs = _reqs(prompts)
    base_stats = eng.serve(base_reqs, record_logits=True)
    iso = {}
    for i, (p, m) in enumerate(zip(prompts, _MAXNEW)):
        r = Request(rid=200 + i, prompt=p.copy(), max_new_tokens=m)
        iso[i] = (r, eng.serve([r], record_logits=True)["logits"][200 + i])
    return dict(eng=eng, np_params=np_params, prompts=prompts,
                base_reqs=base_reqs, base_stats=base_stats, iso=iso)


def _weights():
    """Seed-0 weights with the residual output projections (``wo``,
    ``wd``) scaled by 8: at the plain init the tied embeddings dominate
    the residual and every request echoes its last token, so no draft
    would ever be rejected; scaled, the layers move the residual, the
    tokens vary and a 1-layer draft is often rejected."""
    params = init_params(_cfg(), 0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0
    return _to_numpy(params)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _assert_matches_base(h, reqs, stats):
    for i, req in enumerate(reqs):
        assert req.done
        assert req.out_tokens == h["base_reqs"][i].out_tokens, f"req {i}"
        assert _logits_equal(stats["logits"][req.rid],
                             h["base_stats"]["logits"][i]), f"req {i}"


def test_tokens_and_logits_match_reference_engine(harness):
    rcfg = dataclasses.replace(
        r_reduced("deepseek-7b"), compute_dtype="float32",
        quant=RQuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                           kv_cache="packed", per_row_act=True,
                           block_m=32, block_n=32, block_k=32))
    reng = RContinuous(rcfg, make_mesh((1, 1), ("data", "model")), slots=3,
                       max_len=_MAXLEN,
                       params=jax.tree.map(jnp.asarray,
                                           harness["np_params"]))
    reng.warmup(_BUCKETS, max_new=2)
    rreqs = _reqs(harness["prompts"], cls=RRequest)
    rstats = reng.serve(rreqs, record_logits=True)
    assert rstats["decode_tokens"] == harness["base_stats"][
        "decode_tokens"] == sum(_MAXNEW)
    for rr, tr in zip(rreqs, harness["base_reqs"]):
        assert rr.out_tokens == tr.out_tokens, (rr.rid, rr.out_tokens,
                                                tr.out_tokens)
        rl = np.stack(rstats["logits"][rr.rid])
        tl = np.stack(harness["base_stats"]["logits"][tr.rid])
        scale = np.abs(rl).max()
        err = np.abs(tl - rl)
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
            rr.rid, err.max() / scale, err.mean() / scale)


def test_logits_match_isolated_single_request(harness):
    for i, req in enumerate(harness["base_reqs"]):
        iso_req, iso_logits = harness["iso"][i]
        assert iso_req.out_tokens == req.out_tokens, f"req {i}"
        assert _logits_equal(harness["base_stats"]["logits"][i],
                             iso_logits), f"req {i}"


def test_invariance_under_permuted_admission_and_slots(harness):
    eng2 = _engine(harness, slots=2)
    perm = [4, 0, 5, 2, 1, 3]
    reqs = _reqs(harness["prompts"])
    stats = eng2.serve([reqs[i] for i in perm], record_logits=True)
    _assert_matches_base(harness, reqs, stats)


def test_invariance_under_mid_flight_admission(harness):
    eng = harness["eng"]
    reqs = _reqs(harness["prompts"])
    pending = [[reqs[3]], [reqs[4], reqs[5]]]
    polls = {"n": 0}

    def feed():
        polls["n"] += 1
        if polls["n"] >= 2 and pending:
            return pending.pop(0)
        return []

    done = []
    stats = eng.serve(reqs[:3], record_logits=True, feed=feed,
                      on_done=lambda r: done.append(r.rid))
    assert not pending and sorted(done) == list(range(len(reqs)))
    _assert_matches_base(harness, reqs, stats)
    # arrivals: the tail becomes admissible only after decode has begun
    reqs = _reqs(harness["prompts"])
    stats = eng.serve(reqs, record_logits=True,
                      arrivals=[0.0, 0.0, 0.0, 0.05, 0.05, 0.1])
    _assert_matches_base(harness, reqs, stats)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_bitwise_vs_sequential(harness, k):
    eng = _engine(harness, spec_k=k, draft_layers=1)
    reqs = _reqs(harness["prompts"])
    stats = eng.serve(reqs, record_logits=True)
    _assert_matches_base(harness, reqs, stats)
    spec = stats["spec"]
    assert spec["k"] == k and 0 <= spec["accepted"] <= spec["drafted"]
    if k == 1:
        assert spec["drafted"] == 0
    else:
        assert spec["drafted"] >= stats["steps"]
        assert stats["steps"] <= harness["base_stats"]["steps"]
        # the 1-layer draft is rejected somewhere: the rewind ran
        assert spec["accepted"] < spec["drafted"]


def test_spec_full_depth_draft_accepts_everything(harness):
    eng = _engine(harness, spec_k=3, draft_layers=4)
    reqs = _reqs(harness["prompts"])
    stats = eng.serve(reqs)
    for req, base in zip(reqs, harness["base_reqs"]):
        assert req.out_tokens == base.out_tokens
    assert stats["spec"]["accepted"] == stats["spec"]["drafted"] > 0
    assert stats["spec"]["acceptance_rate"] == 1.0


@pytest.mark.parametrize("schedule", ["activation", "weight"])
def test_stationary_schedules_bitwise(harness, schedule):
    """B3 under either schedule serves bitwise what B1 serves (the
    score/value contractions of prefill included)."""
    eng = _engine(harness, schedule=schedule)
    reqs = _reqs(harness["prompts"])
    stats = eng.serve(reqs, record_logits=True)
    _assert_matches_base(harness, reqs, stats)


def test_guards():
    params = init_params(_cfg(), 0)   # raw: each engine prepares its own
    with pytest.raises(ValueError, match="per_row_act"):
        ContinuousBatchingEngine(_cfg(per_row_act=False), slots=2,
                                 max_len=_MAXLEN, params=params,
                                 device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingEngine(_cfg(), slots=2, max_len=_MAXLEN,
                                 params=params, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        make_engine(_cfg(), batch=2, max_len=_MAXLEN, params=params,
                    spec_k=2, device="cpu")
    eng = make_engine(_cfg(), batch=2, max_len=_MAXLEN, params=params,
                      continuous=True, spec_k=2, device="cpu")
    assert isinstance(eng, ContinuousBatchingEngine) and eng.spec_k == 2
    with pytest.raises(ValueError, match="out of range"):
        eng.warmup([70])
    with pytest.raises(ValueError, match="out of range"):
        eng.warmup([0])
    with pytest.raises(NotImplementedError, match="serve"):
        eng.run([], record_logits=True)


def test_bucket_for_rule():
    assert bucket_for(5, [8, 16]) == 8
    assert bucket_for(8, [8, 16]) == 8
    assert bucket_for(9, [8, 16]) == 16
    assert bucket_for(17, [8, 16], block=32) == 32
    assert bucket_for(17, None, block=32) == 32
    assert bucket_for(33, None, block=32) == 64
    assert bucket_for(5, None) == 5


def test_between_bucket_prompts_keep_state_flat(harness):
    """Prompts between warmed buckets ride the next bucket: nothing is
    re-prepared and no kernel is built; the pool drains back to empty."""
    eng = harness["eng"]
    rng = np.random.default_rng(13)
    before, builds = dict(PREP_STATS), dict(_cuda.BUILDS)
    free = eng.alloc.n_free
    for plen in (9, 13, 15, 2, 7):
        req = Request(rid=1000 + plen,
                      prompt=rng.integers(1, 256, plen).astype(np.int32),
                      max_new_tokens=2)
        stats = eng.serve([req])
        assert req.done and len(req.out_tokens) == 2
        assert stats["prefill_tokens"] == bucket_for(plen, _BUCKETS)
    assert dict(PREP_STATS) == before and dict(_cuda.BUILDS) == builds
    assert eng.alloc.n_free == free
    assert not eng.cache["pos"].any() and not eng.cache["block_table"].any()
