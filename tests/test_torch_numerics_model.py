"""Port parity for the paper's numerics on the group serving path: reduced
deepseek-7b served by ``ServeEngine.run`` of both packages on the same
weights and requests, with the float KV cache.

* ``FP8_MGS`` with the kernel tier (the B5 twin in every projection, the
  logits head and the score / value contractions) against the
  reference's ``FP8_MGS`` through its plain path;
* ``FP8_MGS_EXACT`` with the kernel tier (the B4 twin over resident limb
  planes) against the reference's own ``FP8_MGS_EXACT`` kernel run (its
  Pallas kernel in interpret mode) and against the port's
  ``FP8_MGS_SERVE`` (B1);
* ``FP8_WIDE`` (float32 accumulation of FP8 operands) against the
  reference's.

Greedy tokens must be equal and ``PREP_STATS`` must stay flat while
serving. Logits across packages are held to the bound of
``tests/test_torch_model.py`` (5% of the logit scale at most, 1% on
average: ``exp``, ``rsqrt``, ``cos``/``sin`` round differently in the last
ulp between XLA:CPU and PyTorch, and a one-ulp move can flip an FP8 code).
Inside the port at float32 compute, B4 and B1 give the same bits: each
projection of one layer, its activation included, and the whole run. (In
bf16 they do not: on B1's fused path the activation runs in the kernel in
float32, on B4's after the cast to bf16, as in the reference.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import Request as RRequest  # noqa: E402
from repro.launch.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.quant import config as rq  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.linear import proj  # noqa: E402
from repro_torch.quant import PREP_STATS, prepare_params  # noqa: E402
from repro_torch.quant import qeinsum  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """One random tree in the shared layout, as numpy."""
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32")
    return _to_numpy(init_params(cfg, seed=0))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).astype(np.int32) for n in (6, 8, 8)]


def _reference(np_params, quant):
    cfg = dataclasses.replace(r_reduced("deepseek-7b"),
                              compute_dtype="float32", quant=quant)
    eng = RServeEngine(cfg, make_mesh((1, 1), ("data", "model")), batch=2,
                       max_len=16, params=jax.tree.map(jnp.asarray,
                                                       np_params))
    reqs = [RRequest(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts())]
    return reqs, eng.run(reqs, record_logits=True)


def _port(np_params, quant):
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              compute_dtype="float32", quant=quant)
    eng = ServeEngine(cfg, batch=2, max_len=16,
                      params=params_from_numpy(np_params), device="cpu")
    before = dict(PREP_STATS)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts())]
    stats = eng.run(reqs, record_logits=True)
    assert PREP_STATS == before                 # nothing re-prepared
    assert stats["decode_tokens"] == 12
    return reqs, stats, eng


def _assert_close(ref, port):
    (rreqs, rstats), (treqs, tstats) = ref, port[:2]
    for rr, tr in zip(rreqs, treqs):
        assert rr.out_tokens == tr.out_tokens, (rr.rid, rr.out_tokens,
                                                tr.out_tokens)
        rl = np.stack(rstats["logits"][rr.rid])
        tl = np.stack(tstats["logits"][tr.rid])
        scale = np.abs(rl).max()
        err = np.abs(tl - rl)
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
            err.max() / scale, err.mean() / scale)


def test_fp8_mgs_kernel_tier_matches_reference(weights):
    port = _port(weights, tq.FP8_MGS.replace(use_kernel=True))
    _assert_close(_reference(weights, rq.FP8_MGS), port)


def test_fp8_mgs_exact_kernel_tier_matches_reference_and_b1(weights):
    port = _port(weights, tq.FP8_MGS_EXACT.replace(use_kernel=True))
    eng = port[2]
    assert eng.params["layers"]["ffn"]["wd"].limbs.dtype == torch.int8
    assert eng.params["unembed_prepared"].limbs is not None
    _assert_close(_reference(weights, rq.FP8_MGS_EXACT.replace(
        use_kernel=True)), port)
    b1 = _port(weights, tq.FP8_MGS_SERVE)
    assert b1[2].params["layers"]["ffn"]["wd"].limbs is None
    for a, b in zip(port[0], b1[0]):
        assert a.out_tokens == b.out_tokens
        for x, y in zip(port[1]["logits"][a.rid], b1[1]["logits"][b.rid]):
            np.testing.assert_array_equal(x, y)     # float32: same bits


def test_fp8_wide_matches_reference(weights):
    _assert_close(_reference(weights, rq.FP8_WIDE),
                  _port(weights, tq.FP8_WIDE))


def test_projections_b4_equal_b1_at_float32(weights):
    """One layer's projections, with their epilogues, under B4 (unfused,
    activation after the float32 cast) and B1 (fused): the same bits."""
    params = params_from_numpy(weights)
    exact = tq.FP8_MGS_EXACT.replace(use_kernel=True)
    p4 = prepare_params(params, exact)["layers"]
    p1 = prepare_params(params, tq.FP8_MGS_SERVE)["layers"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 5, 4, 16)).astype(
        np.float32))
    for mod, name, act, inp in (("attn", "wq", "none", x),
                                ("attn", "wk", "none", x),
                                ("attn", "wv", "none", x),
                                ("ffn", "wg", "silu", x),
                                ("ffn", "wu", "none", x)):
        a = proj(inp, p4[mod][name].slice(0), exact, activation=act)
        b = proj(inp, p1[mod][name].slice(0), tq.FP8_MGS_SERVE,
                 activation=act)
        assert torch.equal(a, b), name
    a = qeinsum("bthd,hdo->bto", h, p4["attn"]["wo"].slice(1), exact)
    b = qeinsum("bthd,hdo->bto", h, p1["attn"]["wo"].slice(1),
                tq.FP8_MGS_SERVE)
    assert torch.equal(a, b)
    d = torch.from_numpy(rng.standard_normal((10, 128)).astype(np.float32))
    assert torch.equal(proj(d, p4["ffn"]["wd"].slice(1), exact),
                       proj(d, p1["ffn"]["wd"].slice(1), tq.FP8_MGS_SERVE))
