"""Port parity for the MoE family: ``repro_torch.models.moe`` against
``repro.models.moe``, and MoE stacks on the group ``ServeEngine``.

* Routing, bitwise: the port's ``_route`` on the reference's router
  probabilities gives the reference's top-k experts, capacity claims and
  slot -> token map (the reference's own lines, ``repro/models/moe.py``
  78-108, replayed in jnp and tied to its ``moe_apply`` through the
  dispatched rows it hands to ``constrain``), also with planted ties
  (lower expert index first) and with an expert no token chose.
* ``moe_apply``'s output against the reference's on the same inputs and
  weights: rtol / atol 2e-5 unquantized (the bar of the reference's
  ``test_moe_gather_routing_matches_dense_reference``), and the engine bar
  of ``tests/test_torch_model.py`` (5% of the scale at most, 1% on
  average) under ``FP8_MGS_SERVE`` (the B1 twin, one batched call over the
  experts) and ``FP8_MGS`` (the B5 twin through its batched codes entry).
* The twin of the reference's per-token numpy check.
* Reduced granite-moe-1b-a400m (packed and float cache) and dbrx-132b
  (packed) through ``_check_group_parity``: greedy tokens equal, logits
  within the engine bar, ``PREP_STATS`` flat, expert codes ``(L, E, K,
  N)`` uint8 with ``(L, E)`` scales. Float32 compute: the reference's
  bfloat16 MoE graphs do not run on XLA:CPU (ROADMAP queue C).
* Calibration on a reduced MoE engine: ``calibrate()`` lists the
  ``moe.*`` sites and a request replays bitwise by table version.
* ``launch.dryrun.family_b1_shapes`` (the shapes at which the chip smoke
  checks B1 against its twin for the MoE and SSM models) is every shape
  the group engine launches B1 at under the smoke's traffic, and no other.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.quant import config as rq  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models import moe_apply  # noqa: E402
from repro_torch.models.moe import _n_groups, _route  # noqa: E402
from repro_torch.quant import PREP_STATS  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402

from test_torch_model import _check_group_parity, _weights  # noqa: E402

#: preset -> (port QuantConfig, reference QuantConfig): the reference runs
#: its emulation tier, the port its kernel wrappers (twins on the CPU)
QUANTS = {"none": (tq.NONE, rq.NONE),
          "FP8_MGS_SERVE": (tq.FP8_MGS_SERVE,
                            rq.FP8_MGS_SERVE.replace(use_kernel=False)),
          "FP8_MGS": (tq.FP8_MGS.replace(use_kernel=True), rq.FP8_MGS)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(quant="none"):
    """Reduced dbrx-132b with top-3 of 4 experts (the reference test's)."""
    tcfg = dataclasses.replace(reduced_config("dbrx-132b"), top_k=3,
                               compute_dtype="float32",
                               quant=QUANTS[quant][0])
    rcfg = dataclasses.replace(r_reduced("dbrx-132b"), top_k=3,
                               compute_dtype="float32",
                               quant=QUANTS[quant][1])
    return tcfg, rcfg


def _moe_weights(cfg, case, seed=0):
    """One layer's router and experts as float32 numpy, with the init's
    scales; ``unchosen`` pushes expert 0 below every other for every
    token, ``tie`` gives experts 1 and 2 the same router column."""
    rng = np.random.default_rng(seed)
    d, h, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"wr": rng.normal(0, d ** -0.5, (d, E)),
         "wg": rng.normal(0, E ** -0.5, (E, d, h)),
         "wu": rng.normal(0, E ** -0.5, (E, d, h)),
         "wd": rng.normal(0, h ** -0.5, (E, h, d))}
    if case == "unchosen":
        p["wr"][:, 0] = 0.0
        p["wr"][0, 0] = -50.0           # x[..., 0] is pinned to 1 below
    if case == "tie":
        p["wr"][:, 2] = p["wr"][:, 1]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(cfg, case, seed=0):
    x = np.random.default_rng(seed + 1).normal(
        0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    if case == "unchosen":
        x[..., 0] = 1.0
    return x


def _ref_route(probs, k, C):
    """The reference's routing (``repro/models/moe.py`` 78-108) in jnp,
    returning the port's ``_route`` layout."""
    G, g, E = probs.shape
    gates, eidx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    rank_major = onehot.transpose(0, 2, 1, 3).reshape(G, k * g, E)
    pos = jnp.cumsum(rank_major, axis=1) - 1
    pos = pos.reshape(G, k, g, E).transpose(0, 2, 1, 3)
    within = (pos < C) & (onehot > 0)
    tok = jnp.arange(g, dtype=jnp.int32)
    slot_token = jnp.zeros((G, E, C), jnp.int32)
    claimed = jnp.zeros((G, E, C), jnp.int32)
    for r in range(k):
        sel = within[:, :, r, :]
        slot = jnp.clip(pos[:, :, r, :], 0, C - 1)
        oh = (jax.nn.one_hot(slot, C, dtype=jnp.int32)
              * sel[..., None].astype(jnp.int32))
        slot_token = slot_token + jnp.einsum("gtec,t->gec", oh, tok)
        claimed = claimed + jnp.sum(oh, axis=1)
    e = eidx[..., None]
    slot = jnp.clip(jnp.take_along_axis(pos, e, -1)[..., 0], 0, C - 1)
    sel = jnp.take_along_axis(within, e, -1)[..., 0]
    return [np.asarray(a) for a in (gates, eidx, slot, sel, slot_token,
                                    claimed)]


def _assert_route_equal(probs, k, C):
    """The port's ``_route`` == the reference's routing on ``probs``."""
    want = _ref_route(jnp.asarray(probs), k, C)
    got = [a.numpy() for a in _route(torch.from_numpy(np.array(probs)),
                                     k, C)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    for name, a, b in zip(("eidx", "slot", "sel", "slot_token", "claimed"),
                          got[1:], want[1:]):
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name
    return got


@pytest.mark.parametrize("case,quant", [
    ("random", "none"), ("random", "FP8_MGS_SERVE"), ("random", "FP8_MGS"),
    ("unchosen", "FP8_MGS_SERVE"), ("tie", "none")])
def test_moe_apply_matches_reference(monkeypatch, case, quant):
    tcfg, rcfg = _cfgs(quant)
    p = _moe_weights(tcfg, case)
    x = _inputs(tcfg, case)
    seen = []

    def record(a, spec):
        seen.append(a)
        return a

    monkeypatch.setattr(r_moe, "constrain", record)
    ry, _ = r_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), rcfg)
    ty, _ = moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), tcfg)
    # the reference's constrain calls: xg, router logits, dispatched rows
    xg, logits, xe = (np.asarray(a) for a in seen[:3])
    E, k = tcfg.n_experts, tcfg.top_k
    G = _n_groups(x.shape[0] * x.shape[1], tcfg)
    g = xg.shape[1]
    C = max(1, int(math.ceil(k * g * tcfg.capacity_factor / E)))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    gates, eidx, slot, sel, slot_token, claimed = _assert_route_equal(
        probs, k, C)
    # the replayed routing is the reference's own: its dispatched rows
    rows = np.take_along_axis(xg, slot_token.reshape(G, E * C, 1), axis=1)
    assert np.array_equal(
        xe, (rows * claimed.reshape(G, E * C, 1)).reshape(xe.shape))
    if case == "unchosen":
        assert (eidx != 0).all() and claimed[:, 0].sum() == 0
    if case == "tie":
        # experts 1 and 2 tie on every token: 1 always ranks first
        both = (eidx == 1).any(-1) & (eidx == 2).any(-1)
        assert both.any()
        first = np.argmax(eidx == 1, -1) < np.argmax(eidx == 2, -1)
        assert first[both].all()
    ry, ty = np.asarray(ry), ty.numpy()
    assert np.isfinite(ty).all()
    if quant == "none":
        np.testing.assert_allclose(ty, ry, rtol=2e-5, atol=2e-5)
    else:
        scale = np.abs(ry).max()
        err = np.abs(ty - ry)
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
            err.max() / scale, err.mean() / scale)


def test_route_planted_ties_take_the_lower_index():
    """Exact ties in the probabilities: the lower expert index ranks
    first, in selection and so in capacity priority (``jax.lax.top_k``)."""
    probs = np.array([[[0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.1, 0.4],
                       [0.25, 0.25, 0.25, 0.25], [0.2, 0.3, 0.3, 0.2],
                       [0.4, 0.1, 0.4, 0.1], [0.3, 0.3, 0.2, 0.2]]],
                     np.float32)
    for k, C in ((2, 1), (3, 2), (2, 4)):
        _, eidx, *_ = _assert_route_equal(probs, k, C)
    assert eidx[0, 2].tolist() == [0, 1]
    assert eidx[0, 1].tolist() == [1, 3]


def test_moe_gather_routing_matches_dense_reference():
    """The twin of the reference's test of the same name: the port's
    gather dispatch / combine against a per-token numpy loop over the same
    rank-major capacity assignment, to float32 rounding."""
    cfg, _ = _cfgs()
    p = _moe_weights(cfg, "random", seed=3)
    x = _inputs(cfg, "random", seed=3)
    y, _ = moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), cfg)

    E, k, (B, T, d) = cfg.n_experts, cfg.top_k, x.shape
    G = _n_groups(B * T, cfg)
    g = B * T // G
    C = max(1, int(math.ceil(k * g * cfg.capacity_factor / E)))
    xg = x.reshape(G, g, d)
    logits = np.einsum("gtd,de->gte", xg, p["wr"])
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    eidx = np.argsort(-probs, axis=-1, kind="stable")[..., :k]
    gates = np.take_along_axis(probs, eidx, -1)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)

    def expert(e, xt):
        hg = xt @ p["wg"][e]
        hu = xt @ p["wu"][e]
        return ((hg / (1 + np.exp(-hg))) * hu) @ p["wd"][e]

    yref = np.zeros((G, g, d), np.float32)
    for gi in range(G):
        count = {e: 0 for e in range(E)}
        for r in range(k):              # rank-major, then token-major
            for t in range(g):
                e = eidx[gi, t, r]
                if count[e] < C:
                    count[e] += 1
                    yref[gi, t] += gates[gi, t, r] * expert(e, xg[gi, t])
    np.testing.assert_allclose(y.numpy().reshape(G, g, d), yref,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch,cache", [
    ("granite-moe-1b-a400m", "packed"), ("granite-moe-1b-a400m", "float"),
    ("dbrx-132b", "packed")])
def test_serve_engine_matches_reference_moe(arch, cache):
    eng, reqs = _check_group_parity(arch, _weights(arch), cache, 0)
    assert any(len(set(r.out_tokens)) > 1 for r in reqs)
    cfg = eng.cfg
    L, E, d, h = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    moe = eng.params["layers"]["moe"]
    for name, kn in (("wg", (d, h)), ("wu", (d, h)), ("wd", (h, d))):
        assert moe[name].codes.dtype == torch.uint8
        assert tuple(moe[name].codes.shape) == (L, E) + kn
        assert tuple(moe[name].scale.shape) == (L, E)
    assert tuple(moe["wr"].codes.shape) == (L, d, E)
    assert tuple(moe["wr"].scale.shape) == (L,)


def test_calibrate_and_replay_on_moe():
    """``calibrate()`` records every ``moe.*`` site; requests served before
    and after the swap replay bitwise under their own versions, and
    nothing is prepared again."""
    cfg = dataclasses.replace(
        reduced_config("granite-moe-1b-a400m"), compute_dtype="float32",
        quant=tq.FP8_MGS_SERVE_KV.replace(flush_target=1e-6,
                                          static_q_scale=True))
    eng = ServeEngine(cfg, batch=2, max_len=24, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, 10).astype(np.int32),
                    max_new_tokens=4) for i in range(4)]
    prep0 = dict(PREP_STATS)
    v0 = eng.run(reqs[:2], record_logits=True)["logits"]
    table = eng.calibrate()
    sites = {s for s, _ in table.to_pairs()}
    assert {"moe.wr", "moe.wg", "moe.wu", "moe.wd"} <= sites
    assert {"attn.wq", "attn.q.amax", "logits"} <= sites
    v1 = eng.run(reqs[2:], record_logits=True)["logits"]
    assert [r.table_version for r in reqs] == [0, 0, 1, 1]
    for group, logged in ((reqs[:2], v0), (reqs[2:], v1)):
        for r in group:
            again, st = eng.replay(r, group=group)
            assert again.out_tokens == r.out_tokens
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(st["logits"][r.rid], logged[r.rid]))
    assert PREP_STATS == prep0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_family_b1_shapes(cfg):
    """The chip smoke's traffic (batch 4, 32-token prompts) on ``cfg``
    through the group engine under ``FP8_MGS_SERVE_KV`` calls B1 at
    exactly ``launch.dryrun.family_b1_shapes(cfg)``, with the settings its
    checks use."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(cfg, quant=tq.FP8_MGS_SERVE_KV)
    eng = ServeEngine(cfg, batch=4, max_len=cfg.vision_prefix + 35, seed=0,
                      device="cpu")
    eng.warmup([32], max_new=1)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 32).astype(
        np.int32), max_new_tokens=2) for i in range(4)]
    with cs.recording_b1() as seen:
        eng.run(reqs)
    shapes = dryrun.family_b1_shapes(cfg)
    assert cs.unchecked_b1(seen, shapes) == set()
    assert {c[:5] for c in seen} == {s[1:] for s in shapes}


def check_group_launches(cfg):
    """Phase 4's traffic (8 requests of 32 tokens at batch 4, 16 new
    tokens) on ``cfg`` through the group engine under ``FP8_MGS_SERVE_KV``
    calls B1 and B2 as often as ``launch.dryrun.group_launches(cfg)``
    predicts the card launches them."""
    import importlib
    from repro_torch.models import attention
    cfg = dataclasses.replace(cfg, quant=tq.FP8_MGS_SERVE_KV)
    eng = ServeEngine(cfg, batch=4, max_len=cfg.vision_prefix + 49, seed=0,
                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 32).astype(
        np.int32), max_new_tokens=16) for i in range(8)]
    calls = {"mgs_matmul_exact_fused": 0, "mgs_flash_attention": 0}
    mods = {"mgs_matmul_exact_fused": [importlib.import_module(m) for m in (
        "repro_torch.quant.qmatmul", "repro_torch.kernels.ops")],
        "mgs_flash_attention": [attention]}
    saved = {name: getattr(ms[0], name) for name, ms in mods.items()}

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return call
    try:
        for name, ms in mods.items():
            for m in ms:
                setattr(m, name, counting(name))
        eng.run(reqs)
    finally:
        for name, ms in mods.items():
            for m in ms:
                setattr(m, name, saved[name])
    assert calls == dryrun.group_launches(cfg)[0]


@pytest.mark.parametrize("attn_chunk", [0, 16])
def test_chip_smoke_checks_every_moe_b1_shape(attn_chunk):
    """Full-width granite-moe chunks its prefill attention (``attn_chunk``
    1024): 16 takes that path at the reduced width."""
    check_family_b1_shapes(dataclasses.replace(
        reduced_config("granite-moe-1b-a400m"), attn_chunk=attn_chunk))
