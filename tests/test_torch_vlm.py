"""Port parity for the vision-prefix decoder (internvl2) family on the
group ``ServeEngine``.

* Model level, per layer: a prefill (seeded patch embeddings before the
  tokens; positions and ``cache["pos"]`` count them) and 4 decode steps
  of reduced internvl2 (float32 compute, packed cache, the residual
  output projections scaled by 8 so that tokens vary), each layer and the
  logits head run in both packages on the reference's own input (its
  residual stream), each layer's own contribution (output less input) and
  the head's logits within 5% (max) and 1% (mean) of the reference's
  scale; a planted fault (the prefix left out of the positions) fails
  that bar. Whole-model logits are not held to the bar: on this traffic
  the port's prefill logits are 5.09% (max) / 1.41% (mean) of the scale
  off the reference's, and the reference's own eager and jitted prefills
  differ by 6.78% / 2.02%, so a last-ulp ``exp`` / ``rsqrt`` difference
  that flips one FP8 code compounds through the layers (the gemma3-27b
  case of ``tests/test_torch_continuous_archs.py``). The engine-level
  comparison with the reference's ``ServeEngine`` is left out (36 s of
  its CPU time); the engine's batching is held on the dense, MoE and SSM
  families.
* Prepared weights bitwise against the reference's ``prepare_params(...,
  dims=param_dims(cfg))``.
* Inside the port: the group engine (zero patch embeddings, as the
  reference's stub) == the model-level loop, bitwise; a prefill of T
  tokens and a decode step == a prefill of T + 1; the cache must hold the
  prefix: ``warmup`` and ``run`` refuse a bucket that fits ``max_len``
  only without it, naming the prefix.
* ``chip_smoke``'s B1 shapes (the projections over prefix + prompt rows)
  and launch counts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import param_dims as r_param_dims  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.models.common import rms_norm as r_rms_norm  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models import init_cache, prefill  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.quant import prepare_params  # noqa: E402

from test_torch_continuous_archs import _bar, _holds  # noqa: E402
from test_torch_encdec import scale_out  # noqa: E402
from test_torch_model import (  # noqa: E402
    check_prefill_then_decode, engine_matches_model_loop, family_cfgs,
    family_weights, port_serving_params, prepared_leaves, side_inputs)
from test_torch_moe import (  # noqa: E402
    check_family_b1_shapes, check_group_launches)

ARCH = "internvl2-2b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vlm_per_layer(steps=4, T=8, B=2, prefix_fault=False):
    """The prefill and ``steps`` greedy decode steps of
    ``check_model_parity``'s traffic, layer by layer in both packages on
    the reference's residual stream (the decode tokens are the
    reference's greedy ones). Returns the ``_bar`` of every prefill layer,
    decode layer and logits head, and the tokens. ``prefix_fault`` runs
    the port with the prefix left out of the positions (the tokens
    restart at 0; decode positions and cache writes P lower)."""
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg, scale_out)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    rp = rt._cast_params(rprep.prepare_logits_head(
        rp, rcfg.quant, tied=rcfg.tie_embeddings), rcfg)
    tp = port_serving_params(np_params, tcfg)
    P = tcfg.vision_prefix
    toks = np.random.default_rng(0).integers(1, tcfg.vocab, (B, T))
    ve = side_inputs(tcfg, B, 0)["vision_embeds"]
    max_len = P + T + steps + 1
    body = jax.jit(lambda pl, x, pos, isg, kvl, cp: rt._dense_body(
        pl, x, pos, rcfg, isg, kvl, cp, None, None)[:2])
    pre_body = jax.jit(lambda pl, x, pos, isg, kvl: rt._dense_body(
        pl, x, pos, rcfg, isg, kvl, 0, None, None)[:2])
    head = jax.jit(lambda x: rt._logits(rp, rcfg, r_rms_norm(
        x[:, -1:], rp["final_norm"], rcfg.norm_eps))[:, 0])
    flags = rt._global_flags(rcfg)
    rcache = rt.init_cache(rcfg, B, max_len)[0]
    tcache = init_cache(tcfg, B, max_len)
    bars = {"prefill": [], "decode": [], "head": []}
    out = []
    shift = P if prefix_fault else 0

    def run(x, pos_r, pos_t, cp, phase):
        nonlocal rcache
        kvs = rt._kv_stack(rcache)
        new = []
        for layer in range(rcfg.n_layers):
            isg = tcfg.layer_is_global_attn(layer)
            assert bool(flags[layer]) == isg
            args = (jax.tree.map(lambda a: a[layer], rp["layers"]), x,
                    pos_r, flags[layer],
                    jax.tree.map(lambda a: a[layer], kvs))
            y, kv = body(*args, cp) if cp else pre_body(*args)
            yt = tt._dense_body(tt.layer_params(tp["layers"], layer),
                                torch.from_numpy(np.array(x)), pos_t, tcfg,
                                isg, tt._layer_cache(tcache, layer),
                                max(cp - shift, 0))
            bars[phase].append(_bar(yt.numpy(), np.asarray(y),
                                    np.asarray(x)))
            new.append(kv)
            x = y
        rcache = dict(rcache, **rt._kv_entries(jax.tree.map(
            lambda *a: jnp.stack(a), *new)))
        rl = np.asarray(head(x))
        xt = rms_norm(torch.from_numpy(np.array(x[:, -1:])),
                      tp["final_norm"], tcfg.norm_eps)
        tl = tt._logits(tp, tcfg, xt)[:, 0].numpy()
        scale = np.abs(rl).max()
        err = np.abs(tl - rl)
        bars["head"].append((err.max() / scale, err.mean() / scale))
        out.append(rl.argmax(-1))
        return out[-1]

    x = rt._embed_tokens(rp, rcfg, jnp.asarray(toks, jnp.int32))
    np.testing.assert_array_equal(
        tt._embed_tokens(tp, tcfg, torch.from_numpy(toks)).numpy(),
        np.asarray(x))
    x = jnp.concatenate([jnp.asarray(ve), x], axis=1)
    S = P + T
    pos_t = torch.arange(S)[None].expand(B, S)
    if prefix_fault:
        pos_t = torch.cat([torch.arange(P), torch.arange(T)])[None].expand(
            B, S)
    tok = run(x, jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None],
                                  (B, S)), pos_t, 0, "prefill")
    for step in range(steps):
        pos = S + step
        x = rt._embed_tokens(rp, rcfg, jnp.asarray(tok[:, None], jnp.int32))
        tok = run(x, jnp.full((B, 1), pos, jnp.int32),
                  torch.full((B, 1), pos - shift, dtype=torch.int64), pos,
                  "decode")
    return bars, np.stack(out, 1)


def test_prefill_and_decode_match_reference():
    """Every layer's own contribution and the head's logits, at prefill and
    at each decode step, within 5% (max) and 1% (mean) of the
    reference's (module docstring)."""
    bars, toks = _vlm_per_layer()
    assert len({int(t) for t in toks.reshape(-1)}) > 2
    for phase, got in bars.items():
        for j, bar in enumerate(got):
            assert _holds(bar), (phase, j, bar)


def test_per_layer_bar_catches_a_prefix_fault():
    """The bar above fails, at prefill and at decode, when the port leaves
    the vision prefix out of the positions."""
    bars, _ = _vlm_per_layer(steps=1, prefix_fault=True)
    for phase in ("prefill", "decode"):
        assert not all(_holds(bar) for bar in bars[phase]), phase


def test_prepared_weights_bitwise_with_reference_dims():
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    tp = prepare_params(params_from_numpy(np_params), tcfg.quant)
    r_pw, t_pw = prepared_leaves(rp), prepared_leaves(tp)
    assert set(r_pw) == set(t_pw) and len(t_pw) == 7
    for path, a in r_pw.items():
        np.testing.assert_array_equal(np.asarray(a.codes),
                                      t_pw[path].codes.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale),
                                      t_pw[path].scale.numpy())


def test_engine_matches_model_loop():
    eng, reqs = engine_matches_model_loop(ARCH)
    assert eng.max_len == eng.cfg.vision_prefix + 12


def test_prefill_then_decode_matches_longer_prefill():
    check_prefill_then_decode(ARCH)


def test_prefix_counts_in_positions_and_cache():
    """The prefix takes cache positions 0..P-1: after a prefill of T tokens
    ``pos`` is P + T and the packed planes hold P + T written entries
    (random patch embeddings: the engine's zero stub gives zero keys,
    whose scale is zero)."""
    tcfg, _ = family_cfgs(ARCH)
    P, T = tcfg.vision_prefix, 5
    eng = ServeEngine(tcfg, batch=2, max_len=P + T + 3, device="cpu")
    batch = eng._make_batch(np.ones((2, T), np.int64))
    assert tuple(batch["vision_embeds"].shape) == (2, P, tcfg.d_model)
    assert batch["vision_embeds"].dtype == torch.bfloat16
    assert not batch["vision_embeds"].any()
    batch["vision_embeds"] = torch.randn(2, P, tcfg.d_model)
    _, cache = prefill(eng.params, tcfg, batch,
                       init_cache(tcfg, 2, P + T + 3))
    assert cache["pos"] == P + T
    written = (cache["k_scale"][0, 0, 0] > 0).sum().item()
    assert written == P + T


def test_max_len_check_counts_the_prefix():
    tcfg, _ = family_cfgs(ARCH)
    P = tcfg.vision_prefix
    eng = ServeEngine(tcfg, batch=2, max_len=12, device="cpu")
    assert P + 8 + 1 > 12 >= 8 + 1
    with pytest.raises(ValueError, match=f"{P}-token vision prefix"):
        eng.warmup([8], max_new=1)
    reqs = [Request(rid=0, prompt=np.arange(1, 9), max_new_tokens=2)]
    with pytest.raises(ValueError, match="vision prefix"):
        eng.run(reqs)
    # warmup's 2 decode steps fill the cache; a run of 2 new tokens takes
    # one decode step
    ok = ServeEngine(tcfg, batch=2, max_len=P + 8 + 2, device="cpu")
    assert ok.warmup([8], max_new=2) == [8]
    with pytest.raises(ValueError, match="vision prefix"):
        ok.warmup([8], max_new=3)
    tight = ServeEngine(tcfg, batch=2, max_len=P + 8 + 1, device="cpu")
    tight.run(reqs)
    assert len(reqs[0].out_tokens) == 2


def test_chip_smoke_checks_every_vlm_b1_shape():
    check_family_b1_shapes(reduced_config(ARCH))


def test_chip_smoke_predicts_vlm_launches():
    """The prefix + prompt rows (8 + 32) in 16-key chunks: 3 score / value
    pairs a layer."""
    check_group_launches(dataclasses.replace(reduced_config(ARCH),
                                             attn_chunk=16))
