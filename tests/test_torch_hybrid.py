"""Port parity for the hybrid (jamba) family: the port's
``_hybrid_group_body`` and hybrid stacks against ``repro.models``, on the
group ``ServeEngine``.

* Prepared weights, bitwise: the port's ``prepare_params(...,
  hybrid=True)`` gives the reference's ``prepare_params(..., dims=
  param_dims(cfg))`` codes and scales: one scale per group for the
  attention, per (group, sublayer) for the Mamba / FFN weights and the
  router, per (group, sublayer, expert) for the experts.
* ``_hybrid_group_body`` (one period: attention, then Mamba, with the FFN
  and MoE alternating) against the reference's, unquantized: prefill, and
  a decode step from the prefill's caches, within 1e-5 of the scale.
* Model level: one jitted reference ``prefill`` and 4 ``decode_step``s of
  reduced jamba (two groups, float32 compute, packed cache) against the
  port's on the same weights: greedy tokens equal, logits within the
  engine bar of ``tests/test_torch_model.py``. Two groups cost no more
  than one here: the reference scans over groups (one compiled body), and
  the prepared-weight test before it has compiled the same shapes. Float32 compute: the
  reference's bfloat16 MoE / hybrid graphs do not run on XLA:CPU (ROADMAP
  queue C). The engine-level comparison with the reference's
  ``ServeEngine`` is left out (75 s of its CPU time); the engine's batching
  is held on the dense, MoE and SSM families.
* Inside the port: the group engine's logits are bitwise the model-level
  loop's; a prefill of T tokens and a decode step match a prefill of
  T + 1; the cache layout.
* ``chip_smoke.family_b1_shapes`` / ``group_launches`` are the shapes and
  the count of the engine's B1 calls under the smoke's traffic.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import param_dims as r_param_dims  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.models.attention import KVCache as RKVCache  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import cast_params, init_cache  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.quant import PreparedWeight, prepare_params  # noqa: E402

from test_torch_model import (  # noqa: E402
    check_model_parity, check_prefill_then_decode, engine_matches_model_loop,
    family_cfgs, family_weights, prepared_leaves)
from test_torch_moe import (  # noqa: E402
    check_family_b1_shapes, check_group_launches)

ARCH = "jamba-1.5-large-398b"
ONE_GROUP = dict(n_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


def test_prepared_weights_bitwise_with_reference_dims():
    """Reduced jamba (2 groups x 2 sublayers, 4 experts)."""
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    tp = prepare_params(params_from_numpy(np_params), tcfg.quant,
                        hybrid=True)
    r_pw, t_pw = prepared_leaves(rp), prepared_leaves(tp)
    assert set(r_pw) == set(t_pw) and len(t_pw) == 18
    for path, a in r_pw.items():
        b = t_pw[path]
        assert a.tail == b.tail, path
        np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    G, per, E = 2, 2, tcfg.n_experts
    want = {("layers", "attn", "wq"): (G,), ("layers", "ssm", "wx"): (G, 1),
            ("layers", "ffn", "wg"): (G, 1), ("layers", "moe", "wr"): (G, 1),
            ("layers", "moe", "wg"): (G, 1, E)}
    for path, shape in want.items():
        assert tuple(t_pw[path].scale.shape) == shape, path
    # one (group, sublayer, expert) slice: PreparedWeight.slice per axis
    wg = tp["layers"]["moe"]["wg"].slice(1).slice(0).slice(2)
    assert wg.codes.shape == (tcfg.d_model, tcfg.d_ff) and wg.scale.dim() == 0
    assert per == tcfg.attn_every


def _group(tree, i=0):
    if isinstance(tree, dict):
        return {k: _group(v, i) for k, v in tree.items()}
    return tree[i]


def test_hybrid_group_body_matches_reference():
    """One period, unquantized: a prefill of 8 tokens over a float KV
    cache, then one decode step from its attention and SSM caches."""
    tcfg, rcfg = family_cfgs(ARCH, "NONE", **ONE_GROUP)
    rparams, np_params = family_weights(tcfg, rcfg)
    rpg = _group(rparams["layers"])
    tpg = _group(params_from_numpy(np_params)["layers"])
    B, T, S = 2, 8, 12
    KV, hd = tcfg.n_kv_heads, tcfg.head_dim
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, T + 1, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T + 1), (B, T + 1))

    # the reference's body jitted (eager it takes ~10x as long here)
    r_pre = jax.jit(lambda pg, x, p, kv: rt._hybrid_group_body(
        pg, x, p, rcfg, kv, 0, None, decode=False))
    r_dec = jax.jit(lambda pg, x, p, kv, sc: rt._hybrid_group_body(
        pg, x, p, rcfg, kv, T, sc, decode=True))
    rkv = RKVCache(jnp.zeros((B, S, KV, hd)), jnp.zeros((B, S, KV, hd)))
    ry, rkv, rssm, _ = r_pre(rpg, jnp.asarray(x[:, :T]),
                             jnp.asarray(pos[:, :T], jnp.int32), rkv)
    tkv = KVCache(torch.zeros(B, S, KV, hd), torch.zeros(B, S, KV, hd))
    ty, tssm = tt._hybrid_group_body(
        tpg, torch.from_numpy(x[:, :T]), torch.from_numpy(pos[:, :T].copy()),
        tcfg, tkv, 0, None, decode=False)
    _close(ty, ry)
    _close(tssm.h, rssm.h)
    _close(tssm.conv, rssm.conv)
    _close(tkv.k, rkv.k)

    rd, _, rdssm, _ = r_dec(rpg, jnp.asarray(x[:, T:]),
                            jnp.asarray(pos[:, T:], jnp.int32), rkv, rssm)
    td, tdssm = tt._hybrid_group_body(
        tpg, torch.from_numpy(x[:, T:]), torch.from_numpy(pos[:, T:].copy()),
        tcfg, tkv, T, tssm, decode=True)
    _close(td, rd)
    _close(tdssm.h, rdssm.h)
    _close(tdssm.conv, rdssm.conv)


def test_prefill_and_decode_match_reference():
    toks = check_model_parity(ARCH)
    assert len({int(t) for t in toks.reshape(-1)}) > 2


def test_engine_matches_model_loop():
    eng, _ = engine_matches_model_loop(ARCH, **ONE_GROUP)
    assert isinstance(eng.params["layers"]["moe"]["wd"], PreparedWeight)


def test_prefill_then_decode_matches_longer_prefill():
    check_prefill_then_decode(ARCH, **ONE_GROUP)


def test_cache_layout_and_cast():
    """Attention planes one a group; ``ssm_h`` (G, sub, B, d_inner, N) in
    float32, ``ssm_conv`` (G, sub, B, d_conv - 1, d_inner) in bfloat16;
    ``A_log`` stays float32 under a bfloat16 compute dtype (jamba's own
    parameters are drawn in bfloat16, as the reference's)."""
    cfg = reduced_config(ARCH)
    G, sub = 2, cfg.attn_every - 1
    cache = init_cache(cfg, 3, 20)
    assert set(cache) == {"pos", "k", "v", "ssm_h", "ssm_conv"}
    assert tuple(cache["k"].shape) == (G, 3, 20, cfg.n_kv_heads,
                                       cfg.head_dim)
    assert tuple(cache["ssm_h"].shape) == (G, sub, 3, cfg.d_inner,
                                           cfg.ssm_state)
    assert cache["ssm_h"].dtype == torch.float32
    assert tuple(cache["ssm_conv"].shape) == (G, sub, 3, cfg.d_conv - 1,
                                              cfg.d_inner)
    assert cache["ssm_conv"].dtype == torch.bfloat16
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    cast = cast_params(tt.init_params(f32, 0), f32)["layers"]
    assert cast["ssm"]["A_log"].dtype == torch.float32
    assert cast["ssm"]["wx"].dtype == torch.bfloat16
    assert cast["ln_mix"].shape == (G, cfg.attn_every, cfg.d_model)


def test_chip_smoke_checks_every_hybrid_b1_shape():
    check_family_b1_shapes(reduced_config(ARCH))


def test_chip_smoke_predicts_hybrid_launches():
    check_group_launches(dataclasses.replace(reduced_config(ARCH),
                                             attn_chunk=16))
