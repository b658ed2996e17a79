"""Port parity for the encoder-decoder (whisper) family: the port's
``_encode`` and cross-attention against ``repro.models``, and whisper
stacks on the group ``ServeEngine``.

* Prepared weights, bitwise: the port's ``prepare_params`` gives the
  reference's ``prepare_params(..., dims=param_dims(cfg))`` codes and
  scales, one scale a layer for the ``encoder`` and ``cross`` stacks too.
* ``_encode`` (non-causal self-attention over the frame embeddings, RoPE at
  0..S-1, the FFN, ``encoder_norm``) with dense scores and with key chunks
  (16 frames padded to 18 keys, the pad masked), and the cross-attention
  (the query roped, the encoder K/V not, no causal mask) over float K/V at
  prefill and decode, against the reference's, unquantized: within 1e-5
  of the scale. The packed cross-attention of decode (B2's twin over
  packed cross planes, the ``encoder_len`` live keys of a padded plane)
  under ``FP8_MGS_SERVE_KV`` against the reference's emulation tier.
* ``quantize_kv`` of an all-zero vector (the cross planes of the engine's
  zero stub) gives the reference's codes and scales, and the cross
  attention over such planes is finite.
* Model level: one jitted reference ``prefill`` and 4 ``decode_step``s of
  reduced whisper with seeded audio embeddings, packed and float cache,
  against the port's on the same weights: tokens equal, logits within the
  engine bar (the residual output projections scaled by 8, so that tokens
  vary). The engine-level comparison with the reference's ``ServeEngine``
  is left out (36 s of its CPU time); the engine's batching is held on the
  dense, MoE and SSM families.
* Inside the port: the group engine == the model-level loop under the zero
  stub, bitwise; a prefill of T tokens and a decode step == a prefill of
  T + 1; the cache layout; ``chip_smoke``'s B1 shapes and launch counts.
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
from repro.models.attention import attention_apply as r_attention  # noqa
from repro.quant import QuantizedKVCache as RQKV  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402
from repro.quant.kvcache import quantize_kv as r_quantize_kv  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.formats import E4M3  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.attention import attention_apply  # noqa: E402
from repro_torch.quant import QuantizedKVCache, prepare_params  # noqa: E402
from repro_torch.quant.kvcache import quantize_kv  # noqa: E402

from test_torch_model import (  # noqa: E402
    check_model_parity, check_prefill_then_decode, engine_matches_model_loop,
    family_cfgs, family_weights, prepared_leaves)
from test_torch_moe import (  # noqa: E402
    check_family_b1_shapes, check_group_launches)

ARCH = "whisper-tiny"


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


def scale_out(params):
    """Seed-0 reduced whisper / internvl2 echo a prompt's last token: the
    residual output projections scaled by 8 make the tokens vary."""
    for root in ("layers", "cross"):
        if root in params:
            params[root]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0


def test_prepared_weights_bitwise_with_reference_dims():
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    tp = prepare_params(params_from_numpy(np_params), tcfg.quant)
    r_pw, t_pw = prepared_leaves(rp), prepared_leaves(tp)
    assert set(r_pw) == set(t_pw) and len(t_pw) == 16
    for path, a in r_pw.items():
        b = t_pw[path]
        assert a.tail == b.tail, path
        np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    assert tuple(t_pw[("encoder", "attn", "wo")].scale.shape) == (
        tcfg.encoder_layers,)
    assert tuple(t_pw[("cross", "attn", "wk")].scale.shape) == (
        tcfg.n_layers,)


def _unquantized():
    tcfg, rcfg = family_cfgs(ARCH, "NONE")
    rparams, np_params = family_weights(tcfg, rcfg)
    return tcfg, rcfg, rparams, params_from_numpy(np_params)


@pytest.mark.parametrize("attn_chunk", [0, 6])
def test_encode_matches_reference(attn_chunk):
    tcfg, rcfg, rparams, tparams = _unquantized()
    tcfg = dataclasses.replace(tcfg, attn_chunk=attn_chunk)
    rcfg = dataclasses.replace(rcfg, attn_chunk=attn_chunk)
    audio = np.random.default_rng(1).normal(
        0, 0.5, (2, tcfg.encoder_len, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, a: rt._encode(p, rcfg, a))(
        rparams, jnp.asarray(audio))
    _close(tt._encode(tparams, tcfg, torch.from_numpy(audio)), want)


def _cross_inputs(tcfg, T, seed=2):
    rng = np.random.default_rng(seed)
    B, S, KV, hd = 2, tcfg.encoder_len, tcfg.n_kv_heads, tcfg.head_dim
    x = rng.normal(0, 1, (B, T, tcfg.d_model)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 5 + T), (B, T)).copy()
    return x, k, v, pos


@pytest.mark.parametrize("T,attn_chunk", [(8, 0), (8, 6), (1, 0)])
def test_cross_attention_float_matches_reference(T, attn_chunk):
    tcfg, rcfg, rparams, tparams = _unquantized()
    tcfg = dataclasses.replace(tcfg, attn_chunk=attn_chunk)
    rcfg = dataclasses.replace(rcfg, attn_chunk=attn_chunk)
    x, k, v, pos = _cross_inputs(tcfg, T)
    rp = jax.tree.map(lambda a: a[1], rparams["cross"]["attn"])
    tp = {n: w[1] for n, w in tparams["cross"]["attn"].items()}
    want, _ = r_attention(rp, jnp.asarray(x), rcfg,
                          positions=jnp.asarray(pos, jnp.int32),
                          cross_kv=RKVCache(jnp.asarray(k), jnp.asarray(v)))
    got, _ = attention_apply(tp, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos),
                             cross_kv=KVCache(torch.from_numpy(k),
                                              torch.from_numpy(v)))
    _close(got, want)


def test_packed_cross_attention_matches_reference():
    """Decode over packed cross planes padded to the chunk (16 frames in
    128 keys): the B2 twin, the pad tail masked."""
    tcfg, rcfg = family_cfgs(ARCH)
    rparams, np_params = family_weights(tcfg, rcfg)
    tcross = prepare_params(params_from_numpy(np_params), tcfg.quant)[
        "cross"]["attn"]
    rcross = rprep.prepare_params(rparams, rcfg.quant,
                                  dims=r_param_dims(rcfg))["cross"]["attn"]
    x, k, v, pos = _cross_inputs(tcfg, 1)
    S, pad = tcfg.encoder_len, tcfg.quant.block_k
    planes = []
    for a in (k, v):
        c, s = quantize_kv(torch.from_numpy(a), E4M3)
        cp = torch.zeros((2, tcfg.n_kv_heads, pad, tcfg.head_dim),
                         dtype=torch.uint8)
        sp = torch.zeros((2, tcfg.n_kv_heads, pad))
        cp[:, :, :S], sp[:, :, :S] = c.transpose(1, 2), s.transpose(1, 2)
        planes.append((cp, sp))
    (kc, ks), (vc, vs) = planes
    got, _ = attention_apply(
        {n: w.slice(0) for n, w in tcross.items()}, torch.from_numpy(x),
        tcfg, positions=torch.from_numpy(pos),
        cross_kv=QuantizedKVCache(kc, vc, ks, vs))
    want, _ = r_attention(
        jax.tree.map(lambda a: a[0], rcross), jnp.asarray(x), rcfg,
        positions=jnp.asarray(pos, jnp.int32),
        cross_kv=RQKV(*(jnp.asarray(t.numpy()) for t in (kc, vc, ks, vs))))
    _close(got, want)


def test_zero_cross_planes_match_reference():
    """The zero stub's encoder output is zero, so are its cross K/V: the
    reference's flushed scale (0) and the code of 0 / 0; attending such
    planes gives an exact zero, no NaN."""
    z = np.zeros((2, 16, 3, 8), np.float32)
    rc, rs = r_quantize_kv(jnp.asarray(z))
    tc, ts = quantize_kv(torch.from_numpy(z))
    np.testing.assert_array_equal(np.asarray(rc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())
    tcfg, _ = family_cfgs(ARCH)
    eng_cache = init_cache(tcfg, 2, 12)
    p = prepare_params(tt.init_params(tcfg, 0), tcfg.quant)["cross"]["attn"]
    x = torch.randn(2, 1, tcfg.d_model)
    kc, ks = quantize_kv(torch.zeros(2, tcfg.encoder_len, tcfg.n_kv_heads,
                                     tcfg.head_dim))
    eng_cache["cross_k"][0, :, :, :tcfg.encoder_len] = kc.transpose(1, 2)
    eng_cache["cross_v"][0, :, :, :tcfg.encoder_len] = kc.transpose(1, 2)
    y, _ = attention_apply({n: w.slice(0) for n, w in p.items()}, x, tcfg,
                           positions=torch.full((2, 1), 3),
                           cross_kv=tt._cross_cache(eng_cache, 0))
    assert torch.equal(y, torch.zeros_like(y))
    assert (kc == 248).all() and (ks == 0).all()


@pytest.mark.parametrize("cache", ["FP8_MGS_SERVE_KV", "FP8_MGS_SERVE"])
def test_prefill_and_decode_match_reference(cache):
    toks = check_model_parity(ARCH, cache, edit=scale_out)
    assert len({int(t) for t in toks.reshape(-1)}) > 1


def test_engine_matches_model_loop():
    eng, _ = engine_matches_model_loop(ARCH)
    assert eng.params["cross"]["attn"]["wq"].codes.dtype == torch.uint8


def test_prefill_then_decode_matches_longer_prefill():
    check_prefill_then_decode(ARCH)


def test_cache_layout():
    """Packed cross planes (L, B, KV, encoder_len rounded up to the chunk,
    hd) uint8 + float32 scales; float ones (L, B, encoder_len, KV, hd)."""
    tcfg, _ = family_cfgs(ARCH)
    L, KV, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    c = init_cache(tcfg, 3, 12)
    assert c["cross_k"].dtype == torch.uint8
    assert tuple(c["cross_k"].shape) == (L, 3, KV, 128, hd)
    assert tuple(c["cross_v_scale"].shape) == (L, 3, KV, 128)
    f = init_cache(dataclasses.replace(tcfg, quant=family_cfgs(
        ARCH, "FP8_MGS_SERVE")[0].quant), 3, 12)
    assert tuple(f["cross_k"].shape) == (L, 3, tcfg.encoder_len, KV, hd)
    assert f["cross_k"].dtype == torch.bfloat16
    assert "cross_k_scale" not in f
    assert init_cache(reduced_config(ARCH), 3, 12)["k"].shape[0] == L


@pytest.mark.parametrize("attn_chunk", [0, 6])
def test_chip_smoke_checks_every_encdec_b1_shape(attn_chunk):
    """Full-width whisper chunks its 1500 frames (``attn_chunk`` 1024,
    padded to 2048): 6 takes that path at the reduced width (16 -> 18)."""
    check_family_b1_shapes(dataclasses.replace(reduced_config(ARCH),
                                               attn_chunk=attn_chunk))


def test_chip_smoke_predicts_encdec_launches():
    check_group_launches(dataclasses.replace(reduced_config(ARCH),
                                             attn_chunk=6))
