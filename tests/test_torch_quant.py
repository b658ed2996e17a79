"""Port parity: quantizers, the packed KV cache and prepared weights —
codes and scales bitwise.

Division lowering: the reference's compiled graph (every call site runs
under ``jax.jit``) turns a divide by a constant (``amax / max_finite``)
into a multiply by the float32 reciprocal, while ``x / scale`` by a
runtime scale stays a true division. The port matches the compiled
lowering, so reference functions that are not themselves jitted
(``quantize_kv``, ``append_kv``) are compared under ``jax.jit``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.core.formats import E4M3 as R_E4M3  # noqa: E402
from repro.models import init_params as r_init_params  # noqa: E402
from repro.quant import kvcache as rkv  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402
from repro.quant.config import FP8_MGS_SERVE_KV as R_KV  # noqa: E402
from repro.quant.quantize import quantize_fp8 as r_q  # noqa: E402
from repro.quant.quantize import quantize_fp8_static as r_qs  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.formats import E4M3, encode_bits  # noqa: E402
from repro_torch.quant import kvcache as tkv  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_KV  # noqa: E402
from repro_torch.quant.quantize import (  # noqa: E402
    quantize_fp8, quantize_fp8_static)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale
            * np.exp2(rng.integers(-4, 4, shape))).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 1, -1])
def test_quantize_fp8_bitwise(axis):
    x = _x((37, 129))
    qr = r_q(jnp.asarray(x), R_E4M3, axis=axis)
    qt = quantize_fp8(torch.from_numpy(x), E4M3, axis=axis)
    np.testing.assert_array_equal(np.asarray(qr.scale), qt.scale.numpy())
    np.testing.assert_array_equal(np.asarray(qr.q), qt.q.numpy())


def test_quantize_fp8_scale_is_reciprocal_multiply():
    """Which lowering the port matches: amax * float32(1/448), not the
    correctly rounded amax / 448 (they differ for this input)."""
    x = _x((8, 64), seed=3)
    amax = np.float32(np.abs(x).max())
    qr = r_q(jnp.asarray(x), R_E4M3)
    assert np.float32(qr.scale) == amax * (np.float32(1) / np.float32(448))
    qt = quantize_fp8(torch.from_numpy(x), E4M3)
    assert qt.scale.item() == np.float32(qr.scale)


def test_quantize_fp8_batched_slices_bitwise():
    """Per-slice scales over a leading axis == the reference vmap."""
    x = _x((5, 7, 33), seed=4)
    qr = jax.vmap(lambda s: r_q(s, R_E4M3))(jnp.asarray(x))
    qt = quantize_fp8(torch.from_numpy(x), E4M3, axis=(1, 2))
    np.testing.assert_array_equal(np.asarray(qr.scale),
                                  qt.scale.reshape(-1).numpy())
    np.testing.assert_array_equal(np.asarray(qr.q), qt.q.numpy())


@pytest.mark.parametrize("amax", ["row", 2.5, "per_row"])
def test_quantize_fp8_static_bitwise(amax):
    x = _x((6, 48), seed=5)
    if amax == "row":
        a = float(np.abs(x).max())      # a row whose absmax equals amax
    elif amax == "per_row":
        a = (np.abs(x).max(axis=1, keepdims=True) * 0.8).astype(np.float32)
    else:
        a = amax
    qr = r_qs(jnp.asarray(x), R_E4M3, jnp.asarray(a, jnp.float32))
    qt = quantize_fp8_static(torch.from_numpy(x), E4M3,
                             torch.as_tensor(a, dtype=torch.float32))
    np.testing.assert_array_equal(np.asarray(qr.scale), qt.scale.numpy())
    np.testing.assert_array_equal(np.asarray(qr.q), qt.q.numpy())


def test_quantize_kv_bitwise():
    x = _x((2, 5, 3, 16), seed=6)
    cr, sr = jax.jit(rkv.quantize_kv, static_argnums=1)(jnp.asarray(x),
                                                         R_E4M3)
    ct, st = tkv.quantize_kv(torch.from_numpy(x), E4M3)
    np.testing.assert_array_equal(np.asarray(cr), ct.numpy())
    np.testing.assert_array_equal(np.asarray(sr), st.numpy())


def test_append_kv_bitwise_and_frozen():
    B, KV, S, hd = 2, 3, 16, 8
    kn, vn = _x((B, 6, KV, hd), 7), _x((B, 6, KV, hd), 8)
    k1, v1 = _x((B, 1, KV, hd), 9), _x((B, 1, KV, hd), 10)
    app = jax.jit(rkv.append_kv, static_argnums=(3, 4))
    rc = rkv.init_quantized_kv((B,), KV, S, hd)
    rc = app(rc, jnp.asarray(kn), jnp.asarray(vn), 0, R_E4M3)
    rc = app(rc, jnp.asarray(k1), jnp.asarray(v1), 6, R_E4M3)
    tc = tkv.init_quantized_kv((B,), KV, S, hd)
    tkv.append_kv(tc, torch.from_numpy(kn), torch.from_numpy(vn), 0, E4M3)
    before = [p.clone() for p in tc]
    tkv.append_kv(tc, torch.from_numpy(k1), torch.from_numpy(v1), 6, E4M3)
    for a, b in zip(rc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # old entries are bit-frozen by the in-place append
    for a, b in zip(before, tc):
        assert torch.equal(a[:, :, :6], b[:, :, :6])


def _pws(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pws(v, path + (k,))
    elif hasattr(tree, "codes") and hasattr(tree, "scale"):
        yield path, tree


def test_prepared_params_bitwise_via_convert():
    """A numpy tree in the reference ``init_params`` layout (shapes and
    logical dims from an abstract trace, values from a numpy seed)."""
    cfg = r_reduced("deepseek-7b")
    box = {}

    def trace(key):
        p, d = r_init_params(cfg, key)
        box["dims"] = d
        return p

    shapes = jax.eval_shape(trace, jax.random.PRNGKey(0))
    dims = box["dims"]
    rng = np.random.default_rng(12)
    np_params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32),
        shapes)
    params = jax.tree.map(jnp.asarray, np_params)
    rp = rprep.prepare_params(params, R_KV, dims=dims)
    rp = rprep.prepare_logits_head(rp, R_KV, tied=cfg.tie_embeddings)
    tp = params_from_numpy(np_params)
    n0 = tprep.PREP_STATS["prepared"]
    tq = tprep.prepare_params(tp, FP8_MGS_SERVE_KV)
    tq = tprep.prepare_logits_head(tq, FP8_MGS_SERVE_KV,
                                   tied=cfg.tie_embeddings)
    r_pw, t_pw = dict(_pws(rp)), dict(_pws(tq))
    assert set(r_pw) == set(t_pw) and len(t_pw) == 8
    assert tprep.PREP_STATS["prepared"] == n0 + 8
    for path, a in r_pw.items():
        b = t_pw[path]
        assert a.tail == b.tail, path
        np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    # raw leaves convert unchanged; preparing again is a cache hit
    np.testing.assert_array_equal(np_params["embed"], tp["embed"].numpy())
    hits = tprep.PREP_STATS["cache_hits"]
    tprep.prepare_params(tp, FP8_MGS_SERVE_KV)
    assert tprep.PREP_STATS["prepared"] == n0 + 8
    assert tprep.PREP_STATS["cache_hits"] == hits + 7


def test_prepared_weight_codes_decode_to_quantized_values():
    w = torch.from_numpy(_x((3, 40, 24), seed=11))
    pw = tprep.prepare_weight(w, FP8_MGS_SERVE_KV.replace(per_channel=True),
                              stack_ndim=1)
    assert pw.codes.shape == (3, 40, 24) and pw.scale.shape == (3, 1, 24)
    q = quantize_fp8(w[1], E4M3, axis=0)
    assert torch.equal(pw.slice(1).codes, encode_bits(q.q, E4M3))
    assert torch.equal(pw.slice(1).values(), q.q)
