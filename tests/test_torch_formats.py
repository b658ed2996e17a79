"""Port parity: bit-level FP8 codecs (repro_torch.core.formats vs
repro.core.formats), bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FMTS = ["e4m3", "e3m4", "e5m2"]


def _exp2_exact_in_reference(exps):
    """XLA:CPU's exp2 is a few ulps off at some integer arguments with
    |x| >= 13; only E5M2's binade scales reach them."""
    e = np.asarray(exps, np.float32)
    return np.asarray(jnp.exp2(e)) == np.exp2(e.astype(np.float64))


@pytest.mark.parametrize("name", FMTS)
def test_all_codes_decode_bitwise(name):
    rfmt, tfmt = rf.get_format(name), tf.get_format(name)
    codes = np.arange(256, dtype=np.uint8)
    sm_r, e_r = rf.decode_sm_e(jnp.asarray(codes), rfmt)
    sm_t, e_t = tf.decode_sm_e(torch.from_numpy(codes), tfmt)
    np.testing.assert_array_equal(np.asarray(sm_r), sm_t.numpy())
    np.testing.assert_array_equal(np.asarray(e_r), e_t.numpy())
    v_r = np.asarray(rf.decode_bits(jnp.asarray(codes), rfmt))
    v_t = tf.decode_bits(torch.from_numpy(codes), tfmt).numpy()
    # the port's values are exact: sm * 2**(max(e,1) - bias - mbits)
    e = e_t.numpy()
    exact = (sm_t.numpy().astype(np.float64)
             * 2.0 ** (np.maximum(e, 1) - tfmt.bias - tfmt.mbits))
    np.testing.assert_array_equal(v_t, exact.astype(np.float32))
    ok = _exp2_exact_in_reference(np.maximum(e, 1) - tfmt.bias - tfmt.mbits)
    np.testing.assert_array_equal(v_r[ok], v_t[ok])
    if name in ("e4m3", "e3m4"):
        assert ok.all()
    # where the reference's exp2 is inexact (E5M2 only) its decoded values
    # are off by up to 8 ulp of float32 (the exp2 error, not the format)
    np.testing.assert_allclose(v_r[~ok], v_t[~ok], rtol=1e-6)


@pytest.mark.parametrize("name", FMTS)
def test_encode_roundtrip_bitwise(name):
    rfmt, tfmt = rf.get_format(name), tf.get_format(name)
    vals = tf.representable_values(tfmt).astype(np.float32)
    vals = np.concatenate([vals, -vals[1:]])
    c_r = np.asarray(rf.encode_bits(jnp.asarray(vals), rfmt))
    c_t = tf.encode_bits(torch.from_numpy(vals), tfmt).numpy()
    np.testing.assert_array_equal(c_r, c_t)
    back = tf.decode_bits(torch.from_numpy(c_t), tfmt).numpy()
    np.testing.assert_array_equal(back, vals)
    # -0.0 encodes as +0 (0x00), unlike torch.float8_e4m3fn's 0x80
    assert int(tf.encode_bits(torch.tensor([-0.0]), tfmt)[0]) == 0
    sm_r, e_r = rf.decompose(jnp.asarray(vals), rfmt)
    sm_t, e_t = tf.decompose(torch.from_numpy(vals), tfmt)
    np.testing.assert_array_equal(np.asarray(sm_r), sm_t.numpy())
    np.testing.assert_array_equal(np.asarray(e_r), e_t.numpy())


def _sweep(fmt):
    rng = np.random.default_rng(7)
    rep = tf.representable_values(fmt)
    mids = (rep[1:] + rep[:-1]) / 2            # RNE ties
    sub = rng.uniform(0, fmt.min_subnormal * 4, 200)
    wide = rng.standard_normal(2000) * np.exp2(
        rng.integers(-12, 12, 2000).astype(np.float64))
    special = np.array([0.0, -0.0, fmt.max_finite, fmt.max_finite * 1.01,
                        fmt.max_finite * 4, 1e30, np.inf, -np.inf, np.nan,
                        np.finfo(np.float32).tiny, 1e-40])
    x = np.concatenate([rep, mids, np.nextafter(mids, 0), sub, wide,
                        special])
    return np.concatenate([x, -x]).astype(np.float32)


@pytest.mark.parametrize("name", FMTS)
def test_round_to_format_sweep_bitwise(name):
    rfmt, tfmt = rf.get_format(name), tf.get_format(name)
    x = _sweep(tfmt)
    r_r = np.asarray(rf.round_to_format(jnp.asarray(x), rfmt))
    r_t = tf.round_to_format(torch.from_numpy(x), tfmt).numpy()
    assert np.isnan(r_t).sum() == np.isnan(x).sum()
    ax = np.abs(x[np.isfinite(x) & (x != 0)])
    binade = np.clip(np.floor(np.log2(ax)), tfmt.emin_unbiased,
                     tfmt.emax_unbiased) - tfmt.mbits
    ok = np.ones_like(x, bool)
    ok[np.isfinite(x) & (x != 0)] = _exp2_exact_in_reference(binade)
    if name in ("e4m3", "e3m4"):
        assert ok.all()
    np.testing.assert_array_equal(r_r[ok], r_t[ok])
    # signed zeros are kept bitwise too
    np.testing.assert_array_equal(np.signbit(r_r[ok]), np.signbit(r_t[ok]))
    # every finite port output is representable (the reference's E5M2
    # quanta at inexact-exp2 binades are not, which is why those are
    # compared only here)
    rep = tf.representable_values(tfmt)
    fin = r_t[np.isfinite(r_t)]
    assert np.isin(np.abs(fin).astype(np.float64), rep).all()


def test_bf16_input_roundtrip():
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32) * 30
    xr = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    r_r = np.asarray(rf.round_to_format(xr, rf.E4M3).astype(jnp.float32))
    r_t = tf.round_to_format(xt, tf.E4M3)
    assert r_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(r_r, r_t.float().numpy())
