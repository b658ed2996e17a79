"""Port parity: the B1 twin (exact limb-fused matmul) against the
reference Pallas kernel in interpret mode, at a ragged shape.

Bitwise with no epilogue, with a scale row, and at ``flush_period=1``.
With scale *and* bias the reference's CPU run contracts
``r * scale + bias`` into one fused multiply-add (XLA:CPU does; the
kernel contract — and the port, on both devices — is two roundings), so
there the port is held bitwise to the two-rounding composition and the
reference to within that one rounding. ``silu``/``gelu`` pass through
``exp``/``tanh``, which XLA:CPU and PyTorch implement differently: within
a few float32 ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_matmul import (  # noqa: E402
    limb_decompose as r_limbs, mgs_matmul_exact_fused_pallas)
from repro.kernels.ref import mgs_matmul_ref as r_ref  # noqa: E402

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    limb_decompose, mgs_matmul_exact_fused, mgs_matmul_exact_fused_plain,
    worst_case_flush_period)
from repro_torch.kernels.ops import mgs_matmul  # noqa: E402
from repro_torch.kernels.ref import mgs_matmul_ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M, K, N = 5, 300, 70


def _codes(shape, fmt, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 40
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    v = np.asarray(rf.round_to_format(jnp.asarray(x), rf.get_format(fmt)))
    return np.asarray(rf.encode_bits(jnp.asarray(v), rf.get_format(fmt)))


def _ref(xc, wc, fmt="e4m3", **kw):
    return np.asarray(mgs_matmul_exact_fused_pallas(
        jnp.asarray(xc), jnp.asarray(wc), rf.get_format(fmt),
        interpret=True, **kw))


def _port(xc, wc, fmt="e4m3", **kw):
    return mgs_matmul_exact_fused(torch.from_numpy(xc), torch.from_numpy(wc),
                                  tf.get_format(fmt), **kw).numpy()


@pytest.fixture(scope="module")
def operands():
    return _codes((M, K), "e4m3", 0), _codes((K, N), "e4m3", 1)


@pytest.mark.parametrize("fmt", ["e4m3", "e3m4"])
def test_no_epilogue_bitwise(fmt):
    xc, wc = _codes((M, K), fmt, 2), _codes((K, N), fmt, 3)
    np.testing.assert_array_equal(_ref(xc, wc, fmt), _port(xc, wc, fmt))


def test_scale_row_bitwise(operands):
    xc, wc = operands
    s = (np.random.default_rng(4).uniform(0.5, 2, N) * 1e-3
         ).astype(np.float32)
    np.testing.assert_array_equal(_ref(xc, wc, scale=s),
                                  _port(xc, wc, scale=torch.from_numpy(s)))


def test_scale_and_bias(operands):
    xc, wc = operands
    rng = np.random.default_rng(5)
    s = np.float32(0.0123)
    b = (rng.standard_normal(N) * 3).astype(np.float32)
    plain = _ref(xc, wc)
    port = _port(xc, wc, scale=torch.tensor(s), bias=torch.from_numpy(b))
    np.testing.assert_array_equal(port, (plain * s) + b)   # two roundings
    ref = _ref(xc, wc, scale=s, bias=b)
    fma = (plain.astype(np.float64) * s + b).astype(np.float32)
    np.testing.assert_array_equal(ref, fma)   # the reference's CPU FMA
    np.testing.assert_array_max_ulp(ref, port, maxulp=1)


def test_flush_period_one_bitwise(operands):
    xc, wc = operands
    np.testing.assert_array_equal(_ref(xc, wc, flush_period=1),
                                  _port(xc, wc, flush_period=1))
    # a mid-K flush does change bits somewhere vs the single final flush
    xl, wl = _codes((8, 1024), "e4m3", 6), _codes((1024, 64), "e4m3", 7)
    once, every = _port(xl, wl), _port(xl, wl, flush_period=1)
    np.testing.assert_array_equal(_ref(xl, wl, flush_period=1), every)
    assert np.abs(once - every).max() < 1e-3 * np.abs(once).max()


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activation_epilogue(operands, act):
    xc, wc = operands
    s = np.float32(2e-4)
    ref = _ref(xc, wc, scale=s, activation=act)
    port = _port(xc, wc, scale=torch.tensor(s), activation=act)
    if act == "relu":
        np.testing.assert_array_equal(ref, port)
    else:
        np.testing.assert_allclose(port, ref, rtol=4e-6, atol=1e-6)


def test_batched_slices_equal_per_slice(operands):
    xs = np.stack([_codes((M, K), "e4m3", 10 + i) for i in range(3)])
    ws = np.stack([_codes((K, N), "e4m3", 20 + i) for i in range(3)])
    s = np.array([1e-3, 2e-3, 3e-3], np.float32).reshape(3, 1, 1)
    out = _port(xs, ws, scale=torch.from_numpy(s))
    for i in range(3):
        np.testing.assert_array_equal(out[i], _ref(xs[i], ws[i],
                                                   scale=s[i, 0, 0]))
    shared = _port(xs, ws[0])
    np.testing.assert_array_equal(shared[2], _ref(xs[2], ws[0]))


def test_plain_ref_and_dispatch_bitwise(operands):
    xc, wc = operands
    xv = tf.decode_bits(torch.from_numpy(xc))
    wv = tf.decode_bits(torch.from_numpy(wc))
    ref = np.asarray(r_ref(jnp.asarray(xv.numpy()), jnp.asarray(wv.numpy()),
                           rf.E4M3, "exact"))
    np.testing.assert_array_equal(ref, mgs_matmul_ref(xv, wv).numpy())
    np.testing.assert_array_equal(ref, mgs_matmul(xv, wv, fused=True).numpy())
    np.testing.assert_array_equal(
        ref, mgs_matmul(xv[None], wv, use_kernel=False).numpy()[0])
    np.testing.assert_array_equal(                  # B4: the same bits
        ref, mgs_matmul(xv, wv, fused=False).numpy())
    for schedule in ("weight", "activation"):      # B3: the same bits
        np.testing.assert_array_equal(
            ref, mgs_matmul(xv, wv, fused=True, schedule=schedule).numpy())


def test_limb_decompose_bitwise(operands):
    xc, _ = operands
    v = np.asarray(rf.decode_bits(jnp.asarray(xc), rf.E4M3))
    np.testing.assert_array_equal(
        np.asarray(r_limbs(jnp.asarray(v), rf.E4M3)),
        limb_decompose(torch.from_numpy(v)).numpy())


def test_flush_period_clamp_and_default():
    assert worst_case_flush_period(128) == 1365
    xc, wc = _codes((3, 64), "e4m3", 30), _codes((64, 9), "e4m3", 31)
    a = mgs_matmul_exact_fused_plain(torch.from_numpy(xc),
                                     torch.from_numpy(wc), block_k=32,
                                     flush_period=10**12)
    b = mgs_matmul_exact_fused_plain(torch.from_numpy(xc),
                                     torch.from_numpy(wc), block_k=32)
    assert torch.equal(a, b)
