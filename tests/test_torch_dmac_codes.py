"""B5 over packed FP8 codes: ``mgs_matmul_dmac_codes``, its twin, its
rounding table and the dispatch that feeds it.

The card's kernel (``csrc/mgs_dmac.cu``) rounds each product with one
lookup in a 128 x 128 table of ``(e << (mbits + 1)) | |sm|`` over the two
magnitude codes, takes the sign as the XOR of the two sign bits, and adds
into 32-bit bins that wrap. These tests hold, on the CPU:

* the codes twin against the float twin over all 256 x 256 code pairs
  (NaN codes excluded), in every format, gate on and off;
* the table (:func:`dmac_table_plain`) and the sign/zero separation
  against the per-product rounding of every signed pair;
* a model of the kernel's algorithm (lookup, sign XOR, wrapping bins, the
  ascending combine) against the twin;
* small batched and shared-weight shapes against the reference's dmac
  Pallas kernel in interpret mode, on the same codes decoded (bitwise;
  E4M3 and E3M4, where the reference's rounding is RNE);
* ``qmatmul`` under ``FP8_MGS`` with the kernel tier, prepared and raw,
  against the plain tier and the reference, with no call of
  ``PreparedWeight.values`` on the path.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.quant import config as rq  # noqa: E402
from repro.quant.qmatmul import qmatmul as r_qmatmul  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.core.mgs import combine_bins  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant.qmatmul import qmatmul  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


rmm = importlib.import_module("repro.kernels.mgs_matmul")
tmm = importlib.import_module("repro_torch.kernels.mgs_matmul")

FMTS = ["e4m3", "e5m2", "e3m4"]


def _finite_codes(fmt):
    """Every code whose value is finite in ``fmt`` (NaN codes left out)."""
    c = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    v = tf.decode_bits(c, fmt)
    return c[v.abs() <= fmt.max_finite]


def _codes(rng, shape, fmt, scale):
    x = torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
    return tf.encode_bits(tf.round_to_format(x, fmt), fmt)


def _kernel_model(xc, wc, fmt, gate):
    """The card's algorithm in numpy: one table lookup per product on the
    two magnitude codes, the sign as the XOR of the sign bits, uint32 bins
    that wrap, then the twin's ascending combine."""
    tbl = tmm.dmac_table_plain(fmt, gate).numpy().astype(np.uint32)
    x = xc.numpy().astype(np.uint32)
    w = wc.numpy().astype(np.uint32)
    t = tbl[(x & 0x7F)[:, :, None], (w & 0x7F)[None, :, :]]   # (M, K, N)
    neg = ((x >> 7)[:, :, None] ^ (w >> 7)[None, :, :]).astype(bool)
    m = t & ((1 << (fmt.mbits + 1)) - 1)
    sm = np.where(neg, (-m.astype(np.int64)) & 0xFFFFFFFF, m).astype(
        np.uint32)
    e = t >> (fmt.mbits + 1)
    M, _, N = t.shape
    bins = np.zeros((M, N, fmt.n_bins), np.uint32)
    for b in range(fmt.n_bins):
        bins[..., b] = np.where(e == b, sm, 0).sum(axis=1, dtype=np.uint32)
    return combine_bins(torch.from_numpy(bins.view(np.int32)), fmt)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("fmt", FMTS)
def test_codes_twin_all_code_pairs(fmt, gate):
    f = tf.get_format(fmt)
    c = _finite_codes(f)
    xc, wc = c[:, None], c[None, :]                 # (n, 1) @ (1, n)
    got = tmm.mgs_matmul_dmac_codes_plain(xc, wc, f, gate)
    want = tmm.mgs_matmul_dmac_plain(tf.decode_bits(xc, f),
                                     tf.decode_bits(wc, f), f, gate)
    assert got.shape == (len(c), len(c))
    assert torch.equal(got, want)
    # the CPU entry takes the twin
    assert torch.equal(tmm.mgs_matmul_dmac_codes(xc, wc, f, gate), want)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("fmt", FMTS)
def test_table_sign_and_zero_separate(fmt, gate):
    """(|sm|, e) of every signed finite pair is the table's entry for the
    two magnitude codes, and sm's sign the XOR of the sign bits."""
    f = tf.get_format(fmt)
    c = _finite_codes(f)
    v = tf.decode_bits(c, f)
    sm, e = tmm._round_decompose_e4m3(v[:, None] * v[None, :], f, gate)
    tbl = tmm.dmac_table_plain(f, gate)
    assert tbl.shape == (128, 128) and tbl.dtype == torch.uint8
    t = tbl[(c & 0x7F).long()[:, None], (c & 0x7F).long()[None, :]].to(
        torch.int32)
    neg = ((c >> 7)[:, None] ^ (c >> 7)[None, :]).to(torch.bool)
    mag = t & ((1 << (f.mbits + 1)) - 1)
    assert torch.equal(torch.where(neg, -mag, mag), sm)
    assert torch.equal(t >> (f.mbits + 1), e)
    # (|sm|, e) packs into one byte losslessly
    assert int(sm.abs().max()) < 2 ** (f.mbits + 1)
    assert int(e.max()) < f.n_bins
    zero = (c & 0x7F) == 0                          # +0 and -0
    assert not sm[zero].any() and not e[zero].any()
    assert not sm[:, zero].any() and not e[:, zero].any()


@pytest.mark.parametrize("fmt", FMTS)
def test_kernel_algorithm_model_equals_twin(rng, fmt):
    f = tf.get_format(fmt)
    scale = {"e4m3": 0.3, "e5m2": 0.05, "e3m4": 1.0}[fmt]
    for gate in (True, False):
        xc, wc = _codes(rng, (7, 300), f, scale), _codes(rng, (300, 40), f,
                                                         scale)
        assert torch.equal(_kernel_model(xc, wc, f, gate),
                           tmm.mgs_matmul_dmac_codes_plain(xc, wc, f, gate))
    # every product saturates at the largest magnitude
    big = tf.encode_bits(torch.full((1, 4096), f.max_finite), f)
    assert torch.equal(_kernel_model(big, big.T.contiguous(), f, True),
                       tmm.mgs_matmul_dmac_codes_plain(
                           big, big.T.contiguous(), f, True))


@pytest.mark.parametrize("fmt", ["e4m3", "e3m4"])
def test_codes_batched_and_shared_vs_reference(rng, fmt):
    f, r = tf.get_format(fmt), rf.get_format(fmt)
    scale = {"e4m3": 0.3, "e3m4": 1.0}[fmt]
    xc = _codes(rng, (3, 5, 70), f, scale)
    wc = _codes(rng, (3, 70, 33), f, scale)
    out = tmm.mgs_matmul_dmac_codes(xc, wc, f)
    shared = tmm.mgs_matmul_dmac_codes(xc, wc[1], f)
    assert out.shape == shared.shape == (3, 5, 33)
    xv, wv = tf.decode_bits(xc, f).numpy(), tf.decode_bits(wc, f).numpy()
    for i in range(3):
        for got, wi in ((out[i], i), (shared[i], 1)):
            ref = np.asarray(rmm.mgs_matmul_dmac_pallas(
                jnp.asarray(xv[i]), jnp.asarray(wv[wi]), r, True,
                block_m=8, block_n=16, block_k=32, interpret=True))
            np.testing.assert_array_equal(got.numpy(), ref)
    # the float entry gives the codes entry's bits
    assert torch.equal(tmm.mgs_matmul_dmac(tf.decode_bits(xc, f),
                                           tf.decode_bits(wc, f), f), out)
    with pytest.raises(TypeError, match="uint8 codes"):
        tmm.mgs_matmul_dmac_codes(xc.to(torch.int32), wc, f)
    with pytest.raises(ValueError, match="contraction"):
        tmm.mgs_matmul_dmac_codes(xc, wc[:, :69], f)


def _acts(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale
            * np.exp2(rng.integers(-4, 4, shape))).astype(np.float32)


def _no_values(monkeypatch):
    def boom(self, dtype=torch.float32):
        raise AssertionError("PreparedWeight.values() on the B5 path")
    monkeypatch.setattr(tprep.PreparedWeight, "values", boom)


def test_qmatmul_kernel_tier_codes_prepared_and_raw(monkeypatch):
    kern = tq.FP8_MGS.replace(use_kernel=True)
    plain = tq.FP8_MGS.replace(use_kernel=False)
    x, w = _acts((2, 3, 64), 11), _acts((64, 24), 12, scale=0.2)
    xb, wb = _acts((4, 5, 64), 13), _acts((4, 64, 24), 14, scale=0.2)
    want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w),
                                rq.FP8_MGS))
    want_b = np.asarray(jax.vmap(lambda a, c: r_qmatmul(a, c, rq.FP8_MGS))(
        jnp.asarray(xb), jnp.asarray(wb)))
    pw = tprep.prepare_weight(torch.from_numpy(w), kern)
    pwb = tprep.prepare_weight(torch.from_numpy(wb), kern, stack_ndim=1)
    today = qmatmul(torch.from_numpy(x), torch.from_numpy(w), plain)
    today_b = qmatmul(torch.from_numpy(xb), torch.from_numpy(wb), plain,
                      batched=True)
    _no_values(monkeypatch)
    for wt, wbt in ((torch.from_numpy(w), torch.from_numpy(wb)), (pw, pwb)):
        got = qmatmul(torch.from_numpy(x), wt, kern)
        got_b = qmatmul(torch.from_numpy(xb), wbt, kern, batched=True)
        assert torch.equal(got, today) and torch.equal(got_b, today_b)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_b.numpy(), want_b)
    # the dispatch below qmatmul reads the prepared weight's codes too
    xv = tf.round_to_format(torch.from_numpy(x[0]), tf.E4M3)
    got = ops.mgs_matmul(xv, pw, tf.E4M3, "dmac")
    assert torch.equal(got, tmm.mgs_matmul_dmac_codes_plain(
        tf.encode_bits(xv, tf.E4M3), pw.codes, tf.E4M3))


def test_fp8_mgs_engine_never_decodes_prepared_weights(monkeypatch):
    """A reduced FP8_MGS engine at the kernel tier serves with every
    ``PreparedWeight.values`` call failing; on CPU tensors nothing is
    launched (the wrappers take their twins)."""
    cfg = dataclasses.replace(reduced_config("deepseek-7b"), n_layers=2,
                              compute_dtype="float32",
                              quant=tq.FP8_MGS.replace(use_kernel=True))
    eng = ServeEngine(cfg, batch=2, max_len=12, seed=0, device="cpu")
    _no_values(monkeypatch)
    n0 = LAUNCHES["mgs_matmul_dmac"]
    reqs = [Request(rid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new_tokens=2) for i in range(2)]
    stats = eng.run(reqs)
    assert stats["decode_tokens"] == 4
    assert all(len(r.out_tokens) == 2 for r in reqs)
    assert LAUNCHES["mgs_matmul_dmac"] == n0
