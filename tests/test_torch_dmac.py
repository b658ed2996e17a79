"""Port parity for the paper's dMAC numerics: ``core.mgs``, the B5 twin
(``mgs_matmul_dmac``), the dmac dispatch and ``qmatmul`` under
``accum="mgs_dmac"`` and ``"wide"``.

E4M3 and E3M4 are held bitwise against the reference: its dmac Pallas
kernel in interpret mode, its ``mgs_matmul_ref(mode="dmac")`` and its
``repro.core.mgs`` helpers.

E5M2 is not, everywhere. The reference rounds each product through
``jnp.exp2`` (the binade's quantum ``2**(eu - mbits)`` and the mantissa
scale), and XLA:CPU's ``exp2`` is a few ulps off at integer arguments with
``|x| >= 13``. At E5M2 those arguments are reached by every product below
``2**-10``, so there the reference's rounding is not RNE: a perturbed
quantum breaks exact ties. The port builds exact powers of two. So at E5M2
the port's per-product rounding is pinned bitwise to a float64 numpy
oracle over all 65,536 code pairs (gate on and off), and so is the whole
matmul at the reference's own test data; against the reference it is held
bitwise wherever the reference's ``exp2`` arguments stay below 13, and
the test shows that every pair where the two differ is a product below
``2**-10``.

``qmatmul`` quantizes dmac operands with ``cfg.fp8_margin`` =
``448 ** -0.5``: the scales and codes are pinned bitwise at that margin
(the reference's compiled divide by the constant ``448 * margin`` is a
multiply by its float32 reciprocal). The ``wide`` baseline is a float32
matmul in both packages, XLA:CPU's dot against PyTorch's: equal within
``1e-6`` of the output scale (summation order). Under ``jax.jit`` XLA:CPU
contracts ``out * scale + bias`` into one fused multiply-add where the
port rounds twice: there the port is held to the two roundings and the
reference to the one rounding of the same operands.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.core import mgs as rmgs  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.quant import config as rq  # noqa: E402
from repro.quant.qmatmul import qmatmul as r_qmatmul  # noqa: E402
from repro.quant.quantize import quantize_fp8 as r_quantize  # noqa: E402

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.core import mgs as tmgs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import mgs_matmul_ref  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant.qmatmul import qmatmul  # noqa: E402
from repro_torch.quant.quantize import quantize_fp8, recip  # noqa: E402


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

# the reference's tests/test_kernels.py SHAPES
SHAPES = [(8, 16, 8), (32, 64, 32), (48, 300, 56), (128, 257, 64),
          (1, 128, 1)]


def _fp8(rng, shape, scale, fmt):
    """Gaussian values rounded to ``fmt`` exactly (the port's rounding)."""
    x = rng.normal(0, scale, shape).astype(np.float32)
    return tf.round_to_format(torch.from_numpy(x), tf.get_format(fmt)).numpy()


def _round_decompose_f64(p, fmt, gate):
    """Float64 oracle of the per-product RNE round + decompose."""
    p = np.asarray(p, np.float64)
    ap = np.abs(p)
    emin, emax = 1 - fmt.bias, fmt.emax - fmt.bias
    with np.errstate(divide="ignore"):
        eu = np.floor(np.log2(np.where(ap > 0, ap, 1.0))).astype(np.int64)
    eu = np.clip(eu, emin, emax)
    q = np.ldexp(1.0, eu - fmt.mbits)
    r = np.minimum(np.round(ap / q) * q, fmt.max_finite)   # half to even
    if gate:
        r = np.where(ap < fmt.min_subnormal, 0.0, r)
    r = np.where(ap == 0, 0.0, r) * np.sign(p)
    ar = np.abs(r)
    eu2 = np.floor(np.log2(np.where(ar > 0, ar, 1.0))).astype(np.int64)
    e = np.where(ar < 2.0 ** emin, 0, np.clip(eu2, emin, emax) + fmt.bias)
    sm = r / np.ldexp(1.0, np.maximum(e, 1) - fmt.bias - fmt.mbits)
    return sm.astype(np.int64), e


def _dmac_f64(x, w, fmt, gate=True):
    """Float64 oracle of the dmac matmul: exact per-product rounding,
    integer bin sums, the float32 combine from zero in ascending bins."""
    sm, e = _round_decompose_f64(x[:, :, None] * w[None], fmt, gate)
    M, _, N = sm.shape
    bins = np.zeros((M, N, fmt.n_bins), np.int64)
    for b in range(fmt.n_bins):
        bins[..., b] = np.where(e == b, sm, 0).sum(axis=1)
    tot = np.zeros((M, N), np.float32)
    for b in range(fmt.n_bins):
        tot = tot + bins[..., b].astype(np.float32) * np.float32(
            2.0 ** (max(b, 1) - fmt.bias - fmt.mbits))
    return tot


def _all_pair_products(fmt):
    vals = tf.decode_bits(torch.arange(256, dtype=torch.uint8),
                          tf.get_format(fmt)).numpy()
    return (vals[:, None] * vals[None, :]).astype(np.float32).ravel()


# ---------------------------------------------------------------------------
# core.mgs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["e4m3", "e3m4", "e5m2"])
def test_core_mgs_bitwise(rng, fmt):
    rf_, tf_ = rf.get_format(fmt), tf.get_format(fmt)
    p = _all_pair_products(fmt)
    for gate in (True, False):
        rr, rs = rmgs.round_product(jnp.asarray(p), rf_, gate)
        tr, ts = tmgs.round_product(torch.from_numpy(p), tf_, gate)
        np.testing.assert_array_equal(np.asarray(rs), ts.numpy())
        sm, e = _round_decompose_f64(p, tf_, gate)
        want = (sm * np.ldexp(1.0, np.maximum(e, 1) - tf_.bias - tf_.mbits)
                ).astype(np.float32)
        np.testing.assert_array_equal(tr.numpy(), want)
        if fmt != "e5m2":
            np.testing.assert_array_equal(np.asarray(rr), tr.numpy())
    # bin sums are integers: bitwise in every format
    sm = rng.integers(-15, 16, (9, 300)).astype(np.int32)
    e = rng.integers(0, tf_.n_bins, (9, 300)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(rmgs.bin_sums(jnp.asarray(sm), jnp.asarray(e), rf_,
                                 axis=1)),
        tmgs.bin_sums(torch.from_numpy(sm), torch.from_numpy(e), tf_,
                      axis=1).numpy())
    # a combine whose float32 rounding depends on the order of the bins
    bs = rng.integers(-2**22, 2**22, (500, tf_.n_bins)).astype(np.int32)
    got = tmgs.combine_bins(torch.from_numpy(bs), tf_).numpy()
    want = np.zeros(500, np.float32)
    for b, s in enumerate(tmgs.bin_scales(tf_)):
        want = want + bs[:, b].astype(np.float32) * np.float32(s)
    np.testing.assert_array_equal(got, want)
    if fmt != "e5m2":     # the reference's bin scales come from exp2
        np.testing.assert_array_equal(
            np.asarray(rmgs.combine_bins(jnp.asarray(bs), rf_)), got)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("fmt", ["e4m3", "e3m4", "e5m2"])
def test_round_decompose_all_code_pairs(fmt, gate):
    """The kernels' per-product rounding over all 65,536 code pairs."""
    rf_, tf_ = rf.get_format(fmt), tf.get_format(fmt)
    p = _all_pair_products(fmt)
    tsm, te = (t.numpy() for t in tmm._round_decompose_e4m3(
        torch.from_numpy(p), tf_, gate))
    rsm, re_ = (np.asarray(t) for t in rmm._round_decompose_e4m3(
        jnp.asarray(p), rf_, gate))
    osm, oe = _round_decompose_f64(p, tf_, gate)
    np.testing.assert_array_equal(tsm, osm)
    np.testing.assert_array_equal(te, oe)
    differ = (rsm != tsm) | (re_ != te)
    if fmt == "e5m2":
        # the reference deviates only where its exp2 arguments reach 13
        assert differ.any()
        assert np.all(np.abs(p[differ]) < 2.0 ** -10)
    else:
        assert not differ.any()


# ---------------------------------------------------------------------------
# the B5 twin
# ---------------------------------------------------------------------------


def _pallas_dmac(x, w, fmt, gate=True, bm=32, bn=32, bk=64):
    return np.asarray(rmm.mgs_matmul_dmac_pallas(
        jnp.asarray(x), jnp.asarray(w), rf.get_format(fmt), gate,
        block_m=bm, block_n=bn, block_k=bk, interpret=True))


@pytest.mark.parametrize("mkn", SHAPES)
def test_dmac_twin_vs_reference_e4m3(rng, mkn):
    M, K, N = mkn
    x, w = _fp8(rng, (M, K), 0.2, "e4m3"), _fp8(rng, (K, N), 0.2, "e4m3")
    twin = tmm.mgs_matmul_dmac_plain(torch.from_numpy(x),
                                     torch.from_numpy(w), tf.E4M3).numpy()
    np.testing.assert_array_equal(_pallas_dmac(x, w, "e4m3"), twin)
    np.testing.assert_array_equal(
        np.asarray(rref.mgs_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                       rf.E4M3, "dmac")), twin)
    np.testing.assert_array_equal(
        mgs_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), tf.E4M3,
                       "dmac").numpy(), twin)
    np.testing.assert_array_equal(_dmac_f64(x, w, tf.E4M3), twin)


@pytest.mark.parametrize("gate", [True, False])
def test_dmac_twin_gate_and_e3m4(rng, gate):
    for fmt, scale in (("e4m3", 0.05), ("e3m4", 0.5)):
        x, w = _fp8(rng, (48, 300), scale, fmt), _fp8(rng, (300, 56), scale,
                                                      fmt)
        twin = tmm.mgs_matmul_dmac_plain(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         tf.get_format(fmt), gate).numpy()
        np.testing.assert_array_equal(_pallas_dmac(x, w, fmt, gate), twin)


def test_dmac_twin_e5m2(rng):
    # the reference's own E5M2 test data: the port equals the float64
    # oracle bitwise, the reference (exp2 below 2**-10) does not
    x, w = _fp8(rng, (16, 128), 0.05, "e5m2"), _fp8(rng, (128, 16), 0.05,
                                                    "e5m2")
    twin = tmm.mgs_matmul_dmac_plain(torch.from_numpy(x),
                                     torch.from_numpy(w), tf.E5M2).numpy()
    np.testing.assert_array_equal(_dmac_f64(x, w, tf.E5M2), twin)
    assert not np.array_equal(_pallas_dmac(x, w, "e5m2", bm=16, bn=16),
                              twin)
    # values whose products lie in [2**-10, 2**15), where the reference's
    # exp2 is exact: within the reference's own rtol=1e-5, and in fact equal
    shape = (16, 128), (128, 16)
    xs, ws = (np.ldexp(rng.choice([-1.0, 1.0], s) * rng.integers(4, 8, s),
                       rng.integers(-7, 5, s)).astype(np.float32)
              for s in shape)
    twin = tmm.mgs_matmul_dmac_plain(torch.from_numpy(xs),
                                     torch.from_numpy(ws), tf.E5M2).numpy()
    ref = _pallas_dmac(xs, ws, "e5m2", bm=16, bn=16)
    np.testing.assert_allclose(twin, ref, rtol=1e-5)
    np.testing.assert_array_equal(twin, ref)
    np.testing.assert_array_equal(_dmac_f64(xs, ws, tf.E5M2), twin)


def test_dmac_twin_chunking_batch_and_shared_weight(rng, monkeypatch):
    xs = np.stack([_fp8(rng, (5, 70), 0.3, "e4m3") for _ in range(3)])
    ws = np.stack([_fp8(rng, (70, 33), 0.3, "e4m3") for _ in range(3)])
    out = tmm.mgs_matmul_dmac(torch.from_numpy(xs), torch.from_numpy(ws))
    shared = tmm.mgs_matmul_dmac(torch.from_numpy(xs),
                                 torch.from_numpy(ws[0]))
    # tiny passes over N and K: integer bin sums, the same bits
    monkeypatch.setattr(tmm, "_DMAC_N_CHUNK", 8)
    monkeypatch.setattr(tmm, "_DMAC_PRODUCTS", 64)
    chunked = tmm.mgs_matmul_dmac(torch.from_numpy(xs), torch.from_numpy(ws))
    assert torch.equal(out, chunked)
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(),
                                      _pallas_dmac(xs[i], ws[i], "e4m3"))
        np.testing.assert_array_equal(shared[i].numpy(),
                                      _pallas_dmac(xs[i], ws[0], "e4m3"))


def test_dmac_dispatch(rng):
    x = _fp8(rng, (2, 3, 40), 0.3, "e4m3")
    w = _fp8(rng, (40, 24), 0.3, "e4m3")
    want = np.asarray(rops.mgs_matmul(jnp.asarray(x), jnp.asarray(w),
                                      rf.E4M3, "dmac", block_m=8, block_n=8,
                                      block_k=32))
    for use_kernel in (True, False):
        got = ops.mgs_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             tf.E4M3, "dmac", use_kernel=use_kernel)
        assert got.shape == (2, 3, 24)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exact-mode only"):
        ops.mgs_matmul(torch.from_numpy(x), torch.from_numpy(w), tf.E4M3,
                       "dmac", scale=torch.tensor(2.0))
    with pytest.raises(ValueError, match="unknown mode"):
        ops.mgs_matmul(torch.from_numpy(x), torch.from_numpy(w), tf.E4M3,
                       "swamp")
    # E5M2 is dmac-only: the exact limb scheme refuses it
    with pytest.raises(ValueError, match="dmac mode"):
        ops.mgs_matmul(torch.from_numpy(x), torch.from_numpy(w), tf.E5M2,
                       "exact")
    # a prepared weight (its codes) gives its decoded values' bits
    pw = tprep.prepare_weight(torch.from_numpy(w * 3), tq.FP8_MGS)
    got = ops.mgs_matmul(torch.from_numpy(x), pw, tf.E4M3, "dmac")
    np.testing.assert_array_equal(
        got.numpy(), ops.mgs_matmul(torch.from_numpy(x), pw.values(),
                                    tf.E4M3, "dmac").numpy())


# ---------------------------------------------------------------------------
# qmatmul: mgs_dmac and wide
# ---------------------------------------------------------------------------


def _acts(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale
            * np.exp2(rng.integers(-4, 4, shape))).astype(np.float32)


@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_at_dmac_margin_bitwise(axis):
    margin = tq.FP8_MGS.fp8_margin
    assert margin == rq.FP8_MGS.fp8_margin == 448.0 ** -0.5
    for seed in range(20):
        x = _acts((7, 65), seed, scale=float(np.exp2(seed - 10)))
        qr = r_quantize(jnp.asarray(x), rf.E4M3, axis=axis, margin=margin)
        qt = quantize_fp8(torch.from_numpy(x), tf.E4M3, axis=axis,
                          margin=margin)
        np.testing.assert_array_equal(
            np.asarray(qr.scale), qt.scale.numpy().reshape(
                np.asarray(qr.scale).shape))
        np.testing.assert_array_equal(np.asarray(qr.q), qt.q.numpy())
    # which lowering: amax * float32(1 / float32(448 * margin))
    amax = np.float32(np.abs(x).max())
    qr = r_quantize(jnp.asarray(x), rf.E4M3, margin=margin)
    assert np.float32(qr.scale) == amax * np.float32(recip(448.0 * margin))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("accum", ["mgs_dmac", "wide"])
def test_qmatmul_matches_reference(accum, with_bias):
    x, w = _acts((6, 96), 1), _acts((96, 40), 2, scale=0.1)
    b = _acts((40,), 3)
    rcfg = rq.QuantConfig(dtype="fp8_e4m3", accum=accum)
    kw_r = {"bias": jnp.asarray(b)} if with_bias else {}
    kw_t = {"bias": torch.from_numpy(b)} if with_bias else {}
    want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w), rcfg,
                                **kw_r))
    for use_kernel in (True, False):
        tcfg = tq.QuantConfig(dtype="fp8_e4m3", accum=accum,
                              use_kernel=use_kernel)
        got = qmatmul(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                      **kw_t).numpy()
        if accum == "wide":
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
        else:
            np.testing.assert_array_equal(got, want)
    if accum == "mgs_dmac" and with_bias:
        # the port rounds out * scale, then + bias; jitted, XLA:CPU fuses
        # the two into one rounding of the same operands
        margin = tcfg.fp8_margin
        qx = quantize_fp8(torch.from_numpy(x), tf.E4M3, margin=margin)
        qw = quantize_fp8(torch.from_numpy(w), tf.E4M3, margin=margin)
        out = tmm.mgs_matmul_dmac(qx.q, qw.q).numpy()
        s = (qx.scale * qw.scale).numpy()
        np.testing.assert_array_equal(got, (out * s) + b)
        jitted = np.asarray(jax.jit(lambda a, c, d: r_qmatmul(
            a, c, rcfg, bias=d))(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b)))
        fma = (out.astype(np.float64) * s + b).astype(np.float32)
        np.testing.assert_array_equal(jitted, fma)


def test_qmatmul_dmac_batched_one_launch_and_prepared(rng):
    """Batched slices: one B5 call over all slices == the reference's
    vmap of qmatmul; a prepared weight gives the raw weight's bits."""
    x, w = _acts((4, 5, 64), 4), _acts((4, 64, 24), 5, scale=0.2)
    rcfg = rq.FP8_MGS
    want = np.asarray(jax.vmap(lambda a, c: r_qmatmul(a, c, rcfg))(
        jnp.asarray(x), jnp.asarray(w)))
    for use_kernel in (True, False):
        tcfg = tq.FP8_MGS.replace(use_kernel=use_kernel)
        got = qmatmul(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                      batched=True).numpy()
        np.testing.assert_array_equal(got, want)
    x2, w2 = _acts((3, 64), 6), _acts((64, 24), 7)
    tcfg = tq.FP8_MGS.replace(use_kernel=True)
    pw = tprep.prepare_weight(torch.from_numpy(w2), tcfg)
    # the reference's rule keeps limbs for use_kernel and not fused, even
    # where, as here, the kernel (B5) streams values
    assert pw.limbs is not None
    np.testing.assert_array_equal(
        qmatmul(torch.from_numpy(x2), pw, tcfg).numpy(),
        qmatmul(torch.from_numpy(x2), torch.from_numpy(w2), tcfg).numpy())


def test_swamp_accum_matches_reference_raw_and_prepared():
    """fp8 ``swamp`` (the Fig. 3 baseline, operands at the dmac margin, a
    ``narrow_bits - 1``-bit accumulator) bitwise against the reference,
    with a raw weight and with a prepared one (its decoded values)."""
    from repro.quant import prepared as rprep
    x, w = _acts((4, 80), 31), _acts((80, 12), 32, scale=0.1)
    for narrow in (5, 7):
        rcfg = rq.QuantConfig(dtype="fp8_e4m3", accum="swamp",
                              narrow_bits=narrow)
        tcfg = tq.QuantConfig(dtype="fp8_e4m3", accum="swamp",
                              narrow_bits=narrow)
        want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w), rcfg))
        np.testing.assert_array_equal(
            qmatmul(torch.from_numpy(x), torch.from_numpy(w), tcfg).numpy(),
            want)
        rpw = rprep.prepare_weight(jnp.asarray(w), rcfg)
        tpw = tprep.prepare_weight(torch.from_numpy(w), tcfg)
        np.testing.assert_array_equal(
            qmatmul(torch.from_numpy(x), tpw, tcfg).numpy(),
            np.asarray(r_qmatmul(jnp.asarray(x), rpw, rcfg)))


def test_flush_target_raises_and_calibration_alone_changes_no_bits():
    """``flush_target`` plans the exact kernels' flush period (the Markov
    plan, never shorter than the worst case): the port gives the
    reference's planned period and bits, where it used to raise. A
    config's ``calibration`` alone feeds only that plan and the static
    decode-q scale, so without ``flush_target`` it changes no bits."""
    from repro.core.markov import plan_flush_period as r_plan
    tqm = importlib.import_module("repro_torch.quant.qmatmul")

    x, w = _acts((6, 96), 21), _acts((96, 40), 22, scale=0.1)
    want = np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w),
                                rq.FP8_MGS_EXACT))
    calib = {"ffn.wg": 0.3, "attn.wq": 0.7}
    for calibration in (None, calib):
        for base_r, base_t in ((rq.FP8_MGS_EXACT, tq.FP8_MGS_EXACT),
                               (rq.FP8_MGS_SERVE, tq.FP8_MGS_SERVE)):
            r_cfg = base_r.replace(flush_target=1e-6).with_calibration(
                calibration)
            t_cfg = base_t.replace(flush_target=1e-6).with_calibration(
                calibration)
            for site in ("ffn.wg", None):
                sigma = r_cfg.act_sigma(site)
                period = tqm._exact_flush_period(t_cfg, None, sigma, site)
                # the reference clamps to the C int before its kernel
                assert period == min(2**31 - 1, r_plan(
                    r_cfg.block_k, target_overflow=1e-6, sigma_limb_x=sigma))
                got = qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                              t_cfg, site=site).numpy()
                np.testing.assert_array_equal(got, np.asarray(r_qmatmul(
                    jnp.asarray(x), jnp.asarray(w), r_cfg, site=site)))
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(r_qmatmul(jnp.asarray(x), jnp.asarray(w),
                             rq.FP8_MGS_EXACT.with_calibration(calib),
                             site="ffn.wg")), want)
    for base in (tq.FP8_MGS_EXACT, tq.FP8_MGS_SERVE):
        cfg = base.with_calibration(calib)
        assert cfg.calibration is not None
        np.testing.assert_array_equal(
            qmatmul(torch.from_numpy(x), torch.from_numpy(w), cfg,
                    site="ffn.wg").numpy(), want)
