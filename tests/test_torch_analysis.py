"""Port parity for the paper's accumulation analysis (Fig. 3, Fig. 4b,
Table 3): ``repro_torch.core`` ``formats`` helpers, ``summation``, the
dot-level half of ``mgs``, ``int_dmac`` and ``energy`` against
``repro.core``.

Inputs are drawn with numpy from a seed and go through both packages.
Everything integer or rounded step by step is held bitwise: the format
helpers (E4M3 / E3M4 scales against the reference's ``exp2``, E5M2's
against exact powers of two: XLA:CPU's ``exp2`` is a few ulps off at
``|x| >= 13``), the sequential / pairwise / Kahan sums, both
``mgs_dot_exact`` modes, ``mgs_dot_dmac`` with every counter,
``mgs_dot_narrow_clipped`` and the four integer dots with their counters.
The reference's emulators take one dot and its callers ``vmap`` them; the
port's take leading dims, held row by row against the ``vmap``. The
energy model equals the reference's to float64 round-off; ``fp32_sum`` is
a float32 reduction in another order than XLA's, held to 1e-6 of the sum
of magnitudes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import energy as renergy  # noqa: E402
from repro.core import formats as rf  # noqa: E402
from repro.core import int_dmac as rint  # noqa: E402
from repro.core import mgs as rmgs  # noqa: E402
from repro.core import summation as rsum  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.core import int_dmac as tint  # noqa: E402
from repro_torch.core import mgs as tmgs  # noqa: E402
from repro_torch.core import summation as tsum  # noqa: E402

FORMATS = ["e4m3", "e3m4", "e5m2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _fp8(rng, shape, fmt, scale=1.0):
    x = rng.normal(0, scale, shape).astype(np.float32)
    return tf.round_to_format(_t(x), tf.get_format(fmt)).numpy()


def _all_values(fmt):
    v = tf.decode_bits(torch.arange(256, dtype=torch.uint8),
                       tf.get_format(fmt)).numpy()
    return v[np.isfinite(v)]


def _rows(fn, *args):
    """The reference's one-dot emulator vmapped over the leading axis."""
    return jax.vmap(fn)(*(jnp.asarray(a) for a in args))


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---------------------------------------------------------------------------
# formats helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_helpers(fmt):
    r, t = rf.get_format(fmt), tf.get_format(fmt)
    assert t.min_subnormal_exp == r.min_subnormal_exp
    assert t.max_abs_sm == r.max_abs_sm
    e = np.arange(r.n_bins, dtype=np.int32)
    _eq(r.scale_exp(jnp.asarray(e)), t.scale_exp(_t(e)))
    _eq(rf.quantum_exponent(r, jnp.asarray(e)), tf.quantum_exponent(t, _t(e)))
    exact = np.ldexp(1.0, np.maximum(e, 1) - r.bias - r.mbits).astype(
        np.float32)
    np.testing.assert_array_equal(t.scale(_t(e)).numpy(), exact)
    if fmt != "e5m2":      # the reference's scales come from exp2
        _eq(r.scale(jnp.asarray(e)), t.scale(_t(e)))
    # every value of the format is sm * scale(e)
    sm, eb = tf.decompose(_t(_all_values(fmt)), t)
    np.testing.assert_array_equal(
        (sm.to(torch.float32) * t.scale(eb)).numpy(), _all_values(fmt))


# ---------------------------------------------------------------------------
# summation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mant", [3, 4, 6])
@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_low_precision_sums_bitwise(n, mant):
    """Sequential, pairwise (padded to a power of two) and Kahan sums in
    an accumulator of ``mant`` significant bits, over a batch of rows and
    wide-range values (swamping and saturation both reached)."""
    rng = np.random.default_rng(n * 10 + mant)
    x = _fp8(rng, (5, n), "e4m3", scale=4.0)
    x[0] = np.abs(x[0]) * 8          # a row that saturates
    ra, ta = rsum.acc_format(mant), tsum.acc_format(mant)
    assert (ta.name, ta.ebits, ta.mbits) == (ra.name, ra.ebits, ra.mbits)
    for name in ("sequential_sum", "pairwise_sum", "kahan_sum"):
        _eq(getattr(rsum, name)(jnp.asarray(x), ra),
            getattr(tsum, name)(_t(x), ta))
    _eq(rsum.lowprec_add(jnp.asarray(x[0]), jnp.asarray(x[1]), ra),
        tsum.lowprec_add(_t(x[0]), _t(x[1]), ta))


def test_fp32_sum_within_tolerance(rng):
    x = rng.normal(0, 1, (16, 4096)).astype(np.float32)
    want = np.asarray(rsum.fp32_sum(jnp.asarray(x)))
    got = tsum.fp32_sum(_t(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(x).sum(-1).max())


# ---------------------------------------------------------------------------
# core.mgs: the dot-level half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_mgs_dot_exact_both_modes(fmt):
    rng = np.random.default_rng(3)
    r, t = rf.get_format(fmt), tf.get_format(fmt)
    x, w = _fp8(rng, (6, 257), fmt), _fp8(rng, (6, 257), fmt, 0.3)
    for mode in ("dmac", "exact"):
        for gate in (True, False):
            want = _rows(lambda a, b: rmgs.mgs_dot_exact(
                a, b, r, mode, gate), x, w)
            _eq(want, tmgs.mgs_dot_exact(_t(x), _t(w), t, mode, gate))
    # exact mode: the exact dot, up to the float32 combine
    true = (x.astype(np.float64) * w).sum(-1)
    got = tmgs.mgs_dot_exact(_t(x), _t(w), t, "exact").numpy()
    np.testing.assert_allclose(got, true, rtol=1e-6,
                               atol=1e-6 * np.abs(true).max())
    # the matvec helper: rows against one vector
    _eq(rmgs.mgs_matvec_exact(jnp.asarray(x), jnp.asarray(w[0]), r, "dmac"),
        tmgs.mgs_matvec_exact(_t(x), _t(w[0]), t, "dmac"))
    _eq(rmgs.mgs_matvec_exact(jnp.asarray(x), jnp.asarray(w[0]), r,
                              "exact"),
        tmgs.mgs_matvec_exact(_t(x), _t(w[0]), t, "exact"))


def test_mgs_dot_exact_e5m2_wraps_as_the_reference():
    """E5M2's wide exponent takes ``sx << max(ex, 1)`` past int32 (bins
    >= 29) and its limb products past int32 (bins >= 23): the reference's
    int32 registers wrap there, and the port gives the same wrapped bits
    (ROADMAP queue C)."""
    rng = np.random.default_rng(4)
    vals = _all_values("e5m2")
    x = rng.choice(vals, (40, 64)).astype(np.float32)
    w = rng.choice(vals, (40, 64)).astype(np.float32)
    want = _rows(lambda a, b: rmgs.mgs_dot_exact(a, b, rf.E5M2, "exact"),
                 x, w)
    _eq(want, tmgs.mgs_dot_exact(_t(x), _t(w), tf.E5M2, "exact"))
    true = (x.astype(np.float64) * w).sum(-1)
    assert np.abs(np.asarray(want) - true).max() > 1e6   # not the dot


@pytest.mark.parametrize("narrow_bits", [4, 5, 8])
@pytest.mark.parametrize("fmt", FORMATS)
def test_mgs_dot_dmac_value_and_every_counter(fmt, narrow_bits):
    rng = np.random.default_rng(narrow_bits)
    r, t = rf.get_format(fmt), tf.get_format(fmt)
    x = _fp8(rng, (5, 200), fmt, 8 ** 0.5)
    w = _fp8(rng, (5, 200), fmt, 0.5)
    if fmt == "e5m2":
        # the reference rounds E5M2 products below 2**-10 through an exp2
        # that is off at |x| >= 13 (ROADMAP queue C; the port's rounding
        # is held to a float64 oracle over every code pair in
        # tests/test_torch_dmac.py): keep every product above it
        x, w = (np.where(np.abs(v) < 2.0 ** -5, 2.0 ** -5, v).astype(
            np.float32) for v in (x, w))
    w[1, ::3] = 0.0
    for gate in (True, False):
        rv, rs = _rows(lambda a, b: rmgs.mgs_dot_dmac(
            a, b, r, narrow_bits, gate), x, w)
        tv, ts = tmgs.mgs_dot_dmac(_t(x), _t(w), t, narrow_bits, gate)
        assert isinstance(ts, tmgs.MGSStats) and ts._fields == rs._fields
        _eq(rv, tv)
        for a, b in zip(rs, ts):
            _eq(a, b)
        rc, tc = (_rows(lambda a, b: rmgs.mgs_dot_narrow_clipped(
            a, b, r, narrow_bits, gate), x, w),
            tmgs.mgs_dot_narrow_clipped(_t(x), _t(w), t, narrow_bits, gate))
        _eq(rc[0], tc[0])
        _eq(rc[1], tc[1])
    if narrow_bits <= 5:       # the counters saw overflows and clips
        assert ts.wide_flushes.sum() > 0 and tc[1].sum() > 0


def test_mgs_dot_dmac_quirks():
    """The reference's quirks, kept: a product below the smallest
    subnormal is left out of the narrow adds, the sums and ``bin_hits``
    even with ``gate_subnormal=False`` (where ``mgs_dot_exact`` keeps its
    rounded value); ``final_flushes`` is ``n_bins``; ``total_macs`` is K;
    gated, the value is ``mgs_dot_exact(mode="dmac")``'s."""
    fmt = tf.E4M3
    q = fmt.min_subnormal
    # 1.25 * 2**-5 squared is 0.78 q, which rounds up to q ungated; the
    # last product, 0.375 q, rounds to zero either way
    x = np.array([[1.0, 1.25 * 2.0 ** -5, 2.0, 0.5 * q]], np.float32)
    w = np.array([[1.0, 1.25 * 2.0 ** -5, 3.0, 0.75]], np.float32)
    x = tf.round_to_format(_t(x), fmt).numpy()
    w = tf.round_to_format(_t(w), fmt).numpy()
    tiny = np.abs(x * w) < q
    assert tiny.sum() == 2
    for gate in (True, False):
        v, st = tmgs.mgs_dot_dmac(_t(x), _t(w), fmt, gate_subnormal=gate)
        rv, rs = rmgs.mgs_dot_dmac(jnp.asarray(x[0]), jnp.asarray(w[0]),
                                   rf.E4M3, 5, gate)
        assert float(v[0]) == float(rv) == 7.0
        assert st.skipped.tolist() == [2] == [int(rs.skipped)]
        assert st.narrow_adds.tolist() == [2]
        assert st.bin_hits.sum().item() == 2
        assert st.total_macs.tolist() == [4]
        assert st.final_flushes.tolist() == [fmt.n_bins]
        ex = tmgs.mgs_dot_exact(_t(x), _t(w), fmt, "dmac", gate)
        assert float(ex[0]) == (7.0 if gate else 7.0 + q)
    # at scale, gated: the emulator's value is the vectorised one
    rng = np.random.default_rng(9)
    x, w = _fp8(rng, (8, 300), "e4m3", 3.0), _fp8(rng, (8, 300), "e4m3", 0.1)
    v, st = tmgs.mgs_dot_dmac(_t(x), _t(w), fmt)
    assert st.skipped.sum() > 0
    assert torch.equal(v, tmgs.mgs_dot_exact(_t(x), _t(w), fmt, "dmac"))


def test_mgs_stats_zero_merge_and_rate():
    rng = np.random.default_rng(5)
    x, w = _fp8(rng, (2, 128), "e4m3", 3.0), _fp8(rng, (2, 128), "e4m3")
    _, st = tmgs.mgs_dot_dmac(_t(x), _t(w))
    r0, t0 = rmgs.MGSStats.zero(), tmgs.MGSStats.zero()
    for a, b in zip(r0, t0):
        _eq(a, b)
    rows = [tmgs.MGSStats(*(f[i] for f in st)) for i in range(2)]
    tot = t0.merge(rows[0]).merge(rows[1])
    _, r_a = rmgs.mgs_dot_dmac(jnp.asarray(x[0]), jnp.asarray(w[0]))
    _, r_b = rmgs.mgs_dot_dmac(jnp.asarray(x[1]), jnp.asarray(w[1]))
    want = r0.merge(r_a).merge(r_b)
    for a, b in zip(want, tot):
        _eq(a, b)
    _eq(want.overflow_rate, tot.overflow_rate)
    _eq(jax.vmap(lambda a, b: rmgs.mgs_dot_dmac(a, b)[1].overflow_rate)(
        jnp.asarray(x), jnp.asarray(w)), st.overflow_rate)


# ---------------------------------------------------------------------------
# core.int_dmac
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,narrow", [(4, 8), (5, 10), (8, 16), (8, 20)])
def test_integer_dots_and_counters(bits, narrow):
    rng = np.random.default_rng(bits * narrow)
    hi = 2 ** (bits - 1) - 1
    x = rng.integers(-hi, hi + 1, (6, 700)).astype(np.int32)
    w = rng.integers(-hi, hi + 1, (6, 700)).astype(np.int32)
    x[0] = np.abs(x[0])
    w[0] = np.abs(w[0])              # a row that keeps climbing
    rv, rs = _rows(lambda a, b: rint.int_dot_dmac(a, b, narrow), x, w)
    tv, ts = tint.int_dot_dmac(_t(x), _t(w), narrow)
    _eq(rv, tv)
    for a, b in zip(rs, ts):
        _eq(a, b)
    _eq(rs.overflow_rate, ts.overflow_rate)
    exact = tint.int_dot_exact(_t(x), _t(w))
    _eq(rint.int_dot_exact(jnp.asarray(x), jnp.asarray(w)), exact)
    assert torch.equal(tv, exact)                    # the dMAC is exact
    rc = _rows(lambda a, b: rint.int_dot_clip(a, b, narrow), x, w)
    tc = tint.int_dot_clip(_t(x), _t(w), narrow)
    _eq(rc[0], tc[0])
    _eq(rc[1], tc[1])
    _eq(_rows(lambda a, b: rint.int_dot_wrap(a, b, narrow), x, w),
        tint.int_dot_wrap(_t(x), _t(w), narrow))
    assert tc[1][0] > 0 and ts.wide_flushes[0] > 0


def test_wrap_is_a_floor_modulo():
    """Negative partial sums wrap with jnp's floor ``%`` (``torch.remainder``;
    a truncating ``fmod`` would give other bits)."""
    x = np.array([[-100, -100, -100, 50, -7]], np.int32)
    w = np.array([[1, 1, 1, 1, 1]], np.int32)
    want = int(rint.int_dot_wrap(jnp.asarray(x[0]), jnp.asarray(w[0]), 8))
    got = int(tint.int_dot_wrap(_t(x), _t(w), 8)[0])
    assert got == want == (((-257 + 128) % 256) - 128)


def test_integer_dots_broadcast_rows_against_columns():
    """``(M, 1, K)`` rows against ``(1, N, K)`` columns: every output a
    dot, as the reference's nested ``vmap``."""
    rng = np.random.default_rng(6)
    x = rng.integers(-127, 128, (3, 1, 90)).astype(np.int8)
    w = rng.integers(-127, 128, (1, 5, 90)).astype(np.int8)
    got = tint.int_dot_clip(_t(x), _t(w), 12)
    want = jax.vmap(jax.vmap(lambda a, b: rint.int_dot_clip(a, b, 12),
                             in_axes=(None, 0)), in_axes=(0, None))(
        jnp.asarray(x[:, 0]), jnp.asarray(w[0]))
    _eq(want[0], got[0])
    _eq(want[1], got[1])


def test_average_accumulator_bits():
    for args in ((12345, 678, 9), (0, 0, 8), (576 * 64, 900, 12, 24)):
        _eq(rint.average_accumulator_bits(*args),
            tint.average_accumulator_bits(*args))
    n = np.array([10, 200, 3000], np.int64)
    f = np.array([1, 17, 0], np.int64)
    _eq(rint.average_accumulator_bits(jnp.asarray(n), jnp.asarray(f), 10),
        tint.average_accumulator_bits(_t(n), _t(f), 10))


# ---------------------------------------------------------------------------
# core.energy
# ---------------------------------------------------------------------------


def test_energy_model_equals_reference():
    assert tenergy.PAPER_TABLE3 == renergy.PAPER_TABLE3
    assert tenergy.PAPER_TABLE2 == renergy.PAPER_TABLE2
    for name in ("FP8_MODEL", "INT8_MODEL"):
        r, t = getattr(renergy, name), getattr(tenergy, name)
        for f in ("name", "e_conventional_mac", "e_narrow_mac",
                  "e_wide_flush", "e_skip_check", "e_skipped_mac",
                  "static_w_conv", "static_w_dmac"):
            assert getattr(t, f) == getattr(r, f), (name, f)
        for args in ((10**6, 20000), (10**6, 20000, 40000, True),
                     (12345, 999, 77, False), (0, 0)):
            for m in ("dmac_energy", "savings", "average_power_uw"):
                assert getattr(t, m)(*args) == pytest.approx(
                    getattr(r, m)(*args), rel=1e-15, abs=1e-300)
        assert t.conventional_energy(4096) == r.conventional_energy(4096)
    # the paper's calibration point
    n = 10**6
    assert tenergy.FP8_MODEL.savings(n, int(0.02 * n)) == pytest.approx(
        0.336, abs=1e-3)
    assert tenergy.INT8_MODEL.savings(n, int(0.02 * n)) == pytest.approx(
        0.154, abs=1e-3)


def test_core_exports():
    import repro.core as rcore
    missing = set(rcore.__all__) - set(tcore.__all__)
    assert not missing, missing
    for name in ("mgs_matvec_exact", "quantum_exponent"):
        assert hasattr(tcore, name)
