"""Port parity for the stationary schedules of the exact fused matmul (B3).

The port's stationary twins and ``mgs_matmul(..., schedule=)`` against the
reference Pallas kernel ``mgs_matmul_exact_fused_pallas(schedule=...,
interpret=True)`` and the port's own B1 twin, at M, K, N that are no tile
multiple, in E4M3 and E3M4, at ``flush_period`` 1 and None: bitwise with
no epilogue and with a scale row. With scale and bias the port is bitwise
equal to its B1 twin and to ``(r * scale) + bias`` rounded twice, and
the reference (whose CPU run contracts ``r * scale + bias`` into one FMA)
equal to that FMA of the same sums; the silu
epilogue passes through ``exp`` (XLA:CPU vs PyTorch): within
``rtol=4e-6, atol=1e-6``, the bound of ``tests/test_torch_qeinsum.py``.

Also: ``ws_stripe_bytes`` equals the reference's, an over-budget stripe
warns and falls back to ``"output"`` with equal bits (the reference's
``tests/test_prepared.py`` pin), the kernel-side hard check raises, and
batched ``qmatmul`` / ``qeinsum`` give equal bits under every schedule.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels import mgs_matmul as rmm  # noqa: E402
from repro.quant.config import FP8_MGS_SERVE_KV as R_KV  # noqa: E402
from repro.quant.qeinsum import qeinsum as r_qeinsum  # noqa: E402

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_KV  # noqa: E402
from repro_torch.quant.qeinsum import qeinsum  # noqa: E402
from repro_torch.quant.qmatmul import qmatmul  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the module (the package re-exports the ops function under its name)
tmm = importlib.import_module("repro_torch.kernels.mgs_matmul")
M, K, N = 37, 300, 70
SCHEDULES = ("weight", "activation")


def _codes(shape, fmt, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 40
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    v = np.asarray(rf.round_to_format(jnp.asarray(x), rf.get_format(fmt)))
    return np.asarray(rf.encode_bits(jnp.asarray(v), rf.get_format(fmt)))


def _ref(xc, wc, fmt, schedule, **kw):
    return np.asarray(rmm.mgs_matmul_exact_fused_pallas(
        jnp.asarray(xc), jnp.asarray(wc), rf.get_format(fmt),
        schedule=schedule, block_m=32, block_n=32, block_k=32,
        interpret=True, **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("flush_period", [None, 1])
@pytest.mark.parametrize("fmt", ["e4m3", "e3m4"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_stationary_twin_bitwise(schedule, fmt, flush_period):
    xc, wc = _codes((M, K), fmt, 0), _codes((K, N), fmt, 1)
    tfmt = tf.get_format(fmt)
    kw = dict(block_k=32, flush_period=flush_period)
    twin = tmm.mgs_matmul_stationary_plain(_t(xc), _t(wc), tfmt,
                                           schedule=schedule, **kw)
    b1 = tmm.mgs_matmul_exact_fused_plain(_t(xc), _t(wc), tfmt, **kw)
    wrapped = tmm.mgs_matmul_exact_fused(_t(xc), _t(wc), tfmt,
                                         schedule=schedule, **kw)
    assert torch.equal(twin, b1) and torch.equal(wrapped, b1)
    np.testing.assert_array_equal(
        _ref(xc, wc, fmt, schedule, flush_period=flush_period),
        twin.numpy())
    vx, vw = tf.decode_bits(_t(xc), tfmt), tf.decode_bits(_t(wc), tfmt)
    via_ops = ops.mgs_matmul(vx, vw, tfmt, fused=True, schedule=schedule,
                             block_k=32, flush_period=flush_period)
    assert torch.equal(via_ops, b1)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_stationary_epilogues(schedule):
    xc, wc = _codes((M, K), "e4m3", 2), _codes((K, N), "e4m3", 3)
    rng = np.random.default_rng(4)
    s = (rng.uniform(0.5, 2, N) * 1e-3).astype(np.float32)
    b = (rng.standard_normal(N) * 3).astype(np.float32)
    tfmt = tf.E4M3

    def port(fn, **kw):
        extra = {} if fn is tmm.mgs_matmul_exact_fused_plain else {
            "schedule": schedule}
        return fn(_t(xc), _t(wc), tfmt, block_k=32, **extra, **kw)

    for kw in ({"scale": _t(s)}, {"scale": _t(s), "bias": _t(b)},
               {"scale": _t(s), "activation": "silu"}):
        st = port(tmm.mgs_matmul_stationary_plain, **kw)
        assert torch.equal(st, port(tmm.mgs_matmul_exact_fused_plain, **kw))
    rkw = lambda **k: _ref(xc, wc, "e4m3", schedule, **k)  # noqa: E731
    np.testing.assert_array_equal(
        rkw(scale=s), port(tmm.mgs_matmul_stationary_plain,
                           scale=_t(s)).numpy())
    # scale + bias: the port rounds twice; the reference's CPU run is
    # exactly the fused multiply-add of the same unscaled sums
    plain = port(tmm.mgs_matmul_stationary_plain).numpy()
    np.testing.assert_array_equal(
        port(tmm.mgs_matmul_stationary_plain, scale=_t(s),
             bias=_t(b)).numpy(), (plain * s) + b)
    np.testing.assert_array_equal(
        rkw(scale=s, bias=b),
        (plain.astype(np.float64) * s + b).astype(np.float32))
    np.testing.assert_allclose(
        port(tmm.mgs_matmul_stationary_plain, scale=_t(s),
             activation="silu").numpy(),
        rkw(scale=s, activation="silu"), rtol=4e-6, atol=1e-6)


def test_ws_stripe_bytes_matches_reference():
    for K_, block, bk in ((4096, 4, 128), (11008, 4, 128), (300, 64, 32),
                          (1, 16, 128), (129, 128, 128)):
        assert tmm.ws_stripe_bytes(K_, block, bk) == \
            rmm.ws_stripe_bytes(K_, block, bk)
    # the card's budget: 227 KB less the table and one staged sub-tile
    assert tmm.WS_STRIPE_BUDGET_BYTES == 232448 - 1024 - 6144
    assert tmm.stationary_block("activation", 4) == 4
    assert tmm.stationary_block("activation", 13) == 16
    assert tmm.stationary_block("weight", 4) == 64
    # the decode shapes of deepseek-7b fit; a 64-row prefill tile does not
    assert tmm.ws_stripe_bytes(11008, 4, 128) <= tmm.WS_STRIPE_BUDGET_BYTES
    assert tmm.ws_stripe_bytes(4096, 64, 128) > tmm.WS_STRIPE_BUDGET_BYTES


def test_over_budget_warns_and_falls_back(monkeypatch):
    xc, wc = _codes((8, 96), "e4m3", 5), _codes((96, 8), "e4m3", 6)
    vx, vw = tf.decode_bits(_t(xc)), tf.decode_bits(_t(wc))
    want = ops.mgs_matmul(vx, vw, fused=True, block_k=32)
    for schedule in SCHEDULES:
        assert ops._fused_schedule(schedule, 8, 96, 32) == schedule
    monkeypatch.setattr(tmm, "WS_STRIPE_BUDGET_BYTES", 1024)
    for schedule in SCHEDULES:
        with pytest.warns(UserWarning, match=f"{schedule}-stationary"):
            out = ops.mgs_matmul(vx, vw, fused=True, schedule=schedule,
                                 block_k=32)
        assert torch.equal(out, want)
    with pytest.raises(ValueError, match="schedule"):
        ops._fused_schedule("diagonal", 8, 96, 32)


def test_kernel_side_hard_check_raises(monkeypatch):
    xc, wc = _t(_codes((8, 96), "e4m3", 7)), _t(_codes((96, 8), "e4m3", 8))
    monkeypatch.setattr(tmm, "WS_STRIPE_BUDGET_BYTES", 1024)
    for schedule in SCHEDULES:
        with pytest.raises(ValueError, match="shared-memory budget"):
            tmm.mgs_matmul_exact_fused(xc, wc, schedule=schedule,
                                       block_k=32)
        with pytest.raises(ValueError, match="shared-memory budget"):
            tmm.mgs_matmul_stationary_plain(xc, wc, schedule=schedule,
                                            block_k=32)
    # the default budget refuses a 64-row prefill tile over K = 4096
    monkeypatch.undo()
    with pytest.raises(ValueError, match="786432 B"):
        tmm.check_stripe("activation", 64, 4096, 128)


def _f(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-3, 3, shape))).astype(np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_qmatmul_batched_under_each_schedule(per_row):
    """The batched launch (the score/value contractions) takes the
    schedule: equal bits under every schedule, for raw and prepared
    weights, with per-tensor and per-row activation scales."""
    x, w = _t(_f((3, 5, 40), 1)), _t(_f((3, 40, 24), 2))
    base = FP8_MGS_SERVE_KV.replace(block_k=32, per_row_act=per_row)
    pw = tprep.prepare_weight(w, base, stack_ndim=1)
    outs = {}
    for schedule in ("output",) + SCHEDULES:
        cfg = base.replace(schedule=schedule)
        outs[schedule] = (qmatmul(x, w, cfg, batched=True),
                          qmatmul(x, pw, cfg, batched=True,
                                  activation="silu"))
    for schedule in SCHEDULES:
        for a, b in zip(outs[schedule], outs["output"]):
            assert torch.equal(a, b), schedule


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec,xs,ws", [
    ("btkgh,bskh->bkgts", (2, 5, 2, 2, 16), (2, 7, 2, 16)),
    ("bkgts,bskh->btkgh", (2, 2, 2, 5, 7), (2, 7, 2, 16)),
])
def test_qeinsum_scores_values_match_reference(schedule, spec, xs, ws):
    """The prefill score/value contractions under a stationary schedule
    equal the reference's (its fused Pallas kernel in interpret mode)."""
    x, w = _f(xs, 3), _f(ws, 4)
    r_cfg = R_KV.replace(block_k=32, schedule=schedule)
    t_cfg = FP8_MGS_SERVE_KV.replace(block_k=32, schedule=schedule)
    ref = np.asarray(r_qeinsum(spec, jnp.asarray(x), jnp.asarray(w), r_cfg,
                               out_dtype=jnp.float32))
    port = qeinsum(spec, _t(x), _t(w), t_cfg, out_dtype=torch.float32)
    np.testing.assert_array_equal(ref, port.numpy())
