"""Port parity: ``qeinsum`` for every contraction of the dense model,
bitwise (reference: the fused Pallas kernel tier in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.quant import prepared as rprep  # noqa: E402
from repro.quant.config import FP8_MGS_SERVE_KV as R_KV  # noqa: E402
from repro.quant.qeinsum import qeinsum as r_qeinsum  # noqa: E402

from repro_torch.quant import prepared as tprep  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_KV  # noqa: E402
from repro_torch.quant.qeinsum import plan_qeinsum, qeinsum  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R_CFG = R_KV.replace(block_k=32)
T_CFG = FP8_MGS_SERVE_KV.replace(block_k=32)


def _f(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-3, 3, shape))).astype(np.float32)


# (spec, x shape, w shape, prepared w: (stack_ndim, k_ndim) or None)
CASES = {
    "proj": ("mk,kn->mn", (6, 40), (40, 24), (0, 1)),
    "out_proj": ("bthd,hdo->bto", (2, 3, 4, 8), (4, 8, 20), (0, 2)),
    "scores": ("btkgh,bskh->bkgts", (2, 5, 2, 2, 16), (2, 7, 2, 16), None),
    "values": ("bkgts,bskh->btkgh", (2, 2, 2, 5, 7), (2, 7, 2, 16), None),
    "logits": ("btd,dv->btv", (3, 1, 32), (32, 50), (0, 1)),
}


@pytest.mark.parametrize("tier", ["kernel", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_qeinsum_bitwise(case, tier):
    spec, xs, ws, prep = CASES[case]
    x, w = _f(xs, 1), _f(ws, 2)
    # the port's plain tier (use_kernel=False: the limb oracle, slice by
    # slice) equals the kernel tier bitwise in the single-flush regime
    t_cfg = T_CFG if tier == "kernel" else T_CFG.replace(use_kernel=False,
                                                         fused=False)
    rw, tw = jnp.asarray(w), torch.from_numpy(w)
    if prep is not None:
        rw = rprep.prepare_weight(rw, R_CFG, stack_ndim=prep[0],
                                  k_ndim=prep[1])
        tw = tprep.prepare_weight(tw, t_cfg, stack_ndim=prep[0],
                                  k_ndim=prep[1])
    ref = np.asarray(r_qeinsum(spec, jnp.asarray(x), rw, R_CFG,
                               out_dtype=jnp.float32))
    port = qeinsum(spec, torch.from_numpy(x), tw, t_cfg,
                   out_dtype=torch.float32)
    assert tuple(port.shape) == ref.shape
    np.testing.assert_array_equal(ref, port.numpy())


def test_qeinsum_per_row_act_and_silu_epilogue():
    cfg_r, cfg_t = R_CFG.replace(per_row_act=True), T_CFG.replace(
        per_row_act=True)
    x, w = _f((6, 40), 3), _f((40, 24), 4)
    ref = np.asarray(r_qeinsum("mk,kn->mn", jnp.asarray(x), jnp.asarray(w),
                               cfg_r))
    port = qeinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(w),
                   cfg_t)
    np.testing.assert_array_equal(ref, port.numpy())
    ref = np.asarray(r_qeinsum("mk,kn->mn", jnp.asarray(x), jnp.asarray(w),
                               R_CFG, activation="silu"))
    port = qeinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(w),
                   T_CFG, activation="silu")
    # silu's exp differs between XLA:CPU and PyTorch by float32 ulps
    np.testing.assert_allclose(port.numpy(), ref, rtol=4e-6, atol=1e-6)


def test_qeinsum_dtype_none_and_plan():
    from repro_torch.quant.config import NONE
    x, w = _f((2, 3, 4, 8), 5), _f((4, 8, 20), 6)
    ref = np.einsum("bthd,hdo->bto", x.astype(np.float64), w)
    port = qeinsum("bthd,hdo->bto", torch.from_numpy(x), torch.from_numpy(w),
                   NONE)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    p = plan_qeinsum("btkgh,bskh->bkgts")
    assert (p.batch, p.m, p.k, p.n) == ("bk", "tg", "h", "s")
