"""Port parity for the pre-decomposed exact matmul (B4) and the limb planes
that feed it.

* ``PreparedWeight.limbs`` (stacked per-layer weights, the attention
  out-projection's flattened K, the tied logits head) bitwise against the
  reference's, kept exactly where the reference keeps them
  (``use_kernel and not fused``);
* the B4 twin ``mgs_matmul_exact`` bitwise against the reference Pallas
  kernel ``mgs_matmul_exact_pallas(interpret=True)``, through its values
  and its ``w_limbs=`` inputs, at ragged M, K, N, ``flush_period`` None and
  2, in E4M3 and E3M4;
* B4 == B1 (twins) at equal ``block_k`` and ``flush_period``;
* the dispatch: a prepared weight without limbs falls back to limbs
  decomposed from its values (the reference's rule), with the same bits;
  batched ``qmatmul`` / ``qeinsum`` run one B4 call over all slices, equal
  to the reference's ``vmap``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.quant import config as rq  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402
from repro.quant.qeinsum import qeinsum as r_qeinsum  # noqa: E402
from repro.quant.qmatmul import qmatmul as r_qmatmul  # noqa: E402

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402
from repro_torch.quant import prepared as tprep  # noqa: E402
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


rmm = importlib.import_module("repro.kernels.mgs_matmul")
tmm = importlib.import_module("repro_torch.kernels.mgs_matmul")

R_EXACT = rq.FP8_MGS_EXACT.replace(use_kernel=True)
T_EXACT = tq.FP8_MGS_EXACT.replace(use_kernel=True)


def _vals(shape, fmt, seed, scale=40.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    return tf.round_to_format(torch.from_numpy(x), tf.get_format(fmt)).numpy()


def test_prepared_limbs_bitwise():
    rng = np.random.default_rng(9)
    # (layers, K, N), the out-projection's (layers, heads, hd, N), a tied
    # (vocab, d_model) table
    wq = (rng.standard_normal((2, 64, 96)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((2, 4, 16, 64)) * 0.1).astype(np.float32)
    emb = (rng.standard_normal((256, 64)) * 0.02).astype(np.float32)
    for w, stack, k_ndim in ((wq, 1, 1), (wo, 1, 2), (wq[0], 0, 1)):
        r = rprep.prepare_weight(jnp.asarray(w), R_EXACT, stack_ndim=stack,
                                 k_ndim=k_ndim)
        t = tprep.prepare_weight(torch.from_numpy(w), T_EXACT,
                                 stack_ndim=stack, k_ndim=k_ndim)
        assert t.limbs.shape == r.limbs.shape and t.limbs.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(r.limbs), t.limbs.numpy())
        np.testing.assert_array_equal(np.asarray(r.codes), t.codes.numpy())
        if stack:                              # a layer keeps its planes
            assert torch.equal(t.slice(1).limbs, t.limbs[1])
    rh = rprep.prepare_logits_head({"embed": jnp.asarray(emb)}, R_EXACT,
                                   tied=True)
    th = tprep.prepare_logits_head({"embed": torch.from_numpy(emb)}, T_EXACT,
                                   tied=True)
    np.testing.assert_array_equal(np.asarray(rh["unembed_prepared"].limbs),
                                  th["unembed_prepared"].limbs.numpy())
    # kept only where the reference keeps them
    tw = torch.from_numpy(wq)
    for cfg in (tq.FP8_MGS_SERVE, tq.FP8_MGS_EXACT):
        assert tprep.prepare_weight(tw, cfg, stack_ndim=1).limbs is None
    forced = tprep.prepare_weight(tw, tq.FP8_MGS_SERVE, stack_ndim=1,
                                  keep_limbs=True)
    assert torch.equal(forced.limbs,
                       tprep.prepare_weight(tw, T_EXACT, stack_ndim=1).limbs)


@pytest.mark.parametrize("mkn", [(5, 300, 70), (48, 257, 56)])
@pytest.mark.parametrize("fmt", ["e4m3", "e3m4"])
def test_b4_twin_vs_pallas(fmt, mkn):
    M, K, N = mkn
    x, w = _vals((M, K), fmt, 0), _vals((K, N), fmt, 1)
    rfmt, tfmt = rf.get_format(fmt), tf.get_format(fmt)
    rl = rmm.limb_decompose(jnp.asarray(w), rfmt)
    xl = tmm.limb_decompose(torch.from_numpy(x), tfmt)
    wl = tmm.limb_decompose(torch.from_numpy(w), tfmt)
    np.testing.assert_array_equal(np.asarray(rl), wl.numpy())
    for flush_period in (None, 2):      # a runtime kernel operand
        kw = dict(block_m=32, block_n=32, block_k=64,
                  flush_period=flush_period, interpret=True)
        ref = np.asarray(rmm.mgs_matmul_exact_pallas(
            jnp.asarray(x), jnp.asarray(w), rfmt, **kw))
        ref_l = np.asarray(rmm.mgs_matmul_exact_pallas(
            jnp.asarray(x), None, rfmt, w_limbs=rl, **kw))
        np.testing.assert_array_equal(ref, ref_l)
        got = tmm.mgs_matmul_exact(xl, wl, tfmt, block_k=64,
                                   flush_period=flush_period)
        np.testing.assert_array_equal(ref, got.numpy())
        # B4 == B1 at equal block_k and flush period
        b1 = tmm.mgs_matmul_exact_fused(
            tf.encode_bits(torch.from_numpy(x), tfmt),
            tf.encode_bits(torch.from_numpy(w), tfmt), tfmt, block_k=64,
            flush_period=flush_period)
        assert torch.equal(got, b1)


def test_b4_batched_and_shared_planes():
    xs = np.stack([_vals((5, 96), "e4m3", 10 + i) for i in range(3)])
    ws = np.stack([_vals((96, 24), "e4m3", 20 + i) for i in range(3)])
    xl = tmm.limb_decompose(torch.from_numpy(xs)).movedim(0, 1)
    wl = tmm.limb_decompose(torch.from_numpy(ws)).movedim(0, 1)
    out = tmm.mgs_matmul_exact(xl, wl, block_k=32, flush_period=1)
    shared = tmm.mgs_matmul_exact(xl, wl[0], block_k=32)
    for i in range(3):
        ref = rmm.mgs_matmul_exact_pallas(
            jnp.asarray(xs[i]), jnp.asarray(ws[i]), block_k=32,
            flush_period=1, interpret=True)
        np.testing.assert_array_equal(np.asarray(ref), out[i].numpy())
        ref0 = rmm.mgs_matmul_exact_pallas(
            jnp.asarray(xs[i]), jnp.asarray(ws[0]), block_k=32,
            interpret=True)
        np.testing.assert_array_equal(np.asarray(ref0), shared[i].numpy())
    with pytest.raises(ValueError, match="limb planes"):
        tmm.mgs_matmul_exact(xl.to(torch.int32), wl)


def test_values_fallback_for_prepared_without_limbs():
    x, w = _vals((4, 3, 80), "e4m3", 2), _vals((80, 40), "e4m3", 3)
    wt = torch.from_numpy(w * 0.37)
    with_limbs = tprep.prepare_weight(wt, T_EXACT)
    without = tprep.prepare_weight(wt, tq.FP8_MGS_SERVE)
    assert with_limbs.limbs is not None and without.limbs is None
    assert torch.equal(with_limbs.codes, without.codes)
    wv = with_limbs.values()
    s = np.float32(0.0125)
    want = np.asarray(rops.mgs_matmul(
        jnp.asarray(x), jnp.asarray(wv.numpy()), rf.E4M3, "exact",
        block_m=8, block_n=8, block_k=32, scale=s))
    for w_arg in (wv, with_limbs, without):
        got = ops.mgs_matmul(torch.from_numpy(x), w_arg, tf.E4M3, "exact",
                             fused=False, block_k=32,
                             scale=torch.tensor(s))
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.weight_limbs(without, tf.E4M3), with_limbs.limbs)
    with pytest.raises(ValueError, match="codes"):
        ops.mgs_matmul(tf.encode_bits(torch.from_numpy(x)), wt, fused=False)


def test_batched_qmatmul_and_qeinsum_one_b4_call():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 5, 64)) * 3).astype(np.float32)
    w = (rng.standard_normal((4, 64, 24)) * 0.2).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, c: r_qmatmul(a, c, R_EXACT.replace(
        use_kernel=False)))(jnp.asarray(x), jnp.asarray(w)))
    got = qmatmul(torch.from_numpy(x), torch.from_numpy(w), T_EXACT,
                  batched=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # a stacked prepared weight through a batched einsum carries its limbs
    q = (rng.standard_normal((4, 3, 64)) * 2).astype(np.float32)
    ws = (rng.standard_normal((4, 64, 16)) * 0.3).astype(np.float32)
    rw = rprep.prepare_weight(jnp.asarray(ws), R_EXACT, stack_ndim=1)
    tw = tprep.prepare_weight(torch.from_numpy(ws), T_EXACT, stack_ndim=1)
    want = np.asarray(r_qeinsum("bmk,bkn->bmn", jnp.asarray(q), rw,
                                R_EXACT.replace(use_kernel=False)))
    got = qeinsum("bmk,bkn->bmn", torch.from_numpy(q), tw, T_EXACT)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), qeinsum("bmk,bkn->bmn", torch.from_numpy(q), tw,
                             tq.FP8_MGS_SERVE).numpy())
