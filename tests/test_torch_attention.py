"""Port parity: the B2 twin (exact-MGS flash-decode attention) against the
reference Pallas kernel in interpret mode.

Held within a tolerance, not bitwise: the softmax passes through ``exp``,
which XLA:CPU and PyTorch's CPU kernels round differently in the last
ulp, and XLA:CPU contracts ``s * qk + bias``, ``l * alpha + sum`` and
``o * alpha + o_chunk`` into fused multiply-adds where the kernel
contract (and the port) rounds twice. A one-ulp change of a probability
can move its FP8 re-quantization by one code step, so the bound is a
small fraction of the output scale. Inside the port the invariants are
bitwise: early exit == walking inert tails, and a block table is
transparent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_attention import (  # noqa: E402
    mgs_flash_attention as r_flash)

from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels import mgs_attention as ta  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, T, S, D, CHUNK = 4, 2, 300, 16, 128


def _inputs(seed=0, T=T, S=S):
    rng = np.random.default_rng(seed)
    q = np.asarray(rf.round_to_format(jnp.asarray(
        rng.standard_normal((N, T, D)).astype(np.float32) * 30), rf.E4M3))
    kv = rng.standard_normal((2, N, S, D)).astype(np.float32) * 20
    kv = np.asarray(rf.round_to_format(jnp.asarray(kv), rf.E4M3))
    kc = np.asarray(rf.encode_bits(jnp.asarray(kv[0]), rf.E4M3))
    vc = np.asarray(rf.encode_bits(jnp.asarray(kv[1]), rf.E4M3))
    qk = (rng.uniform(0.5, 1.5, (N, S)) * 2e-3).astype(np.float32)
    vs = (rng.uniform(0.5, 1.5, (N, S)) * 1e-2).astype(np.float32)
    lengths = np.array([S, 137, 0, 128], np.int32)
    pos = np.arange(S)[None]
    bias = np.where(pos < lengths[:, None], 0.0, -1e30).astype(np.float32)
    return q, kc, vc, qk, vs, bias, lengths


def _port(q, kc, vc, qk, vs, bias, lengths, **kw):
    t = [torch.from_numpy(a) for a in (q, kc, vc, qk, vs, bias)]
    lens = None if lengths is None else torch.from_numpy(lengths)
    return ta.mgs_flash_attention(*t, tf.E4M3, chunk=CHUNK, lengths=lens,
                                  **kw).numpy()


def test_twin_vs_reference_kernel():
    q, kc, vc, qk, vs, bias, lengths = _inputs()
    ref = np.asarray(r_flash(*(jnp.asarray(a) for a in
                               (q, kc, vc, qk, vs, bias)), rf.E4M3,
                             chunk=CHUNK, use_kernel=True, interpret=True,
                             lengths=jnp.asarray(lengths)))
    port = _port(q, kc, vc, qk, vs, bias, lengths)
    assert port.shape == ref.shape == (N, T, D)
    np.testing.assert_array_equal(port[2], 0.0)     # live == 0 -> zeros
    np.testing.assert_array_equal(ref[2], 0.0)
    # values are ~|v| * v_scale ~ 0.2; one FP8 step of one weight moves an
    # output by well under 1e-3 of that scale
    np.testing.assert_allclose(port, ref, rtol=2e-3, atol=2e-4)
    plain = _port(q, kc, vc, qk, vs, bias, lengths, use_kernel=False)
    np.testing.assert_array_equal(port, plain)


def test_early_exit_bitwise_equals_full_walk():
    q, kc, vc, qk, vs, bias, lengths = _inputs(seed=1)
    # zero the dead tails (the engine's cache is zero-initialized)
    dead = np.arange(S)[None] >= lengths[:, None]
    kc, vc = kc.copy(), vc.copy()
    kc[dead], vc[dead] = 0, 0
    qk, vs = np.where(dead, 0, qk), np.where(dead, 0, vs)
    gated = _port(q, kc, vc, qk, vs, bias, lengths)
    full = _port(q, kc, vc, qk, vs, bias, None)
    live = lengths > 0
    np.testing.assert_array_equal(gated[live], full[live])


def test_block_table_is_transparent():
    """The kernel wrapper's table walk: a permuted pool with its table
    gives the dense result bitwise (the paged entries reuse this)."""
    q, kc, vc, qk, vs, bias, lengths = _inputs(seed=2, S=256)
    dense = _port(q, kc, vc, qk, vs, bias, lengths)
    nb = 256 // CHUNK
    perm = np.random.default_rng(3).permutation(N * nb)
    kpool = kc.reshape(N * nb, CHUNK, D)
    vpool = vc.reshape(N * nb, CHUNK, D)
    inv = np.argsort(perm)
    bt = inv.reshape(N, nb).astype(np.int32)
    out = ta.mgs_flash_blocks(
        torch.from_numpy(tf.encode_bits(torch.from_numpy(q)).numpy()),
        torch.from_numpy(kpool[perm]), torch.from_numpy(vpool[perm]),
        torch.from_numpy(bt), torch.from_numpy(lengths),
        *(torch.from_numpy(a)[:, None] for a in (qk, vs, bias)), tf.E4M3)
    np.testing.assert_array_equal(out.numpy(), dense)


def test_per_row_scales_and_pairwise_tree():
    q, kc, vc, qk, vs, bias, lengths = _inputs(seed=4, S=256)
    nb = 256 // CHUNK
    qc = tf.encode_bits(torch.from_numpy(q))
    bt = torch.arange(N * nb, dtype=torch.int32).reshape(N, nb)
    rows = [torch.from_numpy(np.repeat(a[:, None], T, axis=1))
            for a in (qk, vs, bias)]
    shared = [torch.from_numpy(a)[:, None] for a in (qk, vs, bias)]
    args = (qc, torch.from_numpy(kc.reshape(-1, CHUNK, D)),
            torch.from_numpy(vc.reshape(-1, CHUNK, D)), bt,
            torch.from_numpy(lengths))
    a = ta.mgs_flash_blocks(*args, *rows, tf.E4M3)
    b = ta.mgs_flash_blocks(*args, *shared, tf.E4M3)
    assert torch.equal(a, b)
    x = torch.arange(1, 7, dtype=torch.float32)[None] * 0.1
    assert ta._pairwise_sum_cols(x).item() == (
        ((x[0, 0] + x[0, 1]) + (x[0, 2] + x[0, 3]))
        + ((x[0, 4] + x[0, 5]) + 0.0)).item()
