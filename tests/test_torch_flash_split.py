"""B2's split order on the CPU: a plain model of the Hopper kernel's
arithmetic order (``csrc/mgs_attention.cu``) held bitwise to the twin.

The kernel splits a slice's chunks over the blocks of a cluster, one chunk
a block and pass. Each block computes its chunk's pieces from the prefix
maxima (m_{j-1} from the carried max and the maxima of the cluster's earlier
chunks, m_j = max(m_{j-1}, max s_j)): alpha_j, p_j, the denominator by its
warp-grouped neighbour-pair tree (a lane's run of keys in registers, then
five shuffle levels), p_j * v re-quantized and o_chunk_j. Only the fold
``l = l * alpha + psum``, ``o = o * alpha + o_chunk`` runs in ascending j.
Query rows go in tiles of 16. The model below repeats that order op for op
(the exact integer contractions and the re-quantization reuse the twin's
helpers, which have no order to get wrong) and must equal
``kernels/mgs_attention.py::_flash_plain`` bit for bit: lengths at and
around chunk edges, passes past the cluster size, dead slices, shared and
per-row scale rows, chunks 32 / 96 / 128, E4M3 / E3M4, 1 to 192 rows, head
dims 64 / 128 / 168. One case is also held to the reference's Pallas
kernel (interpret mode) within ``tests/test_torch_attention.py``'s
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_attention import (  # noqa: E402
    mgs_flash_attention as r_flash)

from repro_torch.core.formats import E3M4, E4M3, encode_bits  # noqa: E402
from repro_torch.core.formats import round_to_format  # noqa: E402
from repro_torch.kernels import mgs_attention as ta  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    _fixed_point, _limb_split, _limbs64, _round_decompose_e4m3, out_scale)
from repro_torch.quant.quantize import recip  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = 16          # csrc/mgs_attention.cu: kRows (a block's query rows)
WARPS = 8          # kWarps
MAX_CLUSTER = 8    # kMaxCluster


def cluster_size(nb: int) -> int:
    """The launcher's cluster: the least power of two >= min(nb, 8)."""
    cl = 1
    while cl < nb and cl < MAX_CLUSTER:
        cl *= 2
    return cl



def tree_keys(n: int) -> int:
    """Keys of the kernel's softmax tree: the next power of two, >= 32."""
    return max(32, 1 << max(0, (n - 1).bit_length()))


def softmax_warps(rows: int, n: int) -> int:
    """Warps the kernel gives a row: all 8 shared among the tile's rows
    (rounded up to a power of two), at most one per 32 tree keys."""
    rp2 = 1
    while rp2 < rows and rp2 < WARPS:
        rp2 *= 2
    return min(WARPS // rp2, tree_keys(n) // 32)


def warp_tree(p, warps=1):
    """The kernel's denominator over the last axis: ``warps`` x 32 lanes,
    each holding a contiguous run of keys (zero-padded to the tree's keys,
    run a power of two); the run summed pairwise in registers, then five
    xor-shuffle levels in which both lanes of a pair add (each in its own
    operand order), then the warps' sums pairwise."""
    n = p.shape[-1]
    keys = tree_keys(n)
    run = keys // (32 * warps)
    x = F.pad(p, (0, keys - n)).reshape(*p.shape[:-1], warps, 32, run)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    x = x[..., 0]
    lane = torch.arange(32)
    for m in (1, 2, 4, 8, 16):
        x = x + x[..., lane ^ m]
    assert torch.equal(x, x[..., :1].expand_as(x))   # every lane agrees
    x = x[..., 0]
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x


def flash_split(q_codes, k_pool, v_pool, bt, live, qk, vs, bias, fmt,
                per_pass=None):
    """The kernel's order: per slice and 16-row tile, passes of
    ``per_pass`` chunks (the cluster's blocks, one chunk each); a pass's
    pieces from the prefix maxima, then the in-order fold."""
    N, T, D = q_codes.shape
    chunk, nb, rs = k_pool.shape[1], bt.shape[1], qk.shape[1]
    per = per_pass or cluster_size(nb)
    osc, rmax = out_scale(fmt), recip(fmt.max_finite)
    out = torch.empty(N, T, D)
    for n in range(N):
        nlive = min(-(-int(live[n]) // chunk), nb)
        for r0 in range(0, T, ROWS):
            r1 = min(T, r0 + ROWS)
            R = r1 - r0
            warps = softmax_warps(R, chunk)
            lq = _limbs64(q_codes[n:n + 1, r0:r1], fmt)

            def rows(x, j):
                x = x[n:n + 1, :1] if rs == 1 else x[n:n + 1, r0:r1]
                return x[..., j * chunk:(j + 1) * chunk]
            m = torch.full((1, R, 1), -float("inf"))
            l = torch.zeros(1, R, 1)
            o = torch.zeros(1, R, D)
            for p0 in range(0, nlive, per):
                js = range(p0, min(p0 + per, nlive))
                tiles = [int(bt[n, j]) for j in js]
                s, cmax = [], []
                for j, tile in zip(js, tiles):
                    lk = _limbs64(k_pool[tile:tile + 1], fmt)
                    raw = ta._combine_classes(ta._class_dots(
                        lq, [x.transpose(-1, -2) for x in lk])) * osc
                    s.append(raw * rows(qk, j) + rows(bias, j))
                    cmax.append(s[-1].amax(dim=-1, keepdim=True))
                pieces = []
                for c, (j, tile) in enumerate(zip(js, tiles)):
                    m_prev = m
                    for cm in cmax[:c]:
                        m_prev = torch.maximum(m_prev, cm)
                    m_new = torch.maximum(m_prev, cmax[c])
                    alpha = torch.exp(m_prev - m_new)
                    pr = torch.exp(s[c] - m_new)
                    pv = pr * rows(vs, j)
                    sp = torch.clamp_min(pv.abs().amax(dim=-1, keepdim=True),
                                         ta._TINY) * rmax
                    sm, e = _round_decompose_e4m3(pv / sp, fmt,
                                                  gate_subnormal=False)
                    lp = [x.to(torch.float64)
                          for x in _limb_split(_fixed_point(sm, e))]
                    lv = _limbs64(v_pool[tile:tile + 1], fmt)
                    och = ta._combine_classes(ta._class_dots(lp, lv)) * osc \
                        * sp
                    pieces.append((alpha, warp_tree(pr, warps), och))
                for cm in cmax:
                    m = torch.maximum(m, cm)
                for alpha, psum, och in pieces:     # ascending j
                    l = l * alpha + psum
                    o = o * alpha + och
            out[n, r0:r1] = (o / torch.clamp_min(l, ta._TINY))[0]
    return out


def _codes(rng, shape, fmt, scale=30.0):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return encode_bits(round_to_format(x * scale, fmt), fmt)


def _inputs(seed, N, T, D, chunk, nb, lens, rs, fmt):
    """A permuted block table into a pool with stale blocks; entries past a
    slice's live prefix point at block 0 (the trash block, random codes).
    Scale rows are shared (rs = 1) or per row with staggered horizons."""
    rng = np.random.default_rng(seed)
    P = N * nb + 1
    q = _codes(rng, (N, T, D), fmt)
    kp, vp = _codes(rng, (P, chunk, D), fmt), _codes(rng, (P, chunk, D), fmt)
    bt = torch.from_numpy(1 + rng.permutation(P - 1)[:N * nb].astype(
        np.int32)).reshape(N, nb)
    live = torch.tensor(lens, dtype=torch.int32)
    used = -(-live.to(torch.int64) // chunk)
    bt[torch.arange(nb)[None] >= used[:, None]] = 0
    S = nb * chunk
    qk = torch.from_numpy(rng.uniform(0.5, 1.5, (N, rs, S)).astype(
        np.float32) * 2e-3)
    vs = torch.from_numpy(rng.uniform(0.5, 1.5, (N, rs, S)).astype(
        np.float32) * 1e-2)
    horizon = live[:, None] - torch.arange(rs)[None].flip(1)
    bias = torch.where(torch.arange(S)[None, None] < horizon[:, :, None],
                       0.0, -1e30).to(torch.float32)
    return q, kp, vp, bt, live, qk, vs, bias


CASES = {  # N, T (rows), D, chunk, nb, lengths, rs, fmt
    "edges-chunk32": (6, 1, 64, 32, 4, [0, 1, 31, 32, 33, 128], 1, E4M3),
    "edges-chunk96-padded-tree": (6, 4, 128, 96, 3, [0, 1, 95, 96, 97, 288],
                                  4, E3M4),
    "edges-chunk128-d168": (6, 1, 168, 128, 2, [0, 1, 127, 128, 129, 256],
                            1, E4M3),
    "one-pass-nb8": (3, 4, 64, 32, 8, [256, 225, 0], 1, E3M4),
    "two-passes-nb9": (3, 4, 64, 32, 9, [288, 257, 256], 4, E4M3),
    "three-passes-nb17": (3, 1, 128, 32, 17, [544, 513, 33], 1, E4M3),
    "granite-decode-48-rows": (2, 48, 128, 128, 3, [384, 130], 1, E4M3),
    "granite-verify-192-rows": (2, 192, 128, 128, 2, [256, 1], 192, E4M3),
    "gemma-d168-4-rows": (3, 4, 168, 128, 3, [384, 200, 0], 4, E3M4),
    "minicpm-d64-20-rows": (2, 20, 64, 128, 2, [200, 17], 20, E4M3),
    "dead-slices": (3, 4, 64, 32, 2, [0, 0, 0], 4, E4M3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_order_equals_twin(case):
    N, T, D, chunk, nb, lens, rs, fmt = CASES[case]
    args = _inputs(list(CASES).index(case), N, T, D, chunk, nb, lens, rs,
                   fmt)
    want = ta._flash_plain(*args, fmt)
    got = flash_split(*args, fmt)
    assert torch.equal(got, want)
    dead = [i for i, n in enumerate(lens) if n == 0]
    assert not got[dead].any()


@pytest.mark.parametrize("per_pass", [1, 2, 3, 4, 8, 16])
def test_any_pass_size_gives_the_same_bits(per_pass):
    args = _inputs(7, 2, 4, 64, 32, 17, [544, 300], 4, E4M3)
    assert torch.equal(flash_split(*args, E4M3, per_pass=per_pass),
                       ta._flash_plain(*args, E4M3))


@pytest.mark.parametrize("rows", [1, 2, 4, 16])
@pytest.mark.parametrize("n", [4, 32, 96, 128, 200, 256, 512])
def test_warp_tree_is_the_pairwise_tree(n, rows):
    rng = np.random.default_rng(n)
    p = torch.from_numpy(rng.exponential(size=(3, n)).astype(np.float32))
    p[:, ::7] = 0.0
    assert torch.equal(warp_tree(p, softmax_warps(rows, n)),
                       ta._pairwise_sum_cols(p))


def test_cluster_and_warp_rules():
    assert [cluster_size(nb) for nb in (1, 2, 3, 5, 8, 9, 33)] == \
        [1, 2, 4, 8, 8, 8, 8]
    assert [softmax_warps(r, 128) for r in (1, 2, 3, 4, 5, 8, 16)] == \
        [4, 4, 2, 2, 1, 1, 1]
    assert [softmax_warps(1, n) for n in (32, 64, 96, 256, 512)] == \
        [1, 2, 4, 8, 8]


def test_split_order_against_the_reference_kernel():
    """The model on ``tests/test_torch_attention.py``'s inputs (N 4, T 2,
    S 300, D 16, chunk 128; one live slice, two ragged, one dead) against
    the reference Pallas kernel in interpret mode."""
    N, T, S, D, chunk = 4, 2, 300, 16, 128
    rng = np.random.default_rng(0)
    q = np.asarray(rf.round_to_format(jnp.asarray(
        rng.standard_normal((N, T, D)).astype(np.float32) * 30), rf.E4M3))
    kv = np.asarray(rf.round_to_format(jnp.asarray(rng.standard_normal(
        (2, N, S, D)).astype(np.float32) * 20), rf.E4M3))
    kc = np.asarray(rf.encode_bits(jnp.asarray(kv[0]), rf.E4M3))
    vc = np.asarray(rf.encode_bits(jnp.asarray(kv[1]), rf.E4M3))
    qk = (rng.uniform(0.5, 1.5, (N, S)) * 2e-3).astype(np.float32)
    vs = (rng.uniform(0.5, 1.5, (N, S)) * 1e-2).astype(np.float32)
    lengths = np.array([S, 137, 0, 128], np.int32)
    bias = np.where(np.arange(S)[None] < lengths[:, None], 0.0,
                    -1e30).astype(np.float32)
    ref = np.asarray(r_flash(*(jnp.asarray(a) for a in
                               (q, kc, vc, qk, vs, bias)), rf.E4M3,
                             chunk=chunk, use_kernel=True, interpret=True,
                             lengths=jnp.asarray(lengths)))
    nc = -(-S // chunk)
    pad = nc * chunk - S
    def t(a):
        return torch.from_numpy(np.array(a))
    kp = F.pad(t(kc), (0, 0, 0, pad)).reshape(N * nc, chunk, D)
    vp = F.pad(t(vc), (0, 0, 0, pad)).reshape(N * nc, chunk, D)
    rows = [F.pad(t(qk), (0, pad)), F.pad(t(vs), (0, pad)),
            F.pad(t(bias), (0, pad), value=-1e30)]
    bt = torch.arange(N * nc, dtype=torch.int32).reshape(N, nc)
    got = flash_split(encode_bits(t(q), E4M3), kp, vp, bt, t(lengths),
                      *(r[:, None] for r in rows), E4M3).numpy()
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
