"""Port parity for the pure-SSM (Mamba) family: ``repro_torch.models.mamba``
against ``repro.models.mamba``, and falcon-mamba stacks on the group
``ServeEngine``.

* ``mamba_apply`` (one chunk, the odd-length one-token-a-chunk fallback,
  two chunks) and ``mamba_decode_step`` from its state against the
  reference's, unquantized: output and state within 1e-5 of their scale
  (the scan runs in the reference's pairing order; ``exp``, ``softplus``
  and the ``d_state`` contractions may round differently in the last ulp).
* Inside the port: a prefill of T tokens, then one decode step, matches a
  prefill of T + 1 tokens, in output and state.
* Reduced falcon-mamba-7b (packed and float preset) through
  ``_check_group_parity``, with ``ssm.wo`` scaled by 8: at the seed-0
  init every request echoes its last token, so the tokens would hold no
  information. Greedy tokens equal, logits within the engine bar,
  ``PREP_STATS`` flat. Float32 compute, as the MoE file; the conv state is
  cached in bfloat16 and ``A_log`` stays float32 as in the reference.
* ``launch.dryrun.family_b1_shapes`` is every shape the group engine launches
  B1 at for falcon-mamba under the smoke's traffic, and no other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.models import mamba as r_mamba  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    SSMCache, cast_params, init_cache, init_params, mamba_apply,
    mamba_decode_step)
from repro_torch.quant import PreparedWeight  # noqa: E402

from test_torch_model import _check_group_parity, _weights  # noqa: E402
from test_torch_moe import check_family_b1_shapes  # noqa: E402

ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(reduced_config(ARCH), compute_dtype="float32"),
            dataclasses.replace(r_reduced(ARCH), compute_dtype="float32"))


def _block_weights(cfg, seed=0):
    """One block's weights as float32 numpy, with nonzero conv / dt biases
    so that every term of the block is exercised."""
    rng = np.random.default_rng(seed)
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.d_conv)
    p = {"wx": rng.normal(0, d ** -0.5, (d, di)),
         "wz": rng.normal(0, d ** -0.5, (d, di)),
         "conv_w": rng.normal(0, 1 / k, (k, di)),
         "conv_b": rng.normal(0, 0.1, (di,)),
         "wdt_down": rng.normal(0, di ** -0.5, (di, r)),
         "wdt_up": rng.normal(0, r ** -0.5, (r, di)),
         "dt_bias": rng.normal(0, 0.1, (di,)),
         "wB": rng.normal(0, di ** -0.5, (di, n)),
         "wC": rng.normal(0, di ** -0.5, (di, n)),
         "A_log": np.log(np.broadcast_to(np.arange(1, n + 1), (di, n))),
         "D": np.ones(di), "wo": rng.normal(0, di ** -0.5, (di, d))}
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


@pytest.mark.parametrize("T", [8, 11, 16])
def test_mamba_prefill_and_decode_match_reference(T):
    """T = 8: one chunk; 11: not a multiple of the chunk, one token a
    chunk; 16: two chunks carrying the state."""
    tcfg, rcfg = _cfgs()
    p = _block_weights(tcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(T)
    x = rng.normal(0, 1, (2, T, tcfg.d_model)).astype(np.float32)
    xd = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)

    out, st = mamba_apply(tp, torch.from_numpy(x), tcfg, return_state=True)
    rout, rst = r_mamba.mamba_apply(rp, jnp.asarray(x), rcfg,
                                    return_state=True)
    _close(out, rout)
    _close(st.h, rst.h)
    assert np.array_equal(st.conv.numpy(), np.asarray(rst.conv))
    dout, dst = mamba_decode_step(tp, torch.from_numpy(xd), st, tcfg)
    rdout, rdst = r_mamba.mamba_decode_step(rp, jnp.asarray(xd), rst, rcfg)
    _close(dout, rdout)
    _close(dst.h, rdst.h)
    _close(dst.conv, rdst.conv)


@pytest.mark.parametrize("T", [3, 8])
def test_prefill_then_decode_matches_longer_prefill(T):
    """A prefill of T tokens and one decode step == a prefill of T + 1, the
    conv state included, within 1e-5 as ``h``. The conv state holds
    projected inputs: the decode step projects B rows and the prefill
    B (T + 1), and torch's CPU matmul may round the same row differently
    at the two shapes, by CPU (a last-bit difference on some hosts; the
    reference's XLA:CPU dot gives equal bits on the same host)."""
    tcfg, _ = _cfgs()
    tp = {k: torch.from_numpy(v) for k, v in _block_weights(tcfg, 1).items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, T + 1, tcfg.d_model)).astype(np.float32))
    _, st = mamba_apply(tp, x[:, :T], tcfg, return_state=True)
    dout, dst = mamba_decode_step(tp, x[:, T:], st, tcfg)
    full, fst = mamba_apply(tp, x, tcfg, return_state=True)
    _close(dout, full[:, T:])
    _close(dst.h, fst.h)
    _close(dst.conv, fst.conv)


def test_ssm_tree_cast_and_cache_layout():
    """``A_log`` stays float32 when the compute dtype is bfloat16; the
    cache holds ``ssm_h`` in float32 and ``ssm_conv`` in bfloat16."""
    cfg = reduced_config(ARCH)
    params = init_params(cfg, 0)
    ssm = params["layers"]["ssm"]
    assert torch.equal(ssm["A_log"][0, 0], torch.log(torch.arange(
        1, cfg.ssm_state + 1, dtype=torch.float32)))
    assert (ssm["D"] == 1).all() and (ssm["conv_b"] == 0).all()
    cast = cast_params(params, cfg)["layers"]["ssm"]
    assert cast["A_log"].dtype == torch.float32
    assert cast["wx"].dtype == cast["conv_w"].dtype == torch.bfloat16
    cache = init_cache(cfg, 3, 16)
    assert set(cache) == {"pos", "ssm_h", "ssm_conv"}
    assert cache["ssm_h"].dtype == torch.float32
    assert tuple(cache["ssm_h"].shape) == (cfg.n_layers, 3, cfg.d_inner,
                                           cfg.ssm_state)
    assert cache["ssm_conv"].dtype == torch.bfloat16
    assert tuple(cache["ssm_conv"].shape) == (cfg.n_layers, 3,
                                              cfg.d_conv - 1, cfg.d_inner)
    assert isinstance(SSMCache(cache["ssm_h"][0], cache["ssm_conv"][0]),
                      tuple)


def _scale_wo(params):
    params["layers"]["ssm"]["wo"] *= 8.0


@pytest.mark.parametrize("cache", ["packed", "float"])
def test_serve_engine_matches_reference_ssm(cache):
    eng, reqs = _check_group_parity(ARCH, _weights(ARCH, _scale_wo), cache,
                                    0)
    assert any(len(set(r.out_tokens)) > 1 for r in reqs)
    ssm = eng.params["layers"]["ssm"]
    L = eng.cfg.n_layers
    for name in ("wx", "wz", "wdt_down", "wdt_up", "wB", "wC", "wo"):
        assert isinstance(ssm[name], PreparedWeight), name
        assert ssm[name].codes.dtype == torch.uint8
        assert tuple(ssm[name].scale.shape) == (L,)
    for name in ("conv_w", "A_log", "D"):
        assert isinstance(ssm[name], torch.Tensor), name


def test_chip_smoke_checks_every_ssm_b1_shape():
    check_family_b1_shapes(reduced_config(ARCH))
