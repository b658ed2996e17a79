"""Port parity for the slice as a whole: ``ServeEngine.run`` of both
packages on the same weights and requests.

Reduced deepseek-7b at float32 compute (weights drawn once, in numpy),
under ``FP8_MGS_SERVE_KV`` (packed cache, decode through the flash
kernel) and ``FP8_MGS_SERVE`` (float cache), each with ``attn_chunk`` 0
(dense prefill scores) and 16 (the chunked online-softmax prefill); and
the other dense archs the port serves (gemma3-27b, granite-20b,
minicpm-2b, mgs-paper-eval) under both presets at ``attn_chunk`` 0. The reference runs its emulation tier
(``use_kernel=False``, which its own tests pin bitwise to the kernels) on
a (1, 1) mesh; the port runs the presets unchanged with ``device="cpu"``,
so every kernel call goes through its twin.

Greedy tokens must be equal; logits agree within a tolerance, because
``exp`` (softmax, silu), ``rsqrt``, ``pow`` and ``cos``/``sin`` (RoPE)
round differently in the last ulp between XLA:CPU and PyTorch, and
XLA:CPU contracts multiply-adds. Most runs then agree to ~3e-7 of the
logit scale; but a one-ulp move of an activation can flip one FP8 code
of a re-quantized operand (seen once here, in the chunked prefill's
probabilities: 2.4% of the scale on one group), so the bound is 5% of the
logit scale at most and 1% on average.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.serve import Request as RRequest  # noqa: E402
from repro.launch.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.models import init_params as r_init_params  # noqa: E402
from repro.quant import config as rq  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    Request, ServeEngine, make_engine)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.quant import PREP_STATS  # noqa: E402
from repro_torch.quant import config as tq  # noqa: E402

PRESETS = {"packed": "FP8_MGS_SERVE_KV", "float": "FP8_MGS_SERVE"}
OTHER_DENSE = ["gemma3-27b", "granite-20b", "minicpm-2b", "mgs-paper-eval"]


def _weights(arch, edit=None):
    """One random tree in the shared layout, as numpy: the reference gets
    it as jax arrays in its own parameter dtypes, the port through
    ``params_from_numpy`` (float32 holding the same values: a bfloat16
    tree is drawn in bfloat16). ``edit`` may change the port's tree in
    place first."""
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32")
    params = init_params(cfg, seed=0)
    if edit is not None:
        edit(params)
    np_params = _to_numpy(params)
    r_shapes = jax.eval_shape(
        lambda k: r_init_params(r_reduced(arch), k)[0],
        jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, r_shapes) == jax.tree.map(
        lambda a: a.shape, np_params)
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), np_params,
                        r_shapes), np_params


@pytest.fixture(scope="module")
def weights():
    return _weights("deepseek-7b")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


def _prompts():
    # both groups of 2 pad to one prompt bucket (8)
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).astype(np.int32) for n in (6, 8, 8)]


@pytest.mark.parametrize("attn_chunk", [0, 16])
@pytest.mark.parametrize("cache", ["packed", "float"])
def test_serve_engine_matches_reference(weights, cache, attn_chunk):
    _check_group_parity("deepseek-7b", weights, cache, attn_chunk)


@pytest.mark.parametrize("cache", ["packed", "float"])
@pytest.mark.parametrize("arch", OTHER_DENSE)
def test_serve_engine_matches_reference_other_dense_archs(arch, cache):
    """The other dense archs of ``_require_ported``: gemma3-27b (local /
    global window), granite-20b (MQA, gelu), minicpm-2b and the paper's
    eval proxy, at the same bar."""
    _check_group_parity(arch, _weights(arch), cache, 0)


def _check_group_parity(arch, weights, cache, attn_chunk):
    params, np_params = weights
    rcfg = dataclasses.replace(
        r_reduced(arch), compute_dtype="float32",
        attn_chunk=attn_chunk,
        quant=getattr(rq, PRESETS[cache]).replace(use_kernel=False))
    tcfg = dataclasses.replace(
        reduced_config(arch), compute_dtype="float32",
        attn_chunk=attn_chunk, quant=getattr(tq, PRESETS[cache]))
    assert tcfg.quant.use_kernel and tcfg.quant.fused
    renv = RServeEngine(rcfg, make_mesh((1, 1), ("data", "model")), batch=2,
                        max_len=16, params=params)
    rreqs = [RRequest(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(_prompts())]
    rstats = renv.run(rreqs, record_logits=True)

    eng = ServeEngine(tcfg, batch=2, max_len=16,
                      params=params_from_numpy(np_params), device="cpu")
    before = dict(PREP_STATS)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(_prompts())]
    tstats = eng.run(treqs, record_logits=True)
    assert PREP_STATS == before                 # nothing re-prepared
    if cache == "packed" and "attn" in eng.params["layers"]:
        assert eng.params["layers"]["attn"]["wq"].codes.dtype == torch.uint8
    for rr, tr in zip(rreqs, treqs):
        assert rr.out_tokens == tr.out_tokens, (rr.rid, rr.out_tokens,
                                                tr.out_tokens)
        rl = np.stack(rstats["logits"][rr.rid])
        tl = np.stack(tstats["logits"][tr.rid])
        scale = np.abs(rl).max()
        err = np.abs(tl - rl)
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
            arch, cache, attn_chunk, err.max() / scale, err.mean() / scale)
    assert tstats["decode_tokens"] == rstats["decode_tokens"] == 12
    return eng, treqs


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine is valid")
    cfg = reduced_config("deepseek-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, batch=1, max_len=8)


def test_other_families_and_later_slices_raise(capsys):
    """The hybrid, encoder-decoder and VLM families are still unported
    (A10); MoE and SSM serve on the group engine only: the continuous
    engine and the CLI's ``--continuous`` refuse them with the reference's
    reason (``repro.models.transformer._require_paged_arch``)."""
    for arch in ("jamba-1.5-large-398b", "whisper-tiny", "internvl2-2b"):
        with pytest.raises(NotImplementedError, match="A10"):
            ServeEngine(reduced_config(arch), batch=1, max_len=8,
                        device="cpu")
    jamba = dataclasses.replace(reduced_config("jamba-1.5-large-398b"),
                                quant=tq.FP8_MGS_SERVE_PAGED)
    with pytest.raises(NotImplementedError, match="A10"):
        make_engine(jamba, batch=1, max_len=8, device="cpu", continuous=True)
    reason = "paged decode supports plain dense attention-only stacks"
    for arch in ("granite-moe-1b-a400m", "falcon-mamba-7b"):
        cfg = dataclasses.replace(reduced_config(arch),
                                  quant=tq.FP8_MGS_SERVE_PAGED)
        with pytest.raises(NotImplementedError, match=reason):
            make_engine(cfg, batch=1, max_len=8, device="cpu",
                        continuous=True)
        with pytest.raises(SystemExit):
            serve_main(["--arch", arch, "--reduced", "--continuous",
                        "--quant", "fp8-mgs-serve-paged", "--device", "cpu"])
        assert reason in capsys.readouterr().err


def test_warmup_and_bucketed_run_on_cpu():
    cfg = dataclasses.replace(reduced_config("deepseek-7b"), n_layers=2,
                              quant=tq.FP8_MGS_SERVE_KV)
    eng = ServeEngine(cfg, batch=2, max_len=12, seed=3, device="cpu")
    assert eng.warmup([8], max_new=1) == [8]
    reqs = [Request(rid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(2)]
    stats = eng.run(reqs)
    assert stats["prefill_tokens"] == 16 and stats["decode_tokens"] == 6
    assert all(len(r.out_tokens) == 3 and r.done for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
