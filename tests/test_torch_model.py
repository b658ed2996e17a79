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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def family_cfgs(arch, preset="FP8_MGS_SERVE_KV", **kw):
    """(port, reference) reduced configs of ``arch`` at float32 compute
    under ``preset``: the port's unchanged, the reference's on its
    emulation tier (``use_kernel=False``). ``kw`` changes both."""
    rquant = getattr(rq, preset)
    if rquant.is_fp8:
        rquant = rquant.replace(use_kernel=False)
    return (dataclasses.replace(reduced_config(arch), compute_dtype="float32",
                                quant=getattr(tq, preset), **kw),
            dataclasses.replace(r_reduced(arch), compute_dtype="float32",
                                quant=rquant, **kw))


def family_weights(tcfg, rcfg, edit=None):
    """``_weights`` for any pair of configs: one tree drawn by the port (in
    numpy), the reference's copy as jax arrays in its parameter dtypes."""
    params = init_params(tcfg, seed=0)
    if edit is not None:
        edit(params)
    np_params = _to_numpy(params)
    r_shapes = jax.eval_shape(lambda k: r_init_params(rcfg, k)[0],
                              jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, r_shapes) == jax.tree.map(
        lambda a: a.shape, np_params)
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), np_params,
                        r_shapes), np_params


def side_inputs(cfg, batch: int, seed: int = 0):
    """Seeded vision / audio embeddings as numpy (``tests/test_models.py``
    draws them so)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vision_prefix:
        out["vision_embeds"] = rng.normal(
            0, 0.1, (batch, cfg.vision_prefix, cfg.d_model)).astype(
                np.float32)
    if cfg.encoder_layers:
        out["audio_embeds"] = rng.normal(
            0, 0.1, (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def port_serving_params(np_params, tcfg):
    """The port's tree as its ``ServeEngine`` holds it."""
    from repro_torch.models import cast_params
    from repro_torch.quant import prepare_logits_head, prepare_params
    tp = prepare_params(params_from_numpy(np_params), tcfg.quant,
                        hybrid=tcfg.is_hybrid)
    tp = prepare_logits_head(tp, tcfg.quant, tied=tcfg.tie_embeddings)
    return cast_params(tp, tcfg)


def check_model_parity(arch, preset="FP8_MGS_SERVE_KV", *, edit=None,
                       steps=4, T=8, B=2, seed=0, **kw):
    """The reference's jitted ``prefill`` and ``steps`` ``decode_step``s
    against the port's on the same weights (prepared as each engine
    prepares them), tokens and seeded side inputs, feeding each its own
    greedy tokens: the tokens must be equal and the logits within the
    engine bar. Returns the port's tokens (B, 1 + steps)."""
    from repro.models import decode_step as r_decode
    from repro.models import init_cache as r_init_cache
    from repro.models import param_dims as r_param_dims
    from repro.models import prefill as r_prefill
    from repro.quant import prepared as rprep
    from repro_torch.models import decode_step, init_cache, prefill
    tcfg, rcfg = family_cfgs(arch, preset, **kw)
    rparams, np_params = family_weights(tcfg, rcfg, edit)
    rp = rprep.prepare_params(rparams, rcfg.quant, dims=r_param_dims(rcfg))
    rp = rprep.prepare_logits_head(rp, rcfg.quant, tied=rcfg.tie_embeddings)
    tp = port_serving_params(np_params, tcfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, tcfg.vocab, (B, T))
    side = side_inputs(tcfg, B, seed)
    max_len = tcfg.vision_prefix + T + steps + 1
    rpf = jax.jit(lambda p, b, c: r_prefill(p, rcfg, b, c))
    rdc = jax.jit(lambda p, t, c: r_decode(p, rcfg, t, c))
    rl, rc = rpf(rp, dict({k: jnp.asarray(v) for k, v in side.items()},
                          tokens=jnp.asarray(toks, jnp.int32)),
                 r_init_cache(rcfg, B, max_len)[0])
    tl, tc = prefill(tp, tcfg, dict(
        {k: torch.from_numpy(v) for k, v in side.items()},
        tokens=torch.from_numpy(toks)), init_cache(tcfg, B, max_len))
    rows_r, rows_t, out = [], [], []
    for step in range(steps + 1):
        rl, tl = np.asarray(rl), tl.numpy()
        rows_r.append(rl)
        rows_t.append(tl)
        rt, tt = rl.argmax(-1), tl.argmax(-1)
        assert np.array_equal(rt, tt), (arch, step, rt, tt)
        out.append(tt)
        if step == steps:
            break
        rl, rc = rdc(rp, jnp.asarray(rt[:, None], jnp.int32), rc)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(tt[:, None]), tc)
    rl, tl = np.stack(rows_r), np.stack(rows_t)
    scale = np.abs(rl).max()
    err = np.abs(tl - rl)
    assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
        arch, preset, err.max() / scale, err.mean() / scale)
    return np.stack(out, 1)


def prepared_leaves(tree, path=()):
    """``{path: prepared leaf}`` of a prepared tree (either package's)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(prepared_leaves(v, path + (k,)))
    elif hasattr(tree, "codes") and hasattr(tree, "scale"):
        out[path] = tree
    return out


def check_prefill_then_decode(arch, T=6, **kw):
    """Inside the port, unquantized with the float cache: a prefill of T
    tokens and one decode step give the logits (within 1e-5 of their
    scale) of a prefill of the T + 1 tokens, with seeded side inputs. An
    SSM conv state is kept in float32 here: the serving cache holds it in
    bfloat16, as the reference's does, which moves the step's logits by
    ~1e-3 of their scale."""
    from repro_torch.models import decode_step, init_cache, prefill
    tcfg, _ = family_cfgs(arch, "NONE", **kw)
    params = init_params(tcfg, seed=2)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, tcfg.vocab, (2, T + 1)))
    side = {k: torch.from_numpy(v) for k, v in side_inputs(tcfg, 2).items()}
    max_len = tcfg.vision_prefix + T + 2
    cache = init_cache(tcfg, 2, max_len)
    if "ssm_conv" in cache:
        cache["ssm_conv"] = cache["ssm_conv"].float()
    _, cache = prefill(params, tcfg, dict(side, tokens=toks[:, :T]), cache)
    step, _ = decode_step(params, tcfg, toks[:, T:], cache)
    full, _ = prefill(params, tcfg, dict(side, tokens=toks),
                      init_cache(tcfg, 2, max_len))
    err = (step - full).abs().max().item()
    assert err <= 1e-5 * full.abs().max().item(), err


def engine_matches_model_loop(arch, preset="FP8_MGS_SERVE_KV", **kw):
    """Inside the port: the group engine's logits are bitwise those of the
    model-level prefill + decode loop on the engine's weights, with the
    engine's stub side inputs (zero embeddings) and left-padded prompts."""
    from repro_torch.models import decode_step, init_cache, prefill
    tcfg, _ = family_cfgs(arch, preset, **kw)
    max_len = tcfg.vision_prefix + 8 + 4
    eng = ServeEngine(tcfg, batch=2, max_len=max_len, seed=1, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts()[:2])]
    logged = eng.run(reqs, record_logits=True)["logits"]
    toks = np.zeros((2, 8), np.int64)
    for j, r in enumerate(reqs):
        toks[j, 8 - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks)}
    for name, v in side_inputs(tcfg, 2).items():
        batch[name] = torch.zeros(v.shape, dtype=torch.bfloat16)
    logits, cache = prefill(eng.params, tcfg, batch,
                            init_cache(tcfg, 2, max_len))
    for step in range(4):
        for j, r in enumerate(reqs):
            assert np.array_equal(logits[j].numpy(), logged[r.rid][step])
        if step < 3:
            logits, cache = decode_step(eng.params, tcfg,
                                        logits.argmax(-1)[:, None], cache)
    return eng, reqs


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
    """Every family serves on the group engine; only plain dense stacks take
    the continuous engine: ``make_engine(continuous=True)`` and the CLI's
    ``--continuous`` refuse MoE, SSM, hybrid, encoder-decoder and VLM stacks
    with the reference's reason
    (``repro.models.transformer._require_paged_arch``), and the group
    engine builds each of them on the CPU."""
    reason = "paged decode supports plain dense attention-only stacks"
    for arch in ("granite-moe-1b-a400m", "falcon-mamba-7b",
                 "jamba-1.5-large-398b", "whisper-tiny", "internvl2-2b"):
        cfg = dataclasses.replace(reduced_config(arch),
                                  quant=tq.FP8_MGS_SERVE_PAGED)
        with pytest.raises(NotImplementedError, match=reason):
            make_engine(cfg, batch=1, max_len=8, device="cpu",
                        continuous=True)
        with pytest.raises(SystemExit):
            serve_main(["--arch", arch, "--reduced", "--continuous",
                        "--quant", "fp8-mgs-serve-paged", "--device", "cpu"])
        assert reason in capsys.readouterr().err
        eng = make_engine(cfg, batch=1, max_len=cfg.vision_prefix + 8,
                          device="cpu")
        assert type(eng) is ServeEngine and eng.cfg.family == cfg.family


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
