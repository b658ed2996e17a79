"""Port parity for training (``repro_torch.train`` against ``repro.train``).

* Counterparts of ``tests/test_train.py`` (schedules, clipping, AdamW on a
  quadratic, no decay of rank-1 leaves, gradient accumulation, loss
  descent on the synthetic task, int8 compression with error feedback,
  the factored second moment); its loss-descent case runs here at its
  full 60 steps. The collective half of the compression goes to the
  sharded runtime (ROADMAP A12.2).
* ``schedule_lr`` (cosine, wsd, const at every step of a short run),
  ``clip_by_global_norm`` and ``adamw_update`` (plain and factored, three
  steps) against the reference on the same numpy trees: within a relative
  1e-6 (XLA and PyTorch round ``b1 ** step``, ``cos`` and the divide by a
  constant on their own, and sum the global norm in their own order).
* Five ``make_train_step`` steps on reduced mgs-paper-eval and
  deepseek-7b at float32 compute, from the same numpy parameters and the
  same ``SyntheticLM`` batches as the reference's jitted step: loss within
  1e-6 and grad norm within 1e-5 (relative) at every step; parameters
  after step 1 within 1e-6 in at least 99.9% of each leaf's entries and
  within 2 x lr everywhere (AdamW's first step is ``g / |g|``: where a
  gradient is near zero its sign follows the last bits of the sum, as
  the reference's own test notes).
* ``grad_accum=2`` against 1; a quantized config raises; the training
  loop refuses to run without CUDA unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.train import OptConfig as ROptConfig  # noqa: E402
from repro.train import adamw_update as r_adamw  # noqa: E402
from repro.train import clip_by_global_norm as r_clip  # noqa: E402
from repro.train import init_opt_state as r_init_opt  # noqa: E402
from repro.train import init_train_state as r_init_train  # noqa: E402
from repro.train import make_train_step as r_make_train_step  # noqa: E402
from repro.train import schedule_lr as r_schedule  # noqa: E402
from repro.train.compression import _quantize_int8 as r_q8  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, train_loop  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.quant import config as qconfig  # noqa: E402
from repro_torch.train import (OptConfig, adamw_update,  # noqa: E402
                               clip_by_global_norm, global_norm,
                               init_opt_state, init_train_state,
                               make_eval_step, make_train_step, schedule_lr)
from repro_torch.train.compression import (_quantize_int8,  # noqa: E402
                                           init_error_state)
from repro_torch.tree import flatten_with_paths  # noqa: E402

F32 = dict(compute_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32).numpy()


def _flat_np(tree):
    """{path: numpy} of a port tree or a reference (jax) tree."""
    if isinstance(next(iter(flatten_with_paths(tree).values())),
                  torch.Tensor):
        return {k: v.detach().to(torch.float32).numpy()
                for k, v in flatten_with_paths(tree).items()}
    return {"/".join(str(p.key) for p in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=1e-6):
    """Every leaf within ``rtol`` of its reference leaf's largest
    magnitude."""
    got, want = _flat_np(got), _flat_np(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= rtol * max(np.abs(w).max(),
                                                      1e-30), k


# ---------------------------------------------------------------------------
# counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

def test_schedule_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    schedule="cosine", min_lr_frac=0.1)
    assert float(schedule_lr(cfg, 0)) < 0.2
    assert float(schedule_lr(cfg, torch.tensor(10))) == pytest.approx(
        1.0, abs=0.01)
    assert float(schedule_lr(cfg, 110)) == pytest.approx(0.1, abs=0.01)


def test_schedule_wsd():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    schedule="wsd", stable_frac=0.8, min_lr_frac=0.1)
    assert float(schedule_lr(cfg, 50)) == pytest.approx(1.0)
    assert float(schedule_lr(cfg, 80)) == pytest.approx(1.0)
    assert float(schedule_lr(cfg, 105)) < 0.5
    assert float(schedule_lr(cfg, 110)) == pytest.approx(0.1, abs=0.01)


def test_clip_by_global_norm():
    tree = {"a": torch.ones(10) * 3.0, "b": torch.ones(5) * 4.0}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90 + 80))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm(tree, 1e9)
    np.testing.assert_allclose(same["a"].numpy(), 3.0)


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                    total_steps=1000, schedule="const")
    for _ in range(200):
        params, state = adamw_update(params, {"w": params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_weight_decay_skips_rank1():
    params = {"w": torch.ones(4, 4), "g": torch.ones(4)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                    schedule="const")
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _ = adamw_update(params, zero_g, state, cfg)
    assert float((p2["g"] - 1.0).abs().max()) < 1e-6   # no decay
    assert float(p2["w"].max()) < 1.0                  # decayed
    assert torch.equal(params["w"], torch.ones(4, 4))  # out of place


def _random_batch(cfg, B=4, T=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)),
            "labels": torch.from_numpy(
                rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))}


def test_grad_accum_equivalence():
    """``grad_accum=2`` against 1 on reduced deepseek-7b (bfloat16
    compute, as the reference's test): loss within 1e-4 and grad norm
    within 1e-3 (relative); the raw gradient of the whole batch within
    the mean of its two halves' (rtol 5e-2, atol 1e-3: bf16 sums in
    another order)."""
    cfg = reduced_config("deepseek-7b")
    params = init_params(cfg, seed=0)
    batch = _random_batch(cfg)
    opt = OptConfig(lr=1e-2, warmup_steps=0, schedule="const")
    _, m1 = make_train_step(cfg, opt, grad_accum=1)(
        init_train_state(params), batch)
    _, m2 = make_train_step(cfg, opt, grad_accum=2)(
        init_train_state(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-3)
    from repro_torch.train.train_step import _grads_of
    g_full = _grads_of(params, cfg, batch)[2]
    halves = [_grads_of(params, cfg, {k: v[i * 2:(i + 1) * 2]
                                      for k, v in batch.items()})[2]
              for i in range(2)]
    f, a, b = (flatten_with_paths(t) for t in (g_full, *halves))
    for k in f:
        np.testing.assert_allclose(
            f[k].float().numpy(), ((a[k].float() + b[k].float()) / 2).numpy(),
            rtol=5e-2, atol=1e-3)


def test_grad_accum_matches_reference():
    """``grad_accum=2`` one step against the reference's, float32: the
    metrics (the mean cross entropy, aux, tokens, grad norm) and the
    updated parameters."""
    cfg = dataclasses.replace(reduced_config("deepseek-7b"), **F32)
    rcfg = dataclasses.replace(r_reduced("deepseek-7b"), **F32)
    np_params = _np_tree(init_params(cfg, seed=0))
    batch = _random_batch(cfg, seed=1)
    opt = dict(lr=1e-2, warmup_steps=0, schedule="const")
    ts, tm = make_train_step(cfg, OptConfig(**opt), grad_accum=2)(
        init_train_state(params_from_numpy(np_params)), batch)
    rs, rm = jax.jit(r_make_train_step(rcfg, ROptConfig(**opt),
                                       grad_accum=2))(
        r_init_train(jax.tree.map(jnp.asarray, np_params)),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    for k in ("loss", "aux_loss", "tokens", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                             abs=1e-7), k
    _step1_params_close(ts["params"], rs["params"], np_params, lr=1e-2)


def test_loss_descends_on_synthetic_task():
    cfg = reduced_config("deepseek-7b")
    state = init_train_state(init_params(cfg, seed=0))
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                    schedule="cosine")
    step = make_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8, seed=0))
    losses = []
    for i in range(60):
        batch = {k: torch.from_numpy(v) for k, v in
                 data.make_batch(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.3, (first, last)


def test_int8_compression_error_feedback():
    """Quantize-reduce with error feedback: the bias vanishes over steps."""
    rng = np.random.default_rng(0)
    g_true = rng.normal(0, 1, (64,)).astype(np.float32)
    err = np.zeros_like(g_true)
    acc = np.zeros_like(g_true)
    for _ in range(50):
        x = g_true + err
        q, scale = _quantize_int8(torch.from_numpy(x))
        deq = q.numpy().astype(np.float32) * float(scale)
        err = x - deq
        acc += deq
    np.testing.assert_allclose(acc / 50, g_true, atol=2e-2)


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(1).normal(0, 3, (4, 33)).astype(np.float32)
    q, scale = _quantize_int8(torch.from_numpy(x))
    rq, rscale = r_q8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == pytest.approx(float(rscale), rel=1e-7)


def test_init_error_state_shapes():
    e = init_error_state({"a": torch.ones(3, 4), "b": torch.ones(5)})
    assert e["a"].shape == (3, 4) and e["a"].dtype == torch.float32
    assert e["b"].shape == (5,)


def test_factored_adamw_converges_and_saves_memory():
    params = {"w": torch.ones(8, 16) * 4.0}
    state = init_opt_state(params, factored=True)
    assert state["nu"]["w"]["row"].shape == (8,)
    assert state["nu"]["w"]["col"].shape == (16,)
    assert state["mu"]["w"].dtype == torch.bfloat16
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                    schedule="const", factored=True)
    for _ in range(300):
        params, state = adamw_update(params, {"w": params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


# ---------------------------------------------------------------------------
# against the reference on the same numpy trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule,
              stable_frac=0.6, min_lr_frac=0.05)
    steps = np.arange(0, 56, dtype=np.int32)
    got = schedule_lr(OptConfig(**kw), torch.from_numpy(steps)).numpy()
    want = np.asarray(r_schedule(ROptConfig(**kw), jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(0, scale, (6, 10))).astype(np.float32),
            "blk": {"m": (rng.normal(0, scale, (2, 3, 5))).astype(np.float32),
                    "b": (rng.normal(0, scale, (7,))).astype(np.float32)}}


def test_clip_by_global_norm_matches_reference():
    for max_norm in (0.5, 1e3):
        g = _tree_np(2, 0.3)
        got, norm = clip_by_global_norm(params_from_numpy(g), max_norm)
        want, rnorm = r_clip(jax.tree.map(jnp.asarray, g), max_norm)
        assert float(norm) == pytest.approx(float(rnorm), rel=1e-6)
        _close(got, want)


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_matches_reference(factored):
    """Three steps of AdamW with decay, plain and factored (bfloat16
    first moments: their rounding is the same op in both)."""
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10,
              factored=factored)
    p = _tree_np(0)
    tp, ts = params_from_numpy(p), init_opt_state(params_from_numpy(p),
                                                  factored)
    rp = jax.tree.map(jnp.asarray, p)
    rs = r_init_opt(rp, factored)
    for i in range(3):
        g = _tree_np(10 + i, 0.1)
        tp, ts = adamw_update(tp, params_from_numpy(g), ts, OptConfig(**kw))
        rp, rs = r_adamw(rp, jax.tree.map(jnp.asarray, g), rs,
                         ROptConfig(**kw))
    assert int(ts["step"]) == int(rs["step"]) == 3
    _close(tp, rp)
    _close(ts["nu"], rs["nu"])
    _close(ts["mu"], rs["mu"])


def _step1_params_close(got, want, init, lr):
    """Parameters after one step: within 1e-6 in >= 99.9% of each leaf's
    entries, within 2 x lr everywhere (docstring)."""
    got, want, init = _flat_np(got), _flat_np(want), _flat_np(init)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert (d <= 1e-6).mean() >= 0.999, (k, (d > 1e-6).sum())
        assert d.max() <= 2 * lr, k
        assert np.abs(w - init[k]).max() > 0, k   # the step moved it


@pytest.mark.parametrize("arch", ["mgs-paper-eval", "deepseek-7b"])
def test_train_steps_match_reference(arch):
    cfg = dataclasses.replace(reduced_config(arch), **F32)
    rcfg = dataclasses.replace(r_reduced(arch), **F32)
    np_params = _np_tree(init_params(cfg, seed=0))
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    t_step = make_train_step(cfg, OptConfig(**opt))
    r_step = jax.jit(r_make_train_step(rcfg, ROptConfig(**opt)))
    ts = init_train_state(params_from_numpy(np_params))
    rs = r_init_train(jax.tree.map(jnp.asarray, np_params))
    data = RSyntheticLM(RDataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4, seed=0))
    for i in range(5):
        hb = data.make_batch(i)
        ts, tm = t_step(ts, {k: torch.from_numpy(v) for k, v in hb.items()})
        rs, rm = r_step(rs, {k: jnp.asarray(v) for k, v in hb.items()})
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-6), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5), i
        assert float(tm["tokens"]) == float(rm["tokens"])
        if i == 0:
            _step1_params_close(ts["params"], rs["params"], np_params,
                                opt["lr"])
    assert int(ts["opt"]["step"]) == 5


def test_eval_step_is_loss_fn_without_gradients():
    cfg = reduced_config("mgs-paper-eval")
    params = init_params(cfg, seed=0)
    batch = _random_batch(cfg, B=2, T=8)
    m = make_eval_step(cfg)(params, batch)
    _, want = loss_fn(params, cfg, batch)
    assert not m["loss"].requires_grad
    assert torch.equal(m["loss"], want["loss"].detach())


def test_quantized_config_refuses_to_train():
    cfg = dataclasses.replace(reduced_config("mgs-paper-eval"),
                              quant=qconfig.FP8_MGS)
    with pytest.raises(ValueError, match="mgs-paper-eval-reduced"):
        make_train_step(cfg, OptConfig())


def test_train_loop_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    cfg = reduced_config("mgs-paper-eval")
    loop = TrainLoopConfig(steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(cfg, loop)
    out = train_loop(cfg, loop, device="cpu")
    assert np.isfinite(out["final"]["loss"])


def test_training_modules_leave_jax_and_repro_unloaded():
    """The training path imports neither JAX nor the reference package
    (``tests/test_torch_isolation.py``'s check, for the modules added with
    it)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.train, "
            "repro_torch.runtime, repro_torch.data, repro_torch.tree\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
