"""Port parity for the teacher-forced forward and its loss
(``repro_torch.models.forward`` / ``loss_fn`` against ``repro.models``).

* ``loss_fn`` and its gradient for every family (dense, sliding-window
  dense, MoE, pure SSM, hybrid, encoder-decoder, VLM), reduced, float32
  compute and parameters, a random ``loss_mask``: the loss and the MoE aux
  loss within 1e-6 (relative) of ``jax.value_and_grad``'s, every gradient
  leaf within 1e-5 of the reference leaf's largest magnitude (measured:
  at most 2.1e-6). Dense also at its own bfloat16 compute: loss within
  1e-3 (relative), each gradient leaf within 5% (max) and 1% (mean) of
  its scale, logits within the whole-model bar (measured: 2e-4; 2.0% /
  0.35%; 0.9% / 0.1%).
* ``cfg.remat == "layer"`` (a checkpoint a layer, a period) gives the
  same bits as no remat, dense and hybrid.
* ``_streamed_ce`` at V = 40000 (3 chunks of 16384, a padded tail) and
  its gradients against the reference's within 1e-5; ``loss_fn`` past
  65536 tied vocabulary entries takes it, as the reference's does.
* The port's own ``prefill`` (float32 cache) gives ``forward``'s
  last-position logits, every family.
* Table 1's six ``QuantConfig``\\ s and Fig. 9's (int8 ``clip`` / ``wrap``
  / ``mgs_exact`` at narrow 12 / 14 / 16 / 20) on reduced mgs-paper-eval
  (4 x 32 tokens), against the reference's ``forward``, float32 compute:
  greedy tokens equal at every position and logits within 5% (max) and 1%
  (mean) of the scale (measured: at most 2.4e-7 of the scale). Three
  configurations are held per layer instead (``PER_LAYER``): each layer
  of both packages on the reference's residual stream, each layer's own
  contribution and the head's logits within the same bar, and the port's
  ``forward`` bitwise its own layer chain. ``fp8_wide`` and ``mgs_exact``:
  the reference's scanned ``forward`` is not its own eager layer chain
  (3.85% of the scale, 3 greedy flips at the port's CPU draw of the
  weights on AVX2 / AVX512 hosts), while the port's chain is that eager
  chain bit for bit. ``wrap`` at 12 bits breaks the whole-model bar on this
  traffic: a last-ulp ``rsqrt`` / ``exp`` difference flips one int8 code,
  the flipped product moves a sum across the wrap, and the rest follows
  through the layers (88% of the tokens agree). A planted fault (the
  port's layers one narrow bit wider than the reference's) fails the
  per-layer bar. Under ``int8_wrap_12`` every quantized contraction of
  every layer and the head, given the reference's own operands, is the
  reference's bit for bit (the epilogue's ``silu`` aside, one ``exp``
  ulp): the per-layer miss is upstream of the sums. The port runs ``dmac_mgs`` on B5's twin and
  ``mgs_exact`` on B1's (``use_kernel=True``), the reference its default
  emulation.
* ``launch.dryrun.eval_b1_shapes`` / ``eval_launches`` are the shapes and
  the count of B1's and B5's calls in an eval forward; the lean loop
  bodies of the swamp, clip and wrap accumulations keep their bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.models import forward as r_forward  # noqa: E402
from repro.models import loss_fn as r_loss_fn  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.models.common import rms_norm as r_rms_norm  # noqa: E402
from repro.quant import QuantConfig as RQuantConfig  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (forward, init_cache, init_params,  # noqa: E402
                                loss_fn, prefill)
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.quant import QuantConfig  # noqa: E402

FAMILIES = ["mgs-paper-eval", "gemma3-27b", "granite-moe-1b-a400m",
            "falcon-mamba-7b", "jamba-1.5-large-398b", "whisper-tiny",
            "internvl2-2b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread, so that test workers running
    side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """(port, reference) reduced configs with the same overrides."""
    return (dataclasses.replace(reduced_config(arch), **kw),
            dataclasses.replace(r_reduced(arch), **kw))


F32 = dict(compute_dtype="float32", param_dtype="float32")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32).numpy()


def _weights(cfg, seed=0):
    """One random tree (the port's init, seed ``seed``) as numpy float32."""
    return _np_tree(init_params(cfg, seed=seed))


def _batch(cfg, B=2, T=8, seed=0, mask=True):
    """Tokens, next-token labels, a 0 / 1 loss mask and the family's side
    inputs, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.random((B, T)) < 0.8).astype(np.float32)
    if cfg.vision_prefix:
        batch["vision_embeds"] = rng.normal(
            0, 1, (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["audio_embeds"] = rng.normal(
            0, 1, (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_value_and_grad(cfg, np_params, batch):
    """(total, metrics, {leaf path: grad}) of the port's ``loss_fn``."""
    params = params_from_numpy(np_params)
    leaves = {}

    def req(tree, path=""):
        if isinstance(tree, dict):
            return {k: req(v, f"{path}/{k}") for k, v in tree.items()}
        leaves[path] = tree.requires_grad_(True)
        return leaves[path]

    total, metrics = loss_fn(req(params), cfg, _t(batch))
    total.backward()
    return total.detach(), metrics, {k: v.grad for k, v in leaves.items()}


def _ref_value_and_grad(cfg, np_params, batch):
    (total, metrics), grads = jax.value_and_grad(r_loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params), cfg, _j(batch))
    flat = {"/" + "/".join(str(p.key) for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(total), metrics, flat


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    tcfg, rcfg = _cfgs(arch, **F32)
    np_params = _weights(tcfg)
    batch = _batch(tcfg)
    t_total, t_m, t_g = _port_value_and_grad(tcfg, np_params, batch)
    r_total, r_m, r_g = _ref_value_and_grad(rcfg, np_params, batch)
    assert float(t_total) == pytest.approx(r_total, rel=1e-6)
    for k in ("loss", "aux_loss", "tokens"):
        got = float(t_m[k].detach())
        assert got == pytest.approx(float(r_m[k]), rel=1e-6, abs=1e-7), k
    if tcfg.is_moe:
        assert float(t_m["aux_loss"].detach()) > 0.0
    assert sorted(t_g) == sorted(r_g)
    for k, want in r_g.items():
        err = np.abs(t_g[k].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err)


def test_dense_bf16_compute_matches_reference():
    tcfg, rcfg = _cfgs("mgs-paper-eval")
    assert tcfg.compute_dtype == "bfloat16"
    np_params = _weights(tcfg)
    batch = _batch(tcfg, T=16, mask=False)
    t_total, _, t_g = _port_value_and_grad(tcfg, np_params, batch)
    r_total, _, r_g = _ref_value_and_grad(rcfg, np_params, batch)
    assert float(t_total) == pytest.approx(r_total, rel=1e-3)
    for k, want in r_g.items():
        err = np.abs(t_g[k].numpy() - want)
        scale = np.abs(want).max()
        assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, k
    with torch.no_grad():
        tl, _ = forward(params_from_numpy(np_params), tcfg, _t(batch))
    rl, _ = r_forward(jax.tree.map(jnp.asarray, np_params), rcfg, _j(batch))
    _whole_model_bar(tl.numpy(), np.asarray(rl))


@pytest.mark.parametrize("arch", ["mgs-paper-eval", "jamba-1.5-large-398b"])
def test_remat_gives_the_same_bits(arch):
    cfg = dataclasses.replace(reduced_config(arch), **F32)
    np_params = _weights(cfg)
    batch = _batch(cfg)
    a = _port_value_and_grad(dataclasses.replace(cfg, remat="none"),
                             np_params, batch)
    b = _port_value_and_grad(dataclasses.replace(cfg, remat="layer"),
                             np_params, batch)
    assert torch.equal(a[0], b[0])
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_streamed_ce_matches_reference():
    """V = 40000: chunks of 16384, 16384 and 7232 valid rows (the tail
    padded); the nll and its gradients in x and the table."""
    rng = np.random.default_rng(3)
    B, T, D, V = 2, 5, 16, 40000
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    table = rng.normal(0, 0.5, (V, D)).astype(np.float32)
    labels = np.array([[0, 16383, 16384, 32767, 32768],
                       [39999, 5, 20000, 35000, 1]], np.int32)
    w = rng.normal(0, 1, (B, T)).astype(np.float32)

    def r_obj(x, table):
        nll = rt._streamed_ce(x, table, jnp.asarray(labels))
        return jnp.sum(nll * w), nll
    (_, r_nll), (r_gx, r_gt) = jax.value_and_grad(
        r_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_(True)
    ttab = torch.from_numpy(table).requires_grad_(True)
    t_nll = tt._streamed_ce(tx, ttab, torch.from_numpy(labels))
    (t_nll * torch.from_numpy(w)).sum().backward()
    for got, want in ((t_nll.detach(), r_nll), (tx.grad, r_gx),
                      (ttab.grad, r_gt)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the plain cross entropy of the same logits
    logits = torch.einsum("btd,vd->btv", tx.detach(), ttab.detach())
    plain = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    assert torch.allclose(t_nll.detach(), plain, rtol=1e-5, atol=1e-5)


def test_loss_fn_streams_past_65536_tied_entries():
    """A tied vocabulary of 70000 takes ``_streamed_ce`` in both packages:
    the loss and the embedding's gradient agree within 1e-5."""
    tcfg, rcfg = _cfgs("mgs-paper-eval", vocab=70000, n_layers=1, **F32)
    assert tcfg.vocab > tt._CE_CHUNK_THRESHOLD and tcfg.tie_embeddings
    np_params = _weights(tcfg)
    batch = _batch(tcfg, T=4)
    t_total, _, t_g = _port_value_and_grad(tcfg, np_params, batch)
    r_total, _, r_g = _ref_value_and_grad(rcfg, np_params, batch)
    assert float(t_total) == pytest.approx(r_total, rel=1e-5)
    for k in ("/embed", "/layers/ffn/wd"):
        assert np.abs(t_g[k].numpy() - r_g[k]).max() <= \
            1e-5 * np.abs(r_g[k]).max(), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_equal_forward_last_position(arch):
    cfg = dataclasses.replace(reduced_config(arch), kv_cache_dtype="float32",
                              **F32)
    params = params_from_numpy(_weights(cfg))
    batch = _t(_batch(cfg, mask=False))
    with torch.no_grad():
        full, _ = forward(params, cfg, batch)
        B, T = batch["tokens"].shape
        cache = init_cache(cfg, B, cfg.vision_prefix + T + 1)
        last, _ = prefill(params, cfg, batch, cache)
    want = full[:, -1]
    assert torch.equal(last.argmax(-1), want.argmax(-1))
    assert (last - want).abs().max() <= 1e-5 * want.abs().max()


# ---------------------------------------------------------------------------
# Table 1 and Fig. 9's configurations
# ---------------------------------------------------------------------------

#: ``benchmarks/table1_accuracy.py``'s modes (the port runs B5 / B1's twins)
TABLE1 = {
    "baseline_fp32": {},
    "int8": dict(dtype="int8", accum="wide"),
    "fp8_wide": dict(dtype="fp8_e4m3", accum="wide"),
    "dmac_mgs": dict(dtype="fp8_e4m3", accum="mgs_dmac"),
    "mgs_exact": dict(dtype="fp8_e4m3", accum="mgs_exact"),
    "fp8_swamp_narrow": dict(dtype="fp8_e4m3", accum="swamp",
                             narrow_bits=5),
}
#: ``benchmarks/fig9_pareto.py``'s: int8 clip / wrap / MGS by narrow width
FIG9 = {f"int8_{a}_{nb}": dict(dtype="int8", accum=a, narrow_bits=nb)
        for nb in (12, 14, 16, 20) for a in ("clip", "wrap", "mgs_exact")}
PORT_KERNELS = {"dmac_mgs": dict(use_kernel=True),
                "mgs_exact": dict(use_kernel=True, fused=True)}
#: the configurations held per layer (docstring)
PER_LAYER = ("int8_wrap_12", "fp8_wide", "mgs_exact")
MODES = {**TABLE1, **FIG9}


def _whole_model_bar(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
        err.max() / scale, err.mean() / scale)


@pytest.fixture(scope="module")
def eval_model():
    tcfg, rcfg = _cfgs("mgs-paper-eval", compute_dtype="float32")
    np_params = _weights(tcfg)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (4, 32)).astype(np.int32)
    return tcfg, rcfg, np_params, tokens


def _quant(name, cfg, port: bool):
    kw = dict(MODES[name], **(PORT_KERNELS.get(name, {}) if port else {}))
    q = QuantConfig(**kw) if port else RQuantConfig(**kw)
    return dataclasses.replace(cfg, quant=q)


@pytest.mark.parametrize("name", [n for n in MODES if n not in PER_LAYER])
def test_table1_fig9_forward_matches_reference(eval_model, name):
    tcfg, rcfg, np_params, tokens = eval_model
    with torch.no_grad():
        tl, _ = forward(params_from_numpy(np_params),
                        _quant(name, tcfg, True),
                        {"tokens": torch.from_numpy(tokens)})
    rl, _ = r_forward(jax.tree.map(jnp.asarray, np_params),
                      _quant(name, rcfg, False),
                      {"tokens": jnp.asarray(tokens)})
    _whole_model_bar(tl.numpy(), np.asarray(rl))


def _per_layer_bars(eval_model, name, port_quant=None):
    """Each layer of both packages on the reference's residual stream:
    the ``(max, mean)`` error of every layer's own contribution, then of
    the head's logits, over the reference's scale."""
    tcfg, rcfg, np_params, tokens = eval_model
    tcfg = _quant(name, tcfg, True)
    if port_quant is not None:
        tcfg = dataclasses.replace(tcfg, quant=port_quant)
    rcfg = _quant(name, rcfg, False)
    rp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params)
    B, T = tokens.shape
    r_pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    t_pos = torch.arange(T)[None].expand(B, T)
    x = np.array(rt._embed_tokens(rp, rcfg, jnp.asarray(tokens)))
    bars = []
    for i in range(rcfg.n_layers):
        pl = jax.tree.map(lambda a: a[i], rp["layers"])
        y, _, _ = rt._dense_body(pl, jnp.asarray(x), r_pos, rcfg, True, None,
                                 None, None, None)
        with torch.no_grad():
            yt = tt._dense_body(tt.layer_params(tp["layers"], i),
                                torch.from_numpy(x), t_pos, tcfg, True,
                                None, 0)
        dr = np.asarray(y) - x
        err = np.abs((yt.numpy() - x) - dr)
        scale = np.abs(dr).max()
        bars.append((err.max() / scale, err.mean() / scale))
        x = np.array(y)
    rl = np.asarray(rt._logits(rp, rcfg, r_rms_norm(
        jnp.asarray(x), rp["final_norm"], rcfg.norm_eps)))
    with torch.no_grad():
        tl = tt._logits(tp, tcfg, rms_norm(torch.from_numpy(x),
                                           tp["final_norm"], tcfg.norm_eps))
    err = np.abs(tl.numpy() - rl)
    bars.append((err.max() / np.abs(rl).max(), err.mean() / np.abs(rl).max()))
    return bars


def _holds(bar):
    return bar[0] <= 5e-2 and bar[1] <= 1e-2


def _port_chain_equals_forward(eval_model, name):
    """The port's ``forward`` logits == its own layers run one at a time
    on its own stream, then the final norm and the head (bit for bit)."""
    tcfg, _, np_params, tokens = eval_model
    tcfg = _quant(name, tcfg, True)
    tp = params_from_numpy(np_params)
    B, T = tokens.shape
    pos = torch.arange(T)[None].expand(B, T)
    with torch.no_grad():
        whole, _ = forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
        x = tt._embed_tokens(tp, tcfg, torch.from_numpy(tokens))
        for i in range(tcfg.n_layers):
            x = tt._dense_body(tt.layer_params(tp["layers"], i), x, pos,
                               tcfg, True, None, 0)
        chain = tt._logits(tp, tcfg, rms_norm(x, tp["final_norm"],
                                              tcfg.norm_eps))
    return torch.equal(whole, chain)


@pytest.mark.parametrize("name", PER_LAYER)
def test_table1_fig9_per_layer_matches_reference(eval_model, name):
    bars = _per_layer_bars(eval_model, name)
    assert all(_holds(b) for b in bars), bars
    assert _port_chain_equals_forward(eval_model, name)


def _reference_sites(eval_model, name, monkeypatch):
    """Every quantized contraction of the reference's layers and head on
    its own residual stream: ``(site, spec, x, w, activation, sum, out)``
    with the reference's own operands, its contraction before the epilogue
    activation and its result, as numpy."""
    from repro.models import attention as r_attn
    from repro.models import linear as r_linear
    _, rcfg, np_params, tokens = eval_model
    rcfg = _quant(name, rcfg, False)
    calls = []

    def recorder(fn):
        def qeinsum(spec, x, w, cfg, **kw):
            out = fn(spec, x, w, cfg, **kw)
            act = kw.pop("activation", "none")
            calls.append((kw.get("site"), spec, np.asarray(x), np.asarray(w),
                          act, np.asarray(fn(spec, x, w, cfg, **kw)),
                          np.asarray(out)))
            return out
        return qeinsum

    for mod in (r_linear, r_attn, rt):
        monkeypatch.setattr(mod, "qeinsum", recorder(mod.qeinsum))
    rp = jax.tree.map(jnp.asarray, np_params)
    B, T = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    x = rt._embed_tokens(rp, rcfg, jnp.asarray(tokens))
    for i in range(rcfg.n_layers):
        pl = jax.tree.map(lambda a: a[i], rp["layers"])
        x, _, _ = rt._dense_body(pl, x, pos, rcfg, True, None, None, None,
                                 None)
    rt._logits(rp, rcfg, r_rms_norm(x, rp["final_norm"], rcfg.norm_eps))
    return calls


def test_int8_wrap_12_every_site_is_bitwise_the_reference(eval_model,
                                                          monkeypatch):
    """Each quantized contraction of every layer (and the head) under
    ``int8_wrap_12``, given the reference's own operands (its norm output,
    its ``silu(wg) * wu`` product, its attention output), equals the
    reference's contraction bit for bit: the sums are integers. The
    ``ffn.wg`` epilogue's ``silu`` is the one op apart (a last-ulp
    ``exp``): the reference's ``jax.nn.silu`` of the port's contraction is
    the reference's output. So the per-layer case's miss comes from the
    operands' last-ulp ``rsqrt`` / ``exp`` upstream, not from the port's
    arithmetic."""
    from repro.kernels.mgs_matmul import ACTIVATIONS as R_ACTIVATIONS
    from repro_torch.quant import qeinsum
    tq = _quant("int8_wrap_12", eval_model[0], True).quant
    calls = _reference_sites(eval_model, "int8_wrap_12", monkeypatch)
    sites = [c[0] for c in calls]
    L = eval_model[1].n_layers
    for s in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wg",
              "ffn.wu", "ffn.wd"):
        assert sites.count(s) == L, (s, sites)
    assert "logits" in sites
    for i, (site, spec, x, w, act, want, out) in enumerate(calls):
        with torch.no_grad():
            got = qeinsum(spec, torch.tensor(x), torch.tensor(w), tq,
                          site=site)
        msg = f"call {i}: {site} {spec}"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)
        if act != "none":
            np.testing.assert_array_equal(
                np.asarray(R_ACTIVATIONS[act](jnp.asarray(got.numpy()))),
                out, err_msg=msg)


@pytest.mark.parametrize("name", ["int8_wrap_12", "int8_clip_14"])
def test_per_layer_bar_catches_a_narrow_width_fault(eval_model, name):
    """The port's layers one narrow bit wider than the reference's."""
    quant = _quant(name, eval_model[0], True).quant
    wide = dataclasses.replace(quant, narrow_bits=quant.narrow_bits + 1)
    bars = _per_layer_bars(eval_model, name, port_quant=wide)
    assert not all(_holds(b) for b in bars), bars


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checks_every_eval_forward_b1_and_b5_shape(monkeypatch):
    """Phase 12's eval forward (here reduced mgs-paper-eval over 2 x 16
    tokens) calls B1 under ``mgs_exact`` and B5 under ``dmac_mgs`` at
    exactly ``launch.dryrun.eval_b1_shapes(cfg, 2, 16)``, with the
    settings its checks use, ``launch.dryrun.eval_launches(cfg)`` times
    each."""
    import importlib
    cs = _chip_smoke()
    cfg = reduced_config("mgs-paper-eval")
    params = init_params(cfg, seed=0)
    tokens = {"tokens": torch.randint(0, cfg.vocab, (2, 16))}
    shapes = dryrun.eval_b1_shapes(cfg, batch=2, seq=16)
    modes = cs.table1_modes()
    b1_calls = []
    b1 = importlib.import_module(
        "repro_torch.kernels.mgs_matmul").mgs_matmul_exact_fused
    for m in ("repro_torch.quant.qmatmul", "repro_torch.kernels.ops"):
        monkeypatch.setattr(importlib.import_module(m),
                            "mgs_matmul_exact_fused",
                            lambda *a, **k: b1_calls.append(1) or b1(*a, **k))
    with torch.no_grad():
        forward(params, dataclasses.replace(cfg, quant=modes["mgs_exact"]),
                tokens)
    monkeypatch.undo()
    with torch.no_grad(), cs.recording_b1() as seen:
        forward(params, dataclasses.replace(cfg, quant=modes["mgs_exact"]),
                tokens)
    assert cs.unchecked_b1(seen, shapes) == set()
    assert {c[:5] for c in seen} == {s[1:] for s in shapes}
    with torch.no_grad(), cs.recording_b5() as seen5:
        forward(params, dataclasses.replace(cfg, quant=modes["dmac_mgs"]),
                tokens)
    assert set(seen5) == {s[1:5] for s in shapes}
    assert len(b1_calls) == len(seen5) == dryrun.eval_launches(cfg) == 37


def test_swamp_and_int_loops_keep_their_bits():
    """The Table 1 / Fig. 9 loops' lean forms: the swamp accumulator's
    ``_round_finite`` == ``round_to_format`` bit for bit (signed zeros,
    ties, the accumulator's subnormals and saturation, random float32 bit
    patterns); ``int_dot_clip(count=False)``'s value == the counted one's;
    ``int_dot_wrap`` == the step-by-step ``((t + half) mod span) - half``."""
    from repro_torch.core import int_dmac
    from repro_torch.core.formats import E4M3, FPFormat, round_to_format
    from repro_torch.kernels.ref import _round_finite
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    for fmt in (FPFormat("acc4", ebits=4, mbits=3), E4M3):
        q = [2.0 ** (e - fmt.mbits) * k for e in range(-12, 12)
             for k in np.arange(-40, 40) / 2]
        x = torch.from_numpy(np.concatenate([
            bits[np.isfinite(bits)], np.float32(q),
            np.float32([0.0, -0.0, fmt.max_finite, 1e38, -1e-45])]))
        assert torch.equal(_round_finite(x, fmt).view(torch.int32),
                           round_to_format(x, fmt).view(torch.int32))
    xq = torch.from_numpy(rng.integers(-127, 128, (6, 1, 300)).astype(
        np.int32))
    wq = torch.from_numpy(rng.integers(-127, 128, (1, 5, 300)).astype(
        np.int32))
    for nb in (12, 16):
        assert torch.equal(int_dmac.int_dot_clip(xq, wq, nb, count=False)[0],
                           int_dmac.int_dot_clip(xq, wq, nb)[0])
        span, half = 1 << nb, 1 << (nb - 1)
        acc = torch.zeros((6, 5), dtype=torch.int32)
        for k in range(300):
            acc = torch.remainder(acc + xq[..., k] * wq[..., k] + half,
                                  span) - half
        assert torch.equal(int_dmac.int_dot_wrap(xq, wq, nb), acc)
