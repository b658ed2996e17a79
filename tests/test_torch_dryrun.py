"""The port's cost tooling against the reference's and against the port
itself (``repro_torch.launch.step_cost`` / ``dryrun``).

* ``step_cost`` records a real reduced step of every family (float32,
  quant ``none``): its dot FLOPs equal ``repro.launch.hlo_cost``'s count
  of the reference's jitted forward and gradient, except where the two
  programs hold different dots, each gap stated and pinned: the MoE
  families' integer slot-token einsum (``2 G g E C k`` a MoE layer) and
  the one-hot dots XLA makes of the dispatch / combine gathers; one fewer
  scan-sized dot a Mamba layer in XLA's backward (``2 B T d_inner N``).
* The dry run's per-layer closed forms (``dryrun.step_dots``) equal
  ``step_cost``'s record at reduced widths for every family: FLOPs, float
  dot bytes, kernel launches by entry and the kernels' bound, for a
  teacher-forced forward, a prefill, a decode step and a train step
  under ``none``, and the serving steps under ``FP8_MGS_SERVE_KV``.
* Per-rank argument bytes on 2x2 and 2x4 ``MeshShape``\\ s (the prepared
  planes, the packed cache built on the ``meta`` device for each rank,
  the train state) equal the sum of the shards ``local_slices`` gives
  every rank; on a real 2x2 world of gloo ranks the engine's own tensors,
  its launches and its collectives equal the dry run's for a served run,
  under the serving preset and configurations (a) (B5's partials and
  combine), (b) (B4's partials and B1's flush) and (e) (``INT8_DMAC``: raw
  slices, the integer sums' all-reduce).
* At 1x2 the dry run's serving collectives and launches equal
  ``dryrun.sharded_prediction`` (the prediction ``chip_smoke.py`` phase 14
  holds the card's counts to).
* whisper-tiny ``train_4k`` on 2x16x16 has 512 devices and a useful-FLOPs
  ratio in (0.05, 3.0) once the rules' sequence cut is computed (the
  reference's own check), 16x lower as the port repeats each batch shard
  on the 16 ranks of the model axis today; a cell that cannot fit
  (dbrx-132b ``decode_32k`` on 1x1) reports ``fits_hbm`` false.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import forward as r_forward  # noqa: E402
from repro.models import loss_fn as r_loss_fn  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun, step_cost  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, loss_fn, prefill)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.sharding import (local_slices,  # noqa: E402
                                           make_rules, prepared_specs)
from repro_torch.quant import (FP8_MGS, FP8_MGS_EXACT,  # noqa: E402
                               FP8_MGS_SERVE_KV, INT8_DMAC, QuantConfig)

FAMILIES = ["mgs-paper-eval", "gemma3-27b", "granite-moe-1b-a400m",
            "falcon-mamba-7b", "jamba-1.5-large-398b", "whisper-tiny",
            "internvl2-2b"]
F32 = dict(compute_dtype="float32", param_dtype="float32")
B, T = 2, 8


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


def _batch(cfg, labels=False):
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if labels:
        b["labels"] = b["tokens"]
    if cfg.vision_prefix:
        b["vision_embeds"] = rng.normal(
            0, 1, (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        b["audio_embeds"] = rng.normal(
            0, 1, (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def _recorded_train(cfg, params, batch):
    with step_cost.record() as c:
        total, _ = loss_fn(_requires_grad(params), cfg, batch)
        total.backward()
    return c


# the reference's dots that the port does not hold (forward, train step),
# as measured on the reduced configs: the MoE families' slot-token einsum
# and the one-hot dots of their gathers; the Mamba gap is the port's
# extra backward dot
HLO_GAPS = {"granite-moe-1b-a400m": (540672, 1064960),
            "jamba-1.5-large-398b": (532480, 1024000),
            "falcon-mamba-7b": (0, -65536)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_cost_flops_equal_hlo_cost(arch):
    tcfg = dataclasses.replace(reduced_config(arch), **F32)
    rcfg = dataclasses.replace(r_reduced(arch), **F32)
    npp = _np_tree(init_params(tcfg, seed=0))
    batch = _batch(tcfg, labels=True)
    rp = jax.tree.map(jnp.asarray, npp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = analyze_hlo(jax.jit(lambda p, b: r_forward(p, rcfg, b)[0]).lower(
        rp, jb).compile().as_text()).flops
    train = analyze_hlo(jax.jit(jax.grad(
        lambda p, b: r_loss_fn(p, rcfg, b)[0])).lower(
        rp, jb).compile().as_text()).flops
    with torch.no_grad(), step_cost.record() as c:
        forward(params_from_numpy(npp), tcfg, _t(batch))
    ct = _recorded_train(tcfg, params_from_numpy(npp), _t(batch))
    gap_f, gap_t = HLO_GAPS.get(arch, (0, 0))
    assert fwd - c.flops == gap_f
    assert train - ct.flops == gap_t
    if arch in ("granite-moe-1b-a400m",):
        # 4 MoE layers, G = 1 group of g = 16 tokens, E = 4, C = 16, k = 2,
        # d = 64: the slot-token einsum and the dispatch gather's one-hot
        E, C, g, k, d = 4, 16, 16, 2, 64
        assert gap_f == 4 * (2 * g * E * C * k + 2 * E * C * g * d)
    if arch == "falcon-mamba-7b":
        L, di, N = tcfg.n_layers, tcfg.d_inner, tcfg.ssm_state
        assert -gap_t == L * 2 * B * T * di * N


def _recorded_steps(cfg, kernels: bool):
    """step_cost of a forward, a prefill and a decode step (and, float
    only, a train step) of ``cfg`` at B x T."""
    params = init_params(cfg, seed=0)
    S = cfg.vision_prefix + T + 4
    out = {}
    with torch.no_grad():
        with step_cost.record() as c:
            forward(params, cfg, _t(_batch(cfg)))
        out["forward"] = (c, 0)
        cache = init_cache(cfg, B, S)
        with step_cost.record() as c:
            prefill(params, cfg, _t(_batch(cfg)), cache)
        out["prefill"] = (c, S)
        with step_cost.record() as c:
            decode_step(params, cfg, torch.zeros((B, 1), dtype=torch.long),
                        cache)
        out["decode"] = (c, S)
    if not kernels:
        out["train"] = (_recorded_train(cfg, init_params(cfg, seed=0),
                                        _t(_batch(cfg, labels=True))), 0)
    return out


@pytest.mark.parametrize("quant", ["none", "fp8_mgs_serve_kv"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_closed_forms_equal_step_cost(arch, quant):
    cfg = dataclasses.replace(reduced_config(arch), **F32,
                              quant=dryrun.QUANT_MODES[quant])
    kernels = quant != "none"
    for kind, (rec, S) in _recorded_steps(cfg, kernels).items():
        live = cfg.vision_prefix + T + 1 if kind == "decode" else None
        dots = dryrun.step_dots(cfg, kind, B, T, cache_len=S, live=live)
        assert sum(d.flops for d in dots) == rec.flops, kind
        assert dryrun.dot_bytes(dots, 4) == rec.dot_bytes, kind
        assert dryrun.launches(dots) == rec.launches, kind
        assert dryrun.kernel_bound_ms(dots) == pytest.approx(
            rec.kernel_bound_ms, rel=1e-12), kind
        assert bool(rec.launches) == kernels


@dataclasses.dataclass(frozen=True)
class _RankView:
    """One rank of a ``MeshShape``: what ``local_slices`` and the rules
    read."""
    axis_names: tuple
    sizes: tuple
    rank: int

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self):
        return int(np.prod(self.sizes))

    @property
    def coord(self):
        return dict(zip(self.axis_names, np.unravel_index(self.rank,
                                                          self.sizes)))


def _shard_bytes(spec, shape, view, itemsize):
    return int(np.prod([s.stop - s.start for s in local_slices(
        spec, tuple(shape), view)])) * itemsize


def _serve_bytes_by_slices(cfg, view):
    """A rank's prepared planes (codes, scales), raw leaves and packed
    cache, from ``local_slices`` of every plane and ``init_cache`` built
    for that rank."""
    from repro_torch.models.transformer import (param_dims, param_shapes,
                                                init_cache as tinit)
    from repro_torch.quant.prepared import (_K_NDIM, _PROJ_WEIGHTS,
                                            _stack_ndim_of)
    rules = make_rules(view, "serve", shard_batch=False)
    dims = dict(dryrun._walk(param_dims(cfg)))
    total = 0
    for path, shape in dryrun._walk(param_shapes(cfg)):
        if path[-1] in _PROJ_WEIGHTS.get(path[-2] if len(path) > 1 else "",
                                         ()):
            k_ndim = _K_NDIM.get((path[-2], path[-1]), 1)
            st = _stack_ndim_of(path, len(shape), k_ndim, cfg.is_hybrid)
            cs, _, ss = prepared_specs(dims[path], shape, rules,
                                       stack_ndim=st, k_ndim=k_ndim)
            stack = tuple(shape[:st])
            K = int(np.prod(shape[st:st + k_ndim]))
            n = int(np.prod(shape[st + k_ndim:]))
            total += _shard_bytes(cs, stack + (K, n), view, 1)
            total += _shard_bytes(ss, stack, view, 4)
        else:
            item = 2 if len(shape) >= 2 else 4
            total += int(np.prod(shape)) * item
    cs, _, ss = prepared_specs(("embed", "vocab"), (cfg.d_model, cfg.vocab),
                               rules)
    total += _shard_bytes(cs, (cfg.d_model, cfg.vocab), view, 1)
    total += _shard_bytes(ss, (), view, 4)
    if not cfg.tie_embeddings:
        total -= cfg.d_model * cfg.vocab * 2
    cache = tinit(cfg, 4, 40, device="meta", rules=rules)
    total += sum(t.numel() * t.element_size() for t in cache.values()
                 if isinstance(t, torch.Tensor))
    return total


def _state_bytes_by_slices(cfg, view):
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.sharding import train_rules
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import flatten_with_paths
    specs = flatten_with_paths(train_state_specs(cfg, train_rules(view),
                                                 False))
    shapes = flatten_with_paths(param_shapes(cfg))
    total = 0
    for k, spec in specs.items():
        if k.startswith("params/") or k.startswith("opt/mu/") or \
                k.startswith("opt/nu/"):
            total += _shard_bytes(spec, shapes[k.split("/", 2)[-1]
                                               if not k.startswith("params/")
                                               else k[7:]], view, 4)
        else:
            total += 4
    return total


@pytest.mark.parametrize("mesh", ["2x2", "2x4"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_per_rank_argument_bytes_equal_local_slices(arch, mesh):
    ms = dryrun.parse_mesh(mesh)
    cfg = dataclasses.replace(reduced_config(arch), quant=FP8_MGS_SERVE_KV)
    rules0 = make_rules(dryrun._rank0(ms), "serve", shard_batch=False)
    pb = dryrun.param_bytes(cfg, rules0)
    want = pb["prepared"] + pb["raw"] + dryrun.cache_bytes(cfg, 4, 40,
                                                           rules0)
    tcfg = dataclasses.replace(reduced_config(arch), **F32)
    from repro_torch.parallel.sharding import train_rules
    st = dryrun.state_bytes(tcfg, train_rules(dryrun._rank0(ms)), False)
    for r in range(int(np.prod(ms.sizes))):
        view = _RankView(ms.axis_names, ms.sizes, r)
        assert _serve_bytes_by_slices(cfg, view) == want, r
        assert _state_bytes_by_slices(tcfg, view) == \
            st["params"] + st["opt"], r
    # something is cut: the slices sum to less than the whole
    assert pb["prepared"] < dryrun.param_bytes(cfg)["prepared"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_serve_collectives_equal_sharded_prediction(arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=4,
                              quant=FP8_MGS_SERVE_KV)
    want = dryrun.sharded_prediction(cfg, model=2, staged=False)
    rules = make_rules(dryrun._rank0(dryrun.parse_mesh("1x2")), "serve",
                       shard_batch=False)
    coll = []
    dots = dryrun.step_dots(cfg, "decode", 4, 1, cache_len=49, rules=rules,
                            coll=coll)
    assert dryrun.launches(dots) == {k: v for k, v in
                                     want["step_launches"].items() if v}
    step = want["step_comm"]
    assert len(coll) == step["calls"]
    assert sum(nb for _, nb, _ in coll) == step["bytes"]
    for kind in ("all_gather", "all_reduce_max", "all_reduce_sum"):
        assert sum(k == kind for k, _, _ in coll) == step[kind]


_NEW = 3
#: the served 2x2 runs: the serving preset and configurations (a), (b), (e)
#: of ``chip_smoke.paper_configs``
SERVED = {"none": QuantConfig(), "fp8_mgs_serve_kv": FP8_MGS_SERVE_KV,
          "a": FP8_MGS.replace(use_kernel=True),
          "b": FP8_MGS_EXACT.replace(use_kernel=True),
          "e": INT8_DMAC}


def _served_rank(rank, shape):
    """A rank of a ``shape`` mesh serving one group of 2 requests under
    each of ``SERVED``, recorded: the engine's own parameter and cache
    bytes, the run's launches and collectives."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.quant import PreparedWeight, RawSlice
    mesh = make_mesh(shape, ("data", "model"))

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, PreparedWeight):
            return sum(t.numel() * t.element_size() for t in
                       (tree.codes, tree.scale, tree.limbs) if t is not None)
        if isinstance(tree, RawSlice):
            return sum(t.numel() * t.element_size() for t in
                       (tree.values, tree.amax))
        return tree.numel() * tree.element_size()
    out = {}
    for key, quant in SERVED.items():
        cfg = dataclasses.replace(reduced_config("deepseek-7b"), quant=quant)
        eng = ServeEngine(cfg, batch=2, max_len=16, device="cpu", mesh=mesh)
        cache = eng._init_cache(2)
        cb = sum(t.numel() * t.element_size() for t in cache.values()
                 if isinstance(t, torch.Tensor))
        reqs = [Request(rid=i, prompt=np.arange(1, 9, dtype=np.int32) + i,
                        max_new_tokens=_NEW) for i in range(2)]
        with step_cost.record() as c:
            eng.run(reqs)
        out[key] = {"params": nbytes(eng.params), "cache": cb,
                    "flops": c.flops, "launches": c.launches,
                    "collectives": sorted(c.collectives)}
    return out


_SERVED_RUNS: dict = {}


def _served(tmp_path_factory):
    if not _SERVED_RUNS:
        _SERVED_RUNS["2x2"] = comm.launch(
            _served_rank, 4, args=((2, 2),), timeout=300, threads=1,
            store_dir=str(tmp_path_factory.mktemp("store")))
    return _SERVED_RUNS["2x2"]


@pytest.mark.parametrize("key", list(SERVED))
def test_a_served_2x2_run_equals_the_dry_run(key, tmp_path_factory):
    """Reduced deepseek-7b on a 2x2 world of gloo ranks (wq / wk / wv / wg /
    wu cut along K over data, heads and ffn over model), under the serving
    preset and configurations (a) (B5), (b) (B4) and (e) (``INT8_DMAC``):
    every rank's prepared and raw parameter bytes, its cache bytes, and
    the launches and collectives of a prefill of 8 tokens and 2 decode
    steps equal the dry run's."""
    outs = _served(tmp_path_factory)
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              quant=SERVED[key])
    rules = make_rules(dryrun._rank0(dryrun.parse_mesh("2x2")), "serve",
                       shard_batch=False)
    pb = dryrun.param_bytes(cfg, rules)
    coll, launches, flops = [], {}, 0.0
    for kind, seq in [("prefill", 8)] + [("decode", 1)] * (_NEW - 1):
        dots = dryrun.step_dots(cfg, kind, 2, seq, cache_len=16,
                                rules=rules, coll=coll)
        flops += sum(d.flops for d in dots)
        for k, v in dryrun.launches(dots).items():
            launches[k] = launches.get(k, 0) + v
    for out in outs:
        got = out[key]
        assert got["params"] == pb["prepared"] + pb["raw"]
        assert got["cache"] == dryrun.cache_bytes(cfg, 2, 16, rules)
        assert got["flops"] == flops
        assert got["launches"] == launches
        assert got["collectives"] == sorted(coll)
    assert bool(launches) == (key not in ("none", "e"))


def test_whisper_train_on_two_pods():
    rec = dryrun.run_cell("whisper-tiny", "train_4k", "2x16x16")
    assert rec["n_devices"] == 512
    assert rec["repeat"] == 16
    assert 0.05 < rec["useful_flops_ratio_layout"] < 3.0
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["useful_flops_ratio_layout"] / 16, rel=1e-12)
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_a_cell_that_cannot_fit_says_so():
    rec = dryrun.run_cell("dbrx-132b", "decode_32k", "1x1")
    assert rec["fits_hbm"] is False
    assert rec["memory_per_device"]["live_bytes"] > 85e9
    small = dryrun.run_cell("deepseek-7b", "decode_32k", "16x16",
                            "fp8_mgs_serve_kv")
    assert small["fits_hbm"] is True
    assert small["launches"]["mgs_flash_attention"] == 30
