"""The continuous engine and speculative decoding on a ``(data, model)`` mesh
of gloo ranks on the CPU (``parallel.comm.launch``, a ``FileStore`` under
``tmp_path``), each spawn under a deadline, torch pinned to one thread in
the parent and every rank; each mesh spawned once for the module.

* B3's partials twin over any cut of K, both stationary schedules, flush
  periods 1-4 and none, flushed == one ``mgs_matmul_stationary_plain``
  call, and == the reference's Pallas kernel under the same schedule,
  bitwise;
* the paged pool's specs == the reference's ``resolve_spec`` of its
  ``init_paged_cache`` dims under its serve rules (deepseek-7b full and
  reduced, granite-20b's one kv head replicated), and the pool a rank
  allocates holds its kv heads;
* the reference harness's ragged traffic (``tests/test_continuous.py``) on
  reduced deepseek-7b, 1x2 and 2x2, ``schedule="output"`` (B1's partials)
  and ``"activation"`` (B3's): tokens and every logits row bitwise the 1x1
  port engine's; ``spec_k=2`` with a one-layer draft on 1x2 bitwise
  sequential 1x1; reduced granite-20b on 1x2 (a whole pool under cut
  query heads) bitwise 1x1;
* rank 1's clock run ahead of rank 0's: every rank admits the same
  requests at the same round, rank 0 before its own clock reaches them,
  the tokens are bitwise 1x1, and one agreement a scheduling round;
* ``feed=`` on a mesh names A12.2c; the CLI's ``--mesh 1x2 --continuous``
  (with and without ``--spec-k 2``) prints the 1x1 tokens.
"""

import contextlib
import dataclasses
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_matmul import mgs_matmul_exact_fused_pallas  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_paged_cache as ref_init_paged_cache)
from repro.parallel import sharding as rs  # noqa: E402
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.formats import E4M3, encode_bits, round_to_format  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    mgs_matmul_exact_flush, mgs_matmul_exact_partials,
    mgs_matmul_stationary_plain, partial_segments)
from repro_torch.launch.serve import (  # noqa: E402
    ContinuousBatchingEngine, Request)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_paged_cache, paged_cache_specs)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.sharding import MeshShape, make_rules  # noqa: E402
from repro_torch.quant.config import FP8_MGS_SERVE_PAGED  # noqa: E402

TIMEOUT = 300.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops in several processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 40
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    return encode_bits(round_to_format(torch.from_numpy(x), E4M3), E4M3)


# ---------------------------------------------------------------------------
# B3's partials twin, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["activation", "weight"])
@pytest.mark.parametrize("fp", [1, 2, 3, 4, None])
@pytest.mark.parametrize("cuts", [(0,), (0, 77), (0, 13, 150), (0, 31, 33)])
def test_stationary_partials_over_any_cut_flush_to_one_call(cuts, fp,
                                                            schedule):
    x, w = _codes((2, 5, 300), 0), _codes((2, 300, 24), 1)
    scale = torch.rand((2, 1, 24), generator=torch.Generator().manual_seed(2))
    one = mgs_matmul_stationary_plain(x, w, E4M3, schedule=schedule,
                                      scale=scale, activation="silu",
                                      block_k=32, flush_period=fp)
    edges = list(cuts) + [300]
    part = sum(mgs_matmul_exact_partials(
        x[..., a:b], w[:, a:b], E4M3, block_k=32, flush_period=fp,
        k_offset=a, k_total=300, schedule=schedule)
        for a, b in zip(edges[:-1], edges[1:]))
    _, nseg = partial_segments(300, 32, fp)
    assert part.shape == (nseg, 5, 2, 5, 24) and part.dtype == torch.int32
    got = mgs_matmul_exact_flush(part, E4M3, scale=scale, activation="silu")
    assert torch.equal(got, one)


@pytest.mark.parametrize("schedule", ["activation", "weight"])
@pytest.mark.parametrize("cuts,fp", [((0, 70), 2), ((0, 13, 150), None)])
def test_stationary_partials_equal_the_references_stationary_kernel(
        cuts, fp, schedule):
    """The flushed pieces == the reference's Pallas kernel under the same
    schedule (interpret mode), as B1's partials are held to its output
    schedule."""
    x, w = _codes((8, 200), 3), _codes((200, 16), 4)
    edges = list(cuts) + [200]
    part = sum(mgs_matmul_exact_partials(
        x[:, a:b], w[a:b], E4M3, block_k=32, flush_period=fp, k_offset=a,
        k_total=200, schedule=schedule)
        for a, b in zip(edges[:-1], edges[1:]))
    got = mgs_matmul_exact_flush(part, E4M3)[0]
    ref = np.asarray(mgs_matmul_exact_fused_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), rf.E4M3,
        block_m=8, block_n=8, block_k=32, flush_period=fp,
        schedule=schedule, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stationary_partials_refuse_a_stripe_over_the_budget():
    """The admission rule over the cut's K, as B3 refuses its whole K."""
    x, w = _codes((80, 4000), 3), _codes((4000, 8), 4)
    with pytest.raises(ValueError, match="stripe"):
        mgs_matmul_exact_partials(x, w, E4M3, schedule="activation")
    ok = mgs_matmul_exact_partials(x[:, :64], w[:64], E4M3, k_total=4000,
                                   schedule="activation")
    assert torch.equal(ok, mgs_matmul_exact_partials(
        x[:, :64], w[:64], E4M3, k_total=4000))


# ---------------------------------------------------------------------------
# the pool's specs against the reference's, no ranks
# ---------------------------------------------------------------------------

POOL_MESHES = [(1, 2), (2, 2), (1, 4), (1, 8)]
POOL_MODELS = [("deepseek-7b", False), ("deepseek-7b", True),
               ("granite-20b", False), ("granite-20b", True)]


def _ref_mesh(shape):
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, ("data", "model"))


@pytest.mark.parametrize("shape", POOL_MESHES,
                         ids=["x".join(map(str, m)) for m in POOL_MESHES])
@pytest.mark.parametrize("arch,reduced", POOL_MODELS,
                         ids=[f"{a}{'-reduced' if r else ''}"
                              for a, r in POOL_MODELS])
def test_pool_specs_are_the_references(arch, reduced, shape):
    cfg = dataclasses.replace(
        reduced_config(arch) if reduced else get_config(arch),
        quant=FP8_MGS_SERVE_PAGED)
    rcfg = dataclasses.replace(
        ref_reduced(arch) if reduced else ref_get_config(arch),
        quant=RefQuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                             kv_cache="packed", per_row_act=True))
    slots, max_len = 4, 256
    n_blocks = slots * -(-max_len // cfg.quant.block_k) + 1
    box = {}

    def trace():
        cache, box["dims"] = ref_init_paged_cache(rcfg, slots, max_len,
                                                  n_blocks)
        return cache
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jax.eval_shape(trace))     # nothing allocated
    ref = rs.resolve_spec(box["dims"], shapes, rs.make_rules(
        _ref_mesh(shape), "serve", shard_batch=False))
    got = paged_cache_specs(cfg, slots, max_len, n_blocks, make_rules(
        MeshShape(("data", "model"), shape), "serve", shard_batch=False))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == tuple(ref[k]), k
    cut = cfg.n_kv_heads % shape[1] == 0
    assert got["k"] == ((None, None, "model") if cut else ())
    assert got["block_table"] == () and got["pos"] == ()


@pytest.mark.parametrize("arch,model", [("deepseek-7b", 2), ("deepseek-7b", 8),
                                        ("granite-20b", 2)])
def test_a_ranks_pool_holds_its_kv_heads(arch, model):
    cfg = dataclasses.replace(reduced_config(arch),
                              quant=FP8_MGS_SERVE_PAGED.replace(block_k=32))

    class _Rank(MeshShape):     # a rank's coordinate on a plain record
        size = model
        coord = {"data": 0, "model": model - 1}
    rules = make_rules(_Rank(("data", "model"), (1, model)), "serve",
                       shard_batch=False)
    cache = init_paged_cache(cfg, 3, 48, 7, rules=rules)
    kv = cfg.n_kv_heads
    assert cache["k"].shape == (cfg.n_layers, 7, kv // model if kv % model
                                == 0 else kv, 32, cfg.head_dim)
    assert cache["k_scale"].shape == cache["k"].shape[:-1]
    assert cache["block_table"].shape == (3, 2)
    assert cache["pos"].shape == (3,)


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------

_BUCKETS = [8, 16]
_MAXLEN = 48
_PLENS = (5, 11, 3, 8, 14, 6)
_MAXNEW = (4, 3, 5, 2, 4, 3)
#: the skewed run: the last three arrive this late (seconds)
_LATE = 20.0


def _cfg(arch="deepseek-7b", **quant):
    return dataclasses.replace(
        reduced_config(arch),
        quant=FP8_MGS_SERVE_PAGED.replace(block_k=32, **quant))


def _params(cfg):
    """Seed-0 weights with the residual output projections scaled by 8, so
    that the layers move the residual, the tokens vary and a one-layer
    draft is rejected now and then."""
    params = init_params(cfg, 0)
    params["layers"]["attn"]["wo"] *= 8.0
    params["layers"]["ffn"]["wd"] *= 8.0
    return params


def _prompts(n=len(_PLENS), vocab=256):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, p).astype(np.int32) for p in _PLENS[:n]]


def _serve(mesh, job):
    """One job on ``mesh`` (``None``: one rank); returns tokens, logits
    rows, stats and the collectives counted while serving."""
    kind, sched = job
    arch = "granite-20b" if kind == "granite" else "deepseek-7b"
    spec = kind == "spec"           # "spec_seq": its traffic, sequential
    traffic = kind.startswith("spec")
    cfg = _cfg(arch, schedule=sched,
               **({"draft_layers": 1} if traffic else {}))
    slots, max_len, new = (2, 36, (3, 3, 3)) if traffic \
        else (3, _MAXLEN, _MAXNEW)
    eng = ContinuousBatchingEngine(cfg, slots=slots, max_len=max_len,
                                   params=_params(cfg), device="cpu",
                                   mesh=mesh, spec_k=2 if spec else None)
    eng.warmup(_BUCKETS, max_new=2)
    prompts = _prompts(len(new))
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, new))]
    arrivals = None
    if kind == "skew":
        # rank 1's clock runs 10 * _LATE ahead: its arrivals come that
        # much earlier on its own clock
        ahead = 10 * _LATE if mesh.coord["model"] == 1 else 0.0
        arrivals = [a - ahead for a in [0.0] * 3 + [_LATE] * 3]
    agree0 = comm.COMM_STATS["agree"]
    stats = eng.serve(reqs, arrivals=arrivals, record_logits=True)
    return dict(tokens=[r.out_tokens for r in reqs],
                logits={k: np.stack(v) for k, v in stats["logits"].items()},
                rounds=stats["rounds"], admit_rounds=stats["admit_rounds"],
                wall_s=stats["wall_s"], steps=stats["steps"],
                spec=stats.get("spec"),
                agreed=comm.COMM_STATS["agree"] - agree0,
                pool=tuple(eng.cache["k"].shape))


def _count_calls(*counts):
    """Count the models' calls of each kernel wrapper, in each of
    ``counts``, under the name the card's launch counter gives it
    (``kernels.LAUNCHES``): B1 / B3 and their partials by schedule, the
    flush, B2's three entries. Returns a function that takes the wrappers
    out again."""
    import importlib
    mods = {m: importlib.import_module("repro_torch." + m) for m in (
        "quant.qmatmul", "kernels.ops", "models.attention")}
    saved = []

    def wrap(mod, fn, name_of):
        inner = getattr(mods[mod], fn)
        saved.append((mods[mod], fn, inner))

        def counted(*a, **kw):
            name = name_of(kw)
            for calls in counts:
                calls[name] = calls.get(name, 0) + 1
            return inner(*a, **kw)
        setattr(mods[mod], fn, counted)

    def by_schedule(b1, b3):
        return lambda kw: b1 if kw.get("schedule", "output") == "output" \
            else b3
    for mod in ("quant.qmatmul", "kernels.ops"):
        wrap(mod, "mgs_matmul_exact_fused", by_schedule(
            "mgs_matmul_exact_fused", "mgs_matmul_exact_fused_stationary"))
    wrap("quant.qmatmul", "mgs_matmul_exact_partials", by_schedule(
        "mgs_matmul_exact_partials", "mgs_matmul_stationary_partials"))
    wrap("quant.qmatmul", "mgs_matmul_exact_flush",
         lambda kw: "mgs_matmul_exact_flush")
    for fn in ("mgs_flash_attention", "mgs_paged_flash_attention",
               "mgs_paged_verify_attention"):
        wrap("models.attention", fn, lambda kw: "mgs_flash_attention")

    def restore():
        for mod, fn, inner in saved:
            setattr(mod, fn, inner)
    return restore


def _slots_filled(eng):
    """Every slot admitted outside ``serve``; the step's current tokens."""
    active = {}
    for i, p in enumerate(_prompts(eng.slots)):
        eng._admit(Request(rid=900 + i, prompt=p, max_new_tokens=4), 0.0,
                   time.monotonic(), active)
    cur = np.zeros((eng.slots, 1), np.int64)
    for slot, st in active.items():
        cur[slot, 0] = st.cur
    return eng._tokens(cur)


#: the counted runs: phase 14's at the reduced width (activation-stationary,
#: 3 slots, speculation at k 3 with a 2-layer draft)
_COUNT_SPEC = (3, 2)
#: a stripe budget (bytes) under which the reduced width falls back as the
#: full width does: 3 decode rows over K 64 stay on B3, the one-rank
#: decode's wd (K 128), every prefill and the verify's 9 rows take B1
_SMALL_BUDGET = 1000


@contextlib.contextmanager
def _budget(nbytes):
    import importlib
    mm = importlib.import_module("repro_torch.kernels.mgs_matmul")
    saved = mm.WS_STRIPE_BUDGET_BYTES
    if nbytes is not None:
        mm.WS_STRIPE_BUDGET_BYTES = nbytes
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the fallbacks' notices
            yield
    finally:
        mm.WS_STRIPE_BUDGET_BYTES = saved


def _counted(mesh, calls, spec: bool, budget=None):
    """The harness traffic, then one step (or round) alone, each counted:
    calls by kernel entry and, on a mesh, collectives; ``budget``: the
    stripe budget they run under."""
    with _budget(budget):
        return _counted_runs(mesh, calls, spec)


def _counted_runs(mesh, calls, spec: bool):
    k, draft = _COUNT_SPEC
    cfg = _cfg(schedule="activation", **({"draft_layers": draft} if spec
                                         else {}))
    eng = ContinuousBatchingEngine(cfg, slots=3, max_len=_MAXLEN,
                                   params=_params(cfg), device="cpu",
                                   mesh=mesh, spec_k=k if spec else None)
    eng.warmup(_BUCKETS, max_new=2)
    out = {}
    for part in ("run", "step"):
        calls.clear()
        c0 = dict(comm.COMM_STATS)
        if part == "run":
            reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                    for i, (p, m) in enumerate(zip(_prompts(), _MAXNEW))]
            st = eng.serve(reqs)
            out.update(steps=st["steps"], rounds=st["rounds"],
                       tokens=[r.out_tokens for r in reqs])
        else:
            cur = _slots_filled(eng)
            calls.clear()
            c0 = dict(comm.COMM_STATS)
            if spec:
                eng._spec_round(cur)
            else:
                eng._decode_paged(cur)
        out[part + "_launches"] = dict(calls)
        out[part + "_comm"] = {key: comm.COMM_STATS[key] - c0[key]
                               for key in c0}
    return out


def _rank(rank, shape, jobs):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"))
    calls, total = {}, {}
    out = {"coord": mesh.coord, "calls": total}
    _count_calls(calls, total)
    for job in jobs:
        if job[0] == "count":
            out[job] = _counted(mesh, calls, job[1] == "spec", job[2])
            continue
        if job == ("feed", None):
            eng = ContinuousBatchingEngine(_cfg(), slots=2, max_len=_MAXLEN,
                                           device="cpu", mesh=mesh)
            try:
                eng.serve([Request(rid=0, prompt=_prompts(1)[0],
                                   max_new_tokens=2)], feed=lambda: [])
                out[job] = None
            except NotImplementedError as e:
                out[job] = str(e)
            continue
        out[job] = _serve(mesh, job)
    out["comm"] = dict(comm.COMM_STATS)
    return out


DENSE = [("dense", "output"), ("dense", "activation")]
JOBS = {(1, 2): DENSE + [("spec", "output"), ("granite", "output"),
                         ("skew", "output"), ("feed", None),
                         *[("count", m, b) for m in ("seq", "spec")
                           for b in (None, _SMALL_BUDGET)]],
        (2, 2): DENSE}
_RUNS: dict = {}


def _run(shape, tmp_path_factory):
    if shape not in _RUNS:
        _RUNS[shape] = comm.launch(
            _rank, shape[0] * shape[1], args=(shape, JOBS[shape]),
            timeout=TIMEOUT, threads=1,
            store_dir=str(tmp_path_factory.mktemp("store")))
    return _RUNS[shape]


@pytest.fixture(scope="module")
def one_rank():
    """The 1x1 engines on the same weights and traffic, in this process:
    sequential decode under both schedules, the spec traffic served
    sequentially, granite-20b."""
    return {job: _serve(None, job) for job in
            DENSE + [("spec_seq", "output"), ("granite", "output")]}


def _bitwise(got, want, what):
    assert got["tokens"] == want["tokens"], what
    assert sorted(got["logits"]) == sorted(want["logits"]), what
    for rid, rows in want["logits"].items():
        np.testing.assert_array_equal(got["logits"][rid], rows,
                                      err_msg=f"{what} request {rid}")


def test_the_traffic_exercises_the_engine(one_rank):
    """The weights make the tokens vary and the draft miss: the bitwise
    checks below are not over a constant stream."""
    base = one_rank[("dense", "output")]
    assert len({t for toks in base["tokens"] for t in toks}) > 3
    assert base["steps"] > max(_MAXNEW) - 1
    _bitwise(one_rank[("dense", "activation")], base, "B3 vs B1 at 1x1")


ENGINE_MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("schedule", ["output", "activation"])
@pytest.mark.parametrize("shape", ENGINE_MESHES,
                         ids=["x".join(map(str, m)) for m in ENGINE_MESHES])
def test_continuous_engine_on_a_mesh_is_bitwise_one_rank(
        shape, schedule, one_rank, tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    want = one_rank[("dense", schedule)]
    for r, out in enumerate(res):
        _bitwise(out[("dense", schedule)], want, f"rank {r} {shape}")
        # the pool holds this rank's 2 of the 4 kv heads
        assert out[("dense", schedule)]["pool"][2] == 2
    assert res[0]["comm"]["all_reduce_sum"] > 0    # K-cut partials summed
    # the K-cut products ran B1's partials (schedule output) or B3's
    assert res[0]["calls"]["mgs_matmul_exact_partials"] > 0
    assert res[0]["calls"]["mgs_matmul_stationary_partials"] > 0
    if shape == (2, 2):                     # prefill caches cut over data
        assert res[0]["comm"]["all_gather"] > 0


def test_speculation_on_a_mesh_is_bitwise_sequential_one_rank(
        one_rank, tmp_path_factory):
    res = _run((1, 2), tmp_path_factory)
    want = one_rank[("spec_seq", "output")]
    for r, out in enumerate(res):
        got = out[("spec", "output")]
        _bitwise(got, want, f"spec rank {r}")
        # drafts were made, and some rejected: the rewind ran
        assert 0 <= got["spec"]["accepted"] < got["spec"]["drafted"]


def test_granite_whole_pool_under_cut_query_heads_is_bitwise_one_rank(
        one_rank, tmp_path_factory):
    res = _run((1, 2), tmp_path_factory)
    want = one_rank[("granite", "output")]
    for r, out in enumerate(res):
        got = out[("granite", "output")]
        _bitwise(got, want, f"granite rank {r}")
        assert got["pool"][2] == 1              # the one kv head, whole


def test_a_skewed_clock_changes_no_admission_and_no_token(
        one_rank, tmp_path_factory):
    res = _run((1, 2), tmp_path_factory)
    want = one_rank[("dense", "output")]
    runs = [out[("skew", "output")] for out in res]
    for r, got in enumerate(runs):
        _bitwise(got, want, f"skewed rank {r}")
        # one agreement a scheduling round
        assert got["agreed"] == got["rounds"]
    assert runs[0]["admit_rounds"] == runs[1]["admit_rounds"]
    assert runs[0]["rounds"] == runs[1]["rounds"]
    # rank 0 admitted the late requests on rank 1's clock, long before its
    # own reached them
    assert sorted(runs[0]["admit_rounds"]) == list(range(len(_PLENS)))
    assert runs[0]["wall_s"] < _LATE


@pytest.mark.parametrize("budget", [None, _SMALL_BUDGET],
                         ids=["stationary", "fallbacks"])
@pytest.mark.parametrize("spec", [False, True], ids=["sequential", "spec"])
def test_chip_smokes_prediction_counts_the_ranks_calls(spec, budget,
                                                       tmp_path_factory):
    """``launch.dryrun.continuous_sharded_prediction`` (``chip_smoke.py``
    phase 14's) at the
    reduced width: the calls of each kernel entry and the collectives of
    a rank's run and of a step or round alone == the prediction from the
    one-rank run's prefill calls and the rank's own steps and rounds;
    under the small stripe budget too, where B1 and B1's partials take the
    calls that the full width's stripes do not admit."""
    from repro_torch.launch.dryrun import continuous_sharded_prediction
    from repro_torch.launch.serve import bucket_for
    calls = {}
    restore = _count_calls(calls)       # in this process: the one-rank run
    try:
        one = _counted(None, calls, False, budget)
    finally:
        restore()
    k, draft = _COUNT_SPEC
    cfg = _cfg(schedule="activation",
               **({"draft_layers": draft} if spec else {}))
    buckets = [bucket_for(n, _BUCKETS, block=32) for n in _PLENS]
    res = _run((1, 2), tmp_path_factory)
    for out in res:
        got = out[("count", "spec" if spec else "seq", budget)]
        assert got["tokens"] == one["tokens"]
        ref = {n: one["run_launches"].get(n, 0) for n in LAUNCHES}
        with _budget(budget):
            want = continuous_sharded_prediction(
                cfg, ref, one["steps"], buckets, got["steps"],
                got["rounds"], model=2, slots=3, spec_k=k if spec else 0,
                staged=False)
        if budget is not None:      # the fallbacks really were taken
            assert want["run_launches"]["mgs_matmul_exact_fused"] > 0
            assert want["run_launches"]["mgs_matmul_exact_partials"] > 0
        for part in ("run", "step"):
            launches = {n: v for n, v in want[f"{part}_launches"].items()
                        if v}
            assert got[f"{part}_launches"] == launches, part
            assert {n: got[f"{part}_comm"][n]
                    for n in want[f"{part}_comm"]} == want[f"{part}_comm"], \
                part


def test_feed_on_a_mesh_names_the_next_slice(tmp_path_factory):
    for out in _run((1, 2), tmp_path_factory):
        assert "A12.2c" in out[("feed", None)]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [[], ["--spec-k", "2", "--draft-layers",
                                       "1"]], ids=["sequential", "spec_k2"])
def test_cli_mesh_continuous_serves_the_one_rank_tokens(capsys, spec):
    args = ["--arch", "deepseek-7b", "--reduced", "--batch", "2",
            "--n-requests", "3", "--prompt-len", "8", "--max-new", "3",
            "--continuous", "--quant", "fp8-mgs-serve-paged",
            "--device", "cpu"]
    serve_main(args)
    one = capsys.readouterr().out.splitlines()
    serve_main(args + spec + ["--mesh", "1x2"])
    two = capsys.readouterr().out.splitlines()
    assert "'mesh': '1x2'" in two[0]
    assert two[1:] == one[1:]
