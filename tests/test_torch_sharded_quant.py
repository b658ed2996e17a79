"""The paper's numerics on a mesh of ranks, on the CPU: gloo ranks that meet
through a ``FileStore`` under ``tmp_path`` (``parallel.comm.launch``), each
spawn under a deadline, torch pinned to one thread in the parent and every
rank.

* B5's partials and combine twins over cuts of K at offsets that are no
  multiple of its 128-code K tile == one call of its twin, bitwise (E4M3,
  E5M2, E3M4, the gate on and off); a bin whose int32 sum wraps combines as
  the one call's wrapped bin; B4's partials twin over any cut, flushed ==
  one B4 twin call == B1's twin;
* ``qmatmul`` (through ``qeinsum``) on 1x2, 2x2 and 1x8 under each of the
  reference's configurations, over a weight cut along N and one cut along
  K (``x`` whole, and ``x`` already this rank's K range): bitwise one rank
  where the sums are exact (B1, B4 and B5 with and without ``use_kernel``,
  the integer sums, fp8 ``swamp`` and int ``clip`` / ``wrap`` over gathered
  operands), within the whole-model bar where they are float (``none``,
  ``FP8_WIDE``); bins combined per rank and added as floats (a planted
  fault) are not the one-rank bits;
* reduced deepseek-7b and granite-moe-1b-a400m served by the group engine
  on 1x2 and 2x2 under the unquantized model and configurations (a)-(e)
  against the 1x1 engine by the same rule (logits of a prefill and every
  greedy token);
* the continuous engine on 1x2 under ``FP8_MGS_SERVE_PAGED`` with B4
  (``fused=False``): bitwise its one-rank engine. With B5
  (``accum="mgs_dmac"``) there is no config to serve: the paged pool is the
  packed cache, which needs ``mgs_exact``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as r_reduced  # noqa: E402
from repro.core import formats as rf  # noqa: E402
from repro.kernels import mgs_matmul as rmm  # noqa: E402
from repro.models.transformer import init_cache as r_init_cache  # noqa: E402
from repro.models.transformer import prefill as r_prefill  # noqa: E402
from repro.quant import config as rqc  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.formats import (E3M4, E4M3, E5M2, decode_bits,  # noqa: E402
                                      encode_bits, round_to_format)
from repro_torch.core.mgs import _wrap32  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    ACTIVATIONS, limb_decompose, mgs_matmul_dmac_codes_plain,
    mgs_matmul_dmac_combine, mgs_matmul_dmac_combine_plain,
    mgs_matmul_dmac_partials, mgs_matmul_dmac_partials_plain,
    mgs_matmul_exact_flush,
    mgs_matmul_exact_fused_plain, mgs_matmul_exact_limb_partials,
    mgs_matmul_exact_limb_partials_plain, mgs_matmul_exact_plain)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.quant import config as qc  # noqa: E402

TIMEOUT = 300.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops in several processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(shape, seed, fmt=E4M3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 4
         * np.exp2(rng.integers(-6, 3, shape))).astype(np.float32)
    return encode_bits(round_to_format(torch.from_numpy(x), fmt), fmt)


def _whole_model_bar(got, want):
    """Greedy tokens equal, error within 5% (max) and 1% (mean) of the
    scale (``tests/test_torch_forward.py``'s bar)."""
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    assert err.max() <= 5e-2 * scale and err.mean() <= 1e-2 * scale, (
        err.max() / scale, err.mean() / scale)


# ---------------------------------------------------------------------------
# B5's and B4's new entries, in one process
# ---------------------------------------------------------------------------

CUTS = [(0,), (0, 77), (0, 129, 200), (0, 13, 150)]


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "no-gate"])
@pytest.mark.parametrize("fmt", [E4M3, E5M2, E3M4], ids=lambda f: f.name)
@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: "-".join(map(str, c)))
def test_b5_partials_over_any_cut_combine_to_one_call(cuts, fmt, gate):
    x, w = _codes((2, 5, 300), 0, fmt), _codes((2, 300, 24), 1, fmt)
    scale = torch.rand((2, 5, 1), generator=torch.Generator().manual_seed(2))
    one = mgs_matmul_dmac_codes_plain(x, w, fmt, gate) * scale
    edges = list(cuts) + [300]
    part = sum(mgs_matmul_dmac_partials(
        x[..., a:b], w[:, a:b], fmt, gate, k_offset=a, k_total=300)
        for a, b in zip(edges[:-1], edges[1:]))
    assert part.shape == (2, 5, 24, fmt.n_bins) and part.dtype == torch.int32
    assert torch.equal(mgs_matmul_dmac_combine(part, fmt, scale=scale), one)
    # the twins are what the wrappers run on a CPU tensor
    twin = sum(mgs_matmul_dmac_partials_plain(
        x[..., a:b], w[:, a:b], fmt, gate, k_offset=a, k_total=300)
        for a, b in zip(edges[:-1], edges[1:]))
    assert torch.equal(twin, part)
    assert torch.equal(mgs_matmul_dmac_combine_plain(twin, fmt, scale=scale),
                       one)


def test_b5_a_wrapped_bin_combines_as_the_one_calls():
    """Two cuts whose bins add past 2**31: the int32 sum wraps as the one
    call's 32-bit bins do, and the combine reads the wrapped value."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(2**30, 2**31 - 1, (1, 2, 3, 16),
                                      dtype=np.int64))
    b = torch.from_numpy(rng.integers(2**30, 2**31 - 1, (1, 2, 3, 16),
                                      dtype=np.int64))
    whole = a + b                              # the one call's exact sums
    assert (whole >= 2**31).all()
    summed = a.to(torch.int32) + b.to(torch.int32)
    assert torch.equal(summed.to(torch.int64), _wrap32(whole))
    assert torch.equal(mgs_matmul_dmac_combine(summed, E4M3),
                       mgs_matmul_dmac_combine_plain(
                           _wrap32(whole).to(torch.int32), E4M3))


def test_b5_partials_refuse_a_cut_outside_k():
    x, w = _codes((4, 40), 5), _codes((40, 8), 6)
    with pytest.raises(ValueError, match="outside"):
        mgs_matmul_dmac_partials(x, w, E4M3, k_offset=10, k_total=45)


@pytest.mark.parametrize("fp", [1, 4, None], ids=["fp1", "fp4", "fpNone"])
@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: "-".join(map(str, c)))
def test_b4_partials_over_any_cut_flush_to_one_call_and_b1(cuts, fp):
    x, w = _codes((2, 5, 300), 0), _codes((2, 300, 24), 1)
    xl = limb_decompose(decode_bits(x, E4M3)).movedim(0, 1)
    wl = limb_decompose(decode_bits(w, E4M3)).movedim(0, -3)
    one = mgs_matmul_exact_plain(xl, wl, E4M3, block_k=32, flush_period=fp)
    b1 = mgs_matmul_exact_fused_plain(x, w, E4M3, block_k=32,
                                      flush_period=fp)
    edges = list(cuts) + [300]
    kw = dict(block_k=32, flush_period=fp, k_total=300)
    part = sum(mgs_matmul_exact_limb_partials(
        xl[..., a:b], wl[..., a:b, :], E4M3, k_offset=a, **kw)
        for a, b in zip(edges[:-1], edges[1:]))
    twin = sum(mgs_matmul_exact_limb_partials_plain(
        xl[..., a:b], wl[..., a:b, :], E4M3, k_offset=a, **kw)
        for a, b in zip(edges[:-1], edges[1:]))
    assert torch.equal(part, twin)
    got = mgs_matmul_exact_flush(part, E4M3)
    assert torch.equal(got, one) and torch.equal(got, b1)


REF_CUT = (0, 77, 200)


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "no-gate"])
@pytest.mark.parametrize("fmt", [E4M3, E5M2, E3M4], ids=lambda f: f.name)
def test_b5_bins_summed_over_a_cut_and_combined_are_the_reference(fmt, gate):
    """The twins' bins over three pieces of K, summed as int32 and
    combined == the reference's dMAC Pallas kernel (interpret mode) over
    the whole K, on the same codes. At E5M2 the products stay in [2**-10,
    2**15), where the reference's ``exp2`` is exact (``test_torch_dmac``:
    below it the reference's rounding is not RNE)."""
    if fmt is E5M2:
        rng = np.random.default_rng(8)
        x, w = (encode_bits(torch.from_numpy(np.ldexp(
            rng.choice([-1.0, 1.0], s) * rng.integers(4, 8, s),
            rng.integers(-7, 5, s)).astype(np.float32)), fmt)
            for s in ((5, 300), (300, 24)))
    else:
        x, w = _codes((5, 300), 8, fmt), _codes((300, 24), 9, fmt)
    edges = list(REF_CUT) + [300]
    part = sum(mgs_matmul_dmac_partials_plain(
        x[:, a:b], w[a:b], fmt, gate, k_offset=a, k_total=300)
        for a, b in zip(edges[:-1], edges[1:]))
    got = mgs_matmul_dmac_combine_plain(part, fmt)[0]
    ref = np.asarray(rmm.mgs_matmul_dmac_pallas(
        jnp.asarray(decode_bits(x, fmt).numpy()),
        jnp.asarray(decode_bits(w, fmt).numpy()), rf.get_format(fmt.name),
        gate, block_m=8, block_n=8, block_k=32, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fp", [1, 4, None], ids=["fp1", "fp4", "fpNone"])
def test_b4_partials_over_a_cut_flushed_are_the_reference(fp):
    """B4's partials twin over three pieces of K, summed and flushed ==
    the reference's exact Pallas kernel (interpret mode) over the whole K
    at the same block_k and flush period."""
    x, w = _codes((5, 300), 10), _codes((300, 24), 11)
    xv, wv = decode_bits(x, E4M3), decode_bits(w, E4M3)
    xl, wl = limb_decompose(xv), limb_decompose(wv)
    edges = list(REF_CUT) + [300]
    kw = dict(block_k=32, flush_period=fp, k_total=300)
    part = sum(mgs_matmul_exact_limb_partials_plain(
        xl[..., a:b], wl[..., a:b, :], E4M3, k_offset=a, **kw)
        for a, b in zip(edges[:-1], edges[1:]))
    got = mgs_matmul_exact_flush(part, E4M3)[0]
    ref = np.asarray(rmm.mgs_matmul_exact_pallas(
        jnp.asarray(xv.numpy()), jnp.asarray(wv.numpy()), rf.E4M3,
        block_m=8, block_n=8, block_k=32, flush_period=fp, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------

#: the reference's configurations: name -> (config, exact)
CONFIGS = {
    "none": (qc.NONE, False),
    "fp8_wide": (qc.FP8_WIDE, False),
    "fp8_mgs_b5": (qc.FP8_MGS.replace(use_kernel=True), True),
    "fp8_mgs_twin": (qc.FP8_MGS, True),
    "fp8_mgs_exact_b4": (qc.FP8_MGS_EXACT.replace(use_kernel=True,
                                                  block_k=32), True),
    "fp8_mgs_exact_twin": (qc.FP8_MGS_EXACT.replace(block_k=32), True),
    "fp8_mgs_serve": (qc.FP8_MGS_SERVE.replace(block_k=32), True),
    "int8_dmac": (qc.INT8_DMAC, True),
    "int8_wide": (qc.QuantConfig(dtype="int8", accum="wide"), True),
    "int8_clip_12": (qc.QuantConfig(dtype="int8", accum="clip",
                                    narrow_bits=12), True),
    "int8_wrap_12": (qc.QuantConfig(dtype="int8", accum="wrap",
                                    narrow_bits=12), True),
    "fp8_swamp": (qc.QuantConfig(dtype="fp8_e4m3", accum="swamp",
                                 narrow_bits=5), True),
    "int8_wide_per_row": (qc.QuantConfig(dtype="int8", accum="wide",
                                         per_row_act=True,
                                         per_channel=True), True),
    "fp8_mgs_b5_per_row": (qc.FP8_MGS.replace(use_kernel=True,
                                              per_row_act=True,
                                              per_channel=True), True),
}


def _weights():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (6, 200)).astype(np.float32)
    col = rng.normal(0, 0.1, (200, 8, 16)).astype(np.float32)  # embed->heads
    kdim = rng.normal(0, 0.1, (200, 64)).astype(np.float32)    # ffn->embed
    return x, col, kdim


def _sharded(w, dims, cfg, rules):
    """``w`` as the engine holds it on ``rules``' mesh: prepared planes
    under an MGS config, else a raw slice (or whole)."""
    from repro_torch.quant import prepare_weight, shard_raw_params
    if cfg.is_fp8 and cfg.accum in ("mgs_exact", "mgs_dmac"):
        return prepare_weight(w, cfg, dims=dims, rules=rules)
    return shard_raw_params({"ffn": {"wd": w}}, cfg,
                            dims={"ffn": {"wd": dims}}, rules=rules)[
        "ffn"]["wd"]


def _matmuls(mesh, names):
    """Per config: the column-cut and K-cut products (whole outputs), with
    x whole and x cut to this rank's K range."""
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.quant import qeinsum
    rules = make_rules(mesh, "serve", shard_batch=False)
    x, col, kdim = (torch.from_numpy(a) for a in _weights())
    out = {}
    for name in names:
        cfg = CONFIGS[name][0]
        wc = _sharded(col, ("embed", "heads", "head_dim"), cfg, rules)
        wk = _sharded(kdim, ("ffn", "embed"), cfg, rules)
        out[(name, "col")] = qeinsum("mk,knh->mnh", x, wc, cfg).numpy()
        out[(name, "k")] = qeinsum("mk,kn->mn", x, wk, cfg,
                                   activation="silu").numpy()
        lay = None if isinstance(wk, torch.Tensor) else wk.layout
        if lay is not None and lay.k_axes:
            a, b = lay.range(-2)
            out[(name, "k_local")] = qeinsum(
                "mk,kn->mn", x[:, a:b], wk, cfg, activation="silu").numpy()
    return out


def _planted(mesh):
    """B5's bins combined per rank, the float32 outputs added: the planted
    fault; and an int32 all-reduce of bins past 2**31 (it wraps)."""
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.quant import prepare_weight
    from repro_torch.quant.quantize import quantize_fp8
    rules = make_rules(mesh, "serve", shard_batch=False)
    cfg = CONFIGS["fp8_mgs_b5"][0]
    x, _, kdim = (torch.from_numpy(a) for a in _weights())
    wk = prepare_weight(kdim, cfg, dims=("ffn", "embed"), rules=rules)
    lay = wk.layout
    a, b = lay.range(-2)
    qx = quantize_fp8(x, E4M3, margin=cfg.fp8_margin)
    bins = mgs_matmul_dmac_partials(encode_bits(qx.q[:, a:b], E4M3),
                                    wk.codes, E4M3, k_offset=a, k_total=200)
    local = mgs_matmul_dmac_combine(bins, E4M3,
                                    scale=qx.scale * wk.scale)[0]
    parts = mesh.all_gather_parts(local, lay.k_axes)
    fault = parts[0]
    for p in parts[1:]:
        fault = fault + p
    if lay.n_axes:
        fault = mesh.all_gather(fault, 1, lay.n_axes)
    big = torch.full((3,), 2**31 - 5, dtype=torch.int32)
    n = int(np.prod([mesh.shape[a] for a in lay.k_axes]))
    return (fault.numpy(), mesh.all_reduce(big, "sum", lay.k_axes).numpy(),
            n)


def _np_params(tree):
    """A parameter tree as numpy float32 (the reference's input)."""
    if isinstance(tree, dict):
        return {k: _np_params(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32).numpy()


ENGINE_LEN = 24


def _engine_logits(cfg, mesh, params=None):
    from repro_torch.launch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, batch=2, max_len=ENGINE_LEN, device="cpu",
                      mesh=mesh, params=params)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 8).astype(
        np.int32), max_new_tokens=4) for i in range(4)]
    eng.run(reqs)
    toks = np.stack([reqs[0].prompt, reqs[1].prompt]).astype(np.int64)
    logits, _ = eng._prefill(toks, eng._init_cache(2), eng._calib_state)
    return logits.numpy(), [r.out_tokens for r in reqs]


#: the paper phase's configurations (``chip_smoke.paper_configs``), at the
#: reduced models' block_k
def _paper_quant(key):
    q = {"none": qc.NONE, "a": qc.FP8_MGS.replace(use_kernel=True),
         "b": qc.FP8_MGS_EXACT.replace(use_kernel=True),
         "c": qc.FP8_WIDE, "d": qc.FP8_MGS_SERVE, "e": qc.INT8_DMAC}[key]
    return q.replace(block_k=32)


#: the reference's float configurations of ``_paper_quant``
REF_FLOAT = {"none": rqc.NONE, "c": rqc.FP8_WIDE.replace(block_k=32)}


def _f32_cfg(key):
    """Reduced deepseek-7b under ``key`` computing in float32, where the
    port's one-device forward meets the reference's
    (``tests/test_torch_forward.py`` holds the quantized modes there)."""
    return dataclasses.replace(_model_cfg("deepseek-7b", key),
                               compute_dtype="float32",
                               param_dtype="float32")


PAPER = ("none", "a", "b", "c", "d", "e")
EXACT_PAPER = ("a", "b", "d", "e")


def _model_cfg(arch, key):
    cfg = reduced_config(arch)
    if arch == "granite-moe-1b-a400m":
        cfg = dataclasses.replace(cfg, top_k=3)
    return dataclasses.replace(cfg, quant=_paper_quant(key))


#: the continuous engine on a mesh: B4 (``fused=False``) over the paged
#: pool, which its one-device form takes
CONTINUOUS_QUANT = qc.FP8_MGS_SERVE_PAGED.replace(fused=False, block_k=32)


def _continuous(mesh):
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request
    cfg = dataclasses.replace(reduced_config("deepseek-7b"),
                              quant=CONTINUOUS_QUANT)
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, device="cpu",
                                   mesh=mesh)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 5 + i).astype(
        np.int32), max_new_tokens=4) for i in range(3)]
    logits = eng.serve(reqs, record_logits=True)["logits"]
    return ([r.out_tokens for r in reqs],
            {r.rid: np.stack(logits[r.rid]) for r in reqs})


#: the K-cut entries ``quant.qmatmul`` calls (kernel wrappers and twins)
ENTRIES = ("mgs_matmul_exact_partials", "mgs_matmul_exact_limb_partials",
           "mgs_matmul_exact_limb_partials_plain", "mgs_matmul_exact_flush",
           "mgs_matmul_exact_flush_plain", "mgs_matmul_dmac_partials",
           "mgs_matmul_dmac_partials_plain", "mgs_matmul_dmac_combine",
           "mgs_matmul_dmac_combine_plain")


def _count_entries():
    """Count ``quant.qmatmul``'s calls of each K-cut entry (a CPU tensor
    runs the twin and counts no launch)."""
    import importlib
    qm = importlib.import_module("repro_torch.quant.qmatmul")
    calls = dict.fromkeys(ENTRIES, 0)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    for name in ENTRIES:
        setattr(qm, name, counted(name, getattr(qm, name)))
    return calls


def _rank(rank, shape, jobs):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    mesh = make_mesh(shape, ("data", "model"))
    calls = _count_entries()
    out = {}
    if "matmul" in jobs:
        out["matmul"] = _matmuls(mesh, list(CONFIGS))
        out["planted"] = _planted(mesh)
    for arch in jobs.get("engines", ()):
        params = init_params(_model_cfg(arch, "none"), 0)
        for key in PAPER:
            for k in calls:
                calls[k] = 0
            out[(arch, key)] = _engine_logits(_model_cfg(arch, key), mesh,
                                              params)
            out[("calls", arch, key)] = {k: v for k, v in calls.items()
                                         if v}
    if jobs.get("reference"):
        params = init_params(_model_cfg("deepseek-7b", "none"), 0)
        for key in REF_FLOAT:
            out[("reference", key)] = _engine_logits(
                _f32_cfg(key), mesh, params)[0]
    if "continuous" in jobs:
        out["continuous"] = _continuous(mesh)
        out[("calls", "continuous")] = {k: v for k, v in calls.items() if v}
    return out


ARCHS = ("deepseek-7b", "granite-moe-1b-a400m")
JOBS = {(1, 2): {"matmul": True, "engines": ARCHS, "continuous": True,
                "reference": True},
        (2, 2): {"matmul": True, "engines": ARCHS, "reference": True},
        (1, 8): {"matmul": True}}
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
    """The 1x1 products and engines, in this process."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"matmul": _matmuls(mesh, list(CONFIGS))}
    for arch in ARCHS:
        params = init_params(_model_cfg(arch, "none"), 0)
        for key in PAPER:
            out[(arch, key)] = _engine_logits(_model_cfg(arch, key), None,
                                              params)
    out["continuous"] = _continuous(None)
    return out


MATMUL_MESHES = [(1, 2), (2, 2), (1, 8)]


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_qmatmul_on_a_mesh_is_one_rank(shape, name, one_rank,
                                       tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    exact = CONFIGS[name][1]
    want = one_rank["matmul"]
    for r, out in enumerate(res):
        got = {k: v for k, v in out["matmul"].items() if k[0] == name}
        # the K-cut weight really was cut, and x cut to the rank's K range
        # took the same path
        assert (name, "k_local") in got
        for key, val in got.items():
            base = want[(name, "k" if key[1] == "k_local" else key[1])]
            if exact:
                np.testing.assert_array_equal(val, base,
                                              err_msg=f"rank {r} {key}")
            else:
                _whole_model_bar(val, base)


@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_combining_bins_per_rank_then_adding_floats_is_caught(
        shape, one_rank, tmp_path_factory):
    want = one_rank["matmul"][("fp8_mgs_b5", "k")]
    for out in _run(shape, tmp_path_factory):
        fault, wrapped, n = out["planted"]
        assert fault.shape == want.shape and n > 1
        # the one-rank product ends in the silu epilogue
        assert not np.array_equal(
            ACTIVATIONS["silu"](torch.from_numpy(fault)).numpy(), want)
        # the int32 all-reduce of the bins wraps as the kernel's bins do
        assert (wrapped == _wrap32(torch.tensor(n * (2**31 - 5))).item()
                ).all()


ENGINE_MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("key", PAPER)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ENGINE_MESHES,
                         ids=["x".join(map(str, m)) for m in ENGINE_MESHES])
def test_group_engine_on_a_mesh_serves_every_config(shape, arch, key,
                                                    one_rank,
                                                    tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    lg, toks = one_rank[(arch, key)]
    for r, out in enumerate(res):
        got_lg, got_toks = out[(arch, key)]
        assert got_toks == toks, f"rank {r}"
        if key in EXACT_PAPER:
            np.testing.assert_array_equal(got_lg, lg, err_msg=f"rank {r}")
        else:
            _whole_model_bar(got_lg, lg)
    # the path went through the new entries where the mesh cuts a K (on
    # 1x2 granite's experts take the model axis: no K is cut)
    calls = res[0][("calls", arch, key)]
    if (arch, shape) == ("granite-moe-1b-a400m", (1, 2)):
        assert calls == {}
        return
    want = {"a": ("mgs_matmul_dmac_partials", "mgs_matmul_dmac_combine"),
            "b": ("mgs_matmul_exact_limb_partials", "mgs_matmul_exact_flush"),
            "d": ("mgs_matmul_exact_partials", "mgs_matmul_exact_flush")}
    for name in want.get(key, ()):
        assert calls.get(name, 0) > 0, (name, calls)
    if key not in want:
        assert calls == {}


@pytest.mark.parametrize("key", list(REF_FLOAT))
@pytest.mark.parametrize("shape", ENGINE_MESHES,
                         ids=["x".join(map(str, m)) for m in ENGINE_MESHES])
def test_float_configs_on_a_mesh_hold_the_reference_bar(shape, key,
                                                       tmp_path_factory):
    """Reduced deepseek-7b's prefill logits on the mesh (the unquantized
    model and (c), ``FP8_WIDE``, computing in float32) against the
    reference's prefill of the same weights and prompts into a cache of
    the engine's length, within the whole-model bar: the mesh's bar
    against 1x1 and 1x1's against the reference do not stack. (In bfloat16
    the one-device engine itself is 1.2% of the scale off the reference
    on average under ``FP8_WIDE``: a bfloat16 ulp flips fp8 codes.)"""
    from repro_torch.models import init_params
    res = _run(shape, tmp_path_factory)
    cfg = _f32_cfg(key)
    params = _np_params(init_params(_model_cfg("deepseek-7b", "none"), 0))
    rng = np.random.default_rng(0)
    toks = np.stack([rng.integers(1, cfg.vocab, 8).astype(np.int32)
                     for _ in range(4)][:2])
    rcfg = dataclasses.replace(r_reduced("deepseek-7b"),
                               quant=REF_FLOAT[key],
                               compute_dtype="float32",
                               param_dtype="float32")
    cache, _ = r_init_cache(rcfg, 2, ENGINE_LEN)
    rl, _ = r_prefill(jax.tree.map(jnp.asarray, params), rcfg,
                      {"tokens": jnp.asarray(toks)}, cache)
    want = np.asarray(rl, np.float32)
    for r, out in enumerate(res):
        got = out[("reference", key)]
        assert got.shape == want.shape, f"rank {r}"
        _whole_model_bar(got, want)


def test_continuous_engine_on_a_mesh_serves_what_one_rank_takes(
        one_rank, tmp_path_factory):
    """B4 (``fused=False``) over the paged pool on 1x2: bitwise its
    one-rank engine. ``FP8_MGS_SERVE_PAGED.replace(accum="mgs_dmac")`` is
    no config at all: the paged pool is the packed cache, which the exact
    flash-decode kernel reads, and a packed cache needs ``mgs_exact``."""
    with pytest.raises(ValueError, match="mgs_exact"):
        qc.FP8_MGS_SERVE_PAGED.replace(accum="mgs_dmac")
    res = _run((1, 2), tmp_path_factory)
    toks, logits = one_rank["continuous"]
    for r, out in enumerate(res):
        got_toks, got_logits = out["continuous"]
        assert got_toks == toks, f"rank {r}"
        for rid, v in logits.items():
            np.testing.assert_array_equal(got_logits[rid], v,
                                          err_msg=f"rank {r} rid {rid}")
        assert out[("calls", "continuous")].get(
            "mgs_matmul_exact_limb_partials", 0) > 0
