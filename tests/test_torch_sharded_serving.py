"""Sharded serving of the port on the CPU: gloo ranks that meet through a
``FileStore`` under ``tmp_path`` (``parallel.comm.launch``), each spawn
under a deadline, torch pinned to one thread in the parent and every rank.

* B1's partials / flush twins over any cut of K == one call, bitwise (and
  the reference's fused Pallas kernel in interpret mode at one shape);
* on meshes 1x2, 1x4, 2x2: column- and K-sharded exact matmuls (flush
  periods 1-4, K cut at offsets that are no multiple of 32) bitwise the
  one-rank product; each rank's planes are the reference's one-device
  planes sliced by the spec; flushing per rank and adding float32 outputs
  (a planted fault) is not;
* reduced deepseek-7b: prefill logits and greedy tokens bitwise its 1x1
  engine's on 1x2, 2x2 (the cache's sequence cut over data) and 1x8 (the
  heads replicated); preparing once: ``PREP_STATS`` flat through a run and
  a rebuild;
* reduced granite-moe-1b-a400m at top_k 3: bitwise on 1x2 (experts over
  model) and 1x4 (the kv heads replicated);
* the CLI: ``--mesh 1x2 --device cpu`` serves the 1x1 tokens, and what
  stays unported raises naming A12.2c (the continuous engine on a mesh:
  ``tests/test_torch_continuous_sharded.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rf  # noqa: E402
from repro.kernels.mgs_matmul import mgs_matmul_exact_fused_pallas  # noqa: E402
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402
from repro.quant import prepare_weight as ref_prepare_weight  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.formats import E4M3, encode_bits, round_to_format  # noqa: E402
from repro_torch.kernels.mgs_matmul import (  # noqa: E402
    mgs_matmul_exact_flush, mgs_matmul_exact_fused_plain,
    mgs_matmul_exact_partials, partial_segments)
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.quant import FP8_MGS_SERVE_KV  # noqa: E402

TIMEOUT = 240.0


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
# B1's two new entries, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fp", [1, 2, 3, 4, None])
@pytest.mark.parametrize("cuts", [(0,), (0, 77), (0, 13, 150), (0, 31, 33)])
def test_partials_over_any_cut_flush_to_one_call(cuts, fp):
    x, w = _codes((2, 5, 300), 0), _codes((2, 300, 24), 1)
    scale = torch.rand((2, 1, 24), generator=torch.Generator().manual_seed(2))
    one = mgs_matmul_exact_fused_plain(x, w, E4M3, scale=scale,
                                       activation="silu", block_k=32,
                                       flush_period=fp)
    edges = list(cuts) + [300]
    part = sum(mgs_matmul_exact_partials(
        x[..., a:b], w[:, a:b], E4M3, block_k=32, flush_period=fp,
        k_offset=a, k_total=300) for a, b in zip(edges[:-1], edges[1:]))
    _, nseg = partial_segments(300, 32, fp)
    assert part.shape == (nseg, 5, 2, 5, 24) and part.dtype == torch.int32
    got = mgs_matmul_exact_flush(part, E4M3, scale=scale, activation="silu")
    assert torch.equal(got, one)


def test_partials_equal_the_references_fused_kernel():
    x, w = _codes((8, 200), 3), _codes((200, 16), 4)
    part = (mgs_matmul_exact_partials(x[:, :70], w[:70], E4M3, block_k=32,
                                      flush_period=2, k_total=200)
            + mgs_matmul_exact_partials(x[:, 70:], w[70:], E4M3, block_k=32,
                                        flush_period=2, k_offset=70,
                                        k_total=200))
    got = mgs_matmul_exact_flush(part, E4M3)[0]
    ref = np.asarray(mgs_matmul_exact_fused_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), rf.E4M3,
        block_m=8, block_n=8, block_k=32, flush_period=2, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_partials_refuse_a_cut_outside_k():
    x, w = _codes((4, 40), 5), _codes((40, 8), 6)
    with pytest.raises(ValueError, match="outside"):
        mgs_matmul_exact_partials(x, w, E4M3, k_offset=10, k_total=45)


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------

_QC = FP8_MGS_SERVE_KV.replace(block_k=32)


def _weights():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (6, 200)).astype(np.float32)
    col = rng.normal(0, 0.1, (200, 8, 16)).astype(np.float32)  # embed->heads
    kdim = rng.normal(0, 0.1, (200, 64)).astype(np.float32)    # ffn->embed
    return x, col, kdim


def _matmuls(mesh):
    """Column- and K-sharded products on ``mesh`` (whole outputs), the
    rank's planes, the planted per-rank-flush fault."""
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.quant import prepare_weight, qeinsum
    rules = make_rules(mesh, "serve", shard_batch=False)
    x, col, kdim = (torch.from_numpy(a) for a in _weights())
    out = {"planes": {}, "mm": {}}
    pws = {"col": prepare_weight(col, _QC, dims=("embed", "heads",
                                                 "head_dim"), rules=rules),
           "k": prepare_weight(kdim, _QC, dims=("ffn", "embed"),
                               rules=rules)}
    for name, pw in pws.items():
        out["planes"][name] = (pw.codes.numpy(), pw.scale.numpy(),
                               None if pw.layout is None else
                               pw.layout.spec, pw.limb_sigma)
    for fp in (1, 2, 3, 4):
        out["mm"][("col", fp)] = qeinsum(
            "mk,knh->mnh", x, pws["col"], _QC, flush_period=fp).numpy()
        out["mm"][("k", fp)] = qeinsum("mk,kn->mn", x, pws["k"], _QC,
                                       flush_period=fp).numpy()
        # x already cut to this rank's K range: the scale's max all-reduce
        lay = pws["k"].layout
        if lay is not None and lay.k_axes:
            a, b = lay.range(-2)
            out["mm"][("k_local", fp)] = qeinsum(
                "mk,kn->mn", x[:, a:b], pws["k"], _QC,
                flush_period=fp).numpy()
    # B4 (limb planes, no fused epilogue) on a K-sharded plane: refused
    from repro_torch.quant import FP8_MGS_EXACT
    b4 = FP8_MGS_EXACT.replace(use_kernel=True, block_k=32)
    try:
        qeinsum("mk,kn->mn", x, prepare_weight(
            kdim, b4, dims=("ffn", "embed"), rules=rules), b4)
        out["refusal"] = None
    except NotImplementedError as e:
        out["refusal"] = str(e)
    # the planted fault: each rank flushes its own K range, the float32
    # outputs are added
    lay = pws["k"].layout
    if lay is not None and lay.k_axes:
        from repro_torch.quant.quantize import quantize_fp8
        a, b = lay.range(-2)
        qx = quantize_fp8(x, E4M3)
        local = mgs_matmul_exact_fused_plain(
            encode_bits(qx.q[:, a:b], E4M3), pws["k"].codes, E4M3,
            scale=qx.scale * pws["k"].scale, block_k=32, flush_period=1)
        local = mesh.all_reduce(local, "sum", lay.k_axes)
        if lay.n_axes:
            local = mesh.all_gather(local, 1, lay.n_axes)
        out["fault"] = local.numpy()
    return out


def _engine_logits(cfg, mesh, params=None):
    eng = ServeEngine(cfg, batch=2, max_len=24, device="cpu", mesh=mesh,
                      params=params)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 8).astype(
        np.int32), max_new_tokens=4) for i in range(4)]
    eng.run(reqs)
    toks = np.stack([reqs[0].prompt, reqs[1].prompt]).astype(np.int64)
    cache = eng._init_cache(2)
    logits, _ = eng._prefill(toks, cache, eng._calib_state)
    return eng, logits.numpy(), [r.out_tokens for r in reqs]


def _dense_cfg():
    return dataclasses.replace(reduced_config("deepseek-7b"), quant=_QC)


def _moe_cfg():
    return dataclasses.replace(reduced_config("granite-moe-1b-a400m"),
                               top_k=3, quant=_QC)


def _rank(rank, shape, jobs):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.comm import COMM_STATS
    from repro_torch.quant import PREP_STATS
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coord": mesh.coord}
    if "matmul" in jobs:
        out["matmul"] = _matmuls(mesh)
    if "dense" in jobs:
        params = init_params(_dense_cfg(), 0)
        eng, lg, toks = _engine_logits(_dense_cfg(), mesh, params)
        out["dense"] = (lg, toks)
        out["kv_seq"] = eng._init_cache(2).get("kv_seq") is not None
        out["wq_sharded"] = eng.params["layers"]["attn"]["wq"].layout \
            is not None and bool(eng.params["layers"]["attn"]["wq"]
                                 .layout.n_axes)
        # preparing once: a run and a rebuild on the same params build
        # nothing
        n0 = PREP_STATS["prepared"]
        eng.run([Request(rid=9, prompt=np.arange(1, 9, dtype=np.int32),
                         max_new_tokens=3)])
        n1 = PREP_STATS["prepared"]
        ServeEngine(_dense_cfg(), batch=2, max_len=24, device="cpu",
                    mesh=mesh, params=params)
        out["prep"] = (n1 - n0, PREP_STATS["prepared"] - n1,
                       PREP_STATS["cache_hits"])
    if "moe" in jobs:
        _, lg, toks = _engine_logits(_moe_cfg(), mesh)
        out["moe"] = (lg, toks)
    out["comm"] = dict(COMM_STATS)
    return out


JOBS = {(1, 2): ("matmul", "dense", "moe"), (1, 4): ("matmul", "moe"),
        (2, 2): ("matmul", "dense"), (1, 8): ("dense",)}
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
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"matmul": _matmuls(mesh)}
    _, lg, toks = _engine_logits(_dense_cfg(), None)
    out["dense"] = (lg, toks)
    _, lg, toks = _engine_logits(_moe_cfg(), None)
    out["moe"] = (lg, toks)
    return out


MATMUL_MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_column_and_k_sharded_matmuls_are_bitwise_one_rank(
        shape, one_rank, tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    want = one_rank["matmul"]["mm"]
    for r, out in enumerate(res):
        got = out["matmul"]["mm"]
        for key, val in got.items():
            base = ("k", key[1]) if key[0] == "k_local" else key
            np.testing.assert_array_equal(val, want[base],
                                          err_msg=f"rank {r} {key}")
        # the K-sharded plane really was cut, and x cut to the rank's K
        # range took the same path
        assert got.get(("k_local", 1)) is not None


@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_a_ranks_planes_are_the_references_sliced_by_the_spec(
        shape, tmp_path_factory):
    from repro_torch.parallel.sharding import (MeshShape, local_slices,
                                               make_rules, prepared_specs)
    res = _run(shape, tmp_path_factory)
    _, col, kdim = _weights()
    rqc = RefQuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                         use_kernel=True, fused=True)
    rules = make_rules(MeshShape(("data", "model"), shape), "serve")
    for name, w, dims in (("col", col, ("embed", "heads", "head_dim")),
                          ("k", kdim, ("ffn", "embed"))):
        ref = ref_prepare_weight(jnp.asarray(w), rqc)
        codes = np.asarray(ref.codes)
        spec = prepared_specs(dims, w.shape, rules)[0]
        n = codes.shape[-1]
        for out in res:
            got_codes, got_scale, got_spec, _ = out["matmul"]["planes"][name]
            assert got_spec == spec

            class _M:   # the rank's coordinate on a plain mesh record
                shape = rules.mesh.shape
                coord = out["coord"]
            sl = local_slices(spec, (w.shape[0], n), _M)
            np.testing.assert_array_equal(got_codes, codes[sl])
            np.testing.assert_array_equal(got_scale, np.asarray(ref.scale))
        sigmas = {out["matmul"]["planes"][name][3] for out in res}
        assert len(sigmas) == 1     # the whole weight's, on every rank


@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_flushing_per_rank_then_adding_floats_is_caught(
        shape, one_rank, tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    want = one_rank["matmul"]["mm"][("k", 1)]
    faults = [out["matmul"]["fault"] for out in res
              if "fault" in out["matmul"]]
    assert faults
    for fault in faults:
        assert fault.shape == want.shape
        assert not np.array_equal(fault, want)


@pytest.mark.parametrize("shape", MATMUL_MESHES,
                         ids=["x".join(map(str, m)) for m in MATMUL_MESHES])
def test_a_k_sharded_plane_off_b1_names_the_next_slice(shape,
                                                       tmp_path_factory):
    for out in _run(shape, tmp_path_factory):
        assert "A12.2c" in out["matmul"]["refusal"]


ENGINE_MESHES = [(1, 2), (2, 2), (1, 8)]


@pytest.mark.parametrize("shape", ENGINE_MESHES,
                         ids=["x".join(map(str, m)) for m in ENGINE_MESHES])
def test_reduced_deepseek_is_bitwise_its_one_rank_engine(
        shape, one_rank, tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    lg, toks = one_rank["dense"]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["dense"][0], lg,
                                      err_msg=f"rank {r}")
        assert out["dense"][1] == toks
    # 2x2 cuts the cache's sequence over data; 1x8 replicates the 4 heads
    assert res[0]["kv_seq"] == (shape == (2, 2))
    assert res[0]["wq_sharded"] == (shape != (1, 8))
    assert res[0]["comm"]["calls"] > 0


def test_a_mesh_prepares_once(tmp_path_factory):
    res = _run((1, 2), tmp_path_factory)
    for out in res:
        run_builds, rebuild_builds, hits = out["prep"]
        assert (run_builds, rebuild_builds) == (0, 0)
        assert hits > 0


MOE_MESHES = [(1, 2), (1, 4)]


@pytest.mark.parametrize("shape", MOE_MESHES,
                         ids=["x".join(map(str, m)) for m in MOE_MESHES])
def test_reduced_granite_moe_top3_is_bitwise_its_one_rank_engine(
        shape, one_rank, tmp_path_factory):
    res = _run(shape, tmp_path_factory)
    lg, toks = one_rank["moe"]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["moe"][0], lg, err_msg=f"rank {r}")
        assert out["moe"][1] == toks


# ---------------------------------------------------------------------------
# the launcher, the backends, the CLI
# ---------------------------------------------------------------------------


def _sleeper(rank):
    import time
    time.sleep(60)


def _raiser(rank):
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    import torch.distributed as dist
    dist.barrier()


def test_the_launcher_stops_ranks_past_the_deadline(tmp_path):
    with pytest.raises(TimeoutError, match="not done within"):
        comm.launch(_sleeper, 2, timeout=5.0, store_dir=str(tmp_path))


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure"):
        comm.launch(_raiser, 2, timeout=60.0, store_dir=str(tmp_path))


def test_backends_never_fall_back(monkeypatch):
    assert comm.plan_ranks("cpu", 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share_device"):
        comm.plan_ranks("cuda", 2)
    backend, devs = comm.plan_ranks("cuda", 2, share_device=True)
    assert backend == "gloo" and len(set(devs)) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    backend, devs = comm.plan_ranks("cuda", 2)
    assert backend == "nccl" and len(set(devs)) == 2


def test_a_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_mesh, make_serve_mesh
    with pytest.raises(RuntimeError, match="launch"):
        make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="does not divide"):
        make_serve_mesh(model_parallel=3)
    assert make_serve_mesh().size == 1


def test_cli_mesh_serves_the_one_rank_tokens(capsys):
    args = ["--arch", "deepseek-7b", "--reduced", "--batch", "2",
            "--n-requests", "3", "--prompt-len", "8", "--max-new", "3",
            "--quant", "fp8-mgs-serve-kv", "--device", "cpu"]
    serve_main(args)
    one = capsys.readouterr().out.splitlines()
    serve_main(args + ["--mesh", "1x2"])
    two = capsys.readouterr().out.splitlines()
    assert "'mesh': '1x2'" in two[0]
    assert two[1:] == one[1:]


@pytest.mark.parametrize("flags", [
    ["--mesh", "1x2", "--no-deterministic"],
    ["--mesh", "1x2", "--arch", "falcon-mamba-7b", "--quant",
     "fp8-mgs-serve-kv"],
    ["--mesh", "1x2"],                       # unquantized: raw weights
    ["--mesh", "1x2", "--replicas", "2", "--quant", "fp8-mgs-serve-kv"]],
    ids=["no-deterministic", "ssm", "unquantized", "replicas"])
def test_cli_refusals_name_the_next_slice(capsys, flags):
    with pytest.raises(SystemExit):
        serve_main(["--reduced", "--device", "cpu"] + flags)
    assert "A12.2c" in capsys.readouterr().err


def test_engine_refusals_name_the_next_slice():
    from repro_torch.launch.mesh import carve_submeshes, virtual_devices
    from repro_torch.launch.serve import make_engine
    from repro_torch.parallel.sharding import MeshShape
    from repro_torch.quant.calibrate import CalibrationTable

    class _Two(MeshShape):
        size = 2
        device = torch.device("cpu")
    mesh = _Two(("data", "model"), (1, 2))
    paged = dataclasses.replace(_dense_cfg(),
                                quant=_QC.replace(per_row_act=True))
    with pytest.raises(NotImplementedError, match="A12.2c"):
        make_engine(paged, batch=2, max_len=16, device="cpu", mesh=mesh,
                    continuous=True,
                    calibration=CalibrationTable({"ffn.wd": 10.0}))
    ssm = dataclasses.replace(reduced_config("falcon-mamba-7b"), quant=_QC)
    with pytest.raises(NotImplementedError, match="A12.2c"):
        ServeEngine(ssm, batch=2, max_len=16, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="A12.2c"):
        carve_submeshes(1, model_parallel=2,
                        devices=virtual_devices("cpu", 2))
