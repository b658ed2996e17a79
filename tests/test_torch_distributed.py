"""Distributed training and elastic resharding of the port on the CPU:
gloo ranks that meet through a ``FileStore`` (``parallel.comm.launch``),
one spawn per mesh, each under a deadline, torch pinned to one thread in
the parent and in every rank.

* No ranks: ``opt_state_dims`` equals the reference's for every arch,
  factored and not; the train state's specs (``train_state_specs``) equal
  the reference's ``resolve_spec`` of its state dims entry for entry on
  deepseek-7b, granite-moe-1b-a400m and dbrx-132b, full and reduced, over
  six meshes; ``param_shapes`` is ``init_params``' shapes.
* Eight ranks: reduced deepseek-7b on 2x4 at the reference test's 4 x 16
  (batch over data: D = 2) and at 8 x 16 (batch over (data, model): D = 8)
  is bitwise the port's one-device ``grad_accum = D`` step (loss, aux,
  tokens, grad norm; every rank's slice of params and moments) and within
  ``tests/test_distributed.py``'s bars of the reference's single-device
  jitted step; a rank that updates from its own gradient alone fails the
  bitwise check; the compressed reduce on 8 ranks (the reference test's
  case, then per-rank gradients against the reference's quantizer); the
  first half of the elastic run on 4x2; each step's collectives ==
  ``launch.dryrun.train_sharded_prediction``.
* Four ranks: reduced dbrx-132b (MoE, factored moments, bf16 parameters)
  on 2x2 bitwise ``grad_accum = 4``; the reference's MoE dispatch case
  with parameters held by the train specs and gathered; the elastic run's
  second half on ``make_elastic_mesh(2, exclude=4 slots)`` == 2x2, bitwise
  the one-device run at ``grad_accum`` 8 then 4; the reference's (4,2) ->
  (2,2) checkpoint round trip; a stop request on one rank ends every
  rank after the same step.
* The CLI: ``--mesh 2x2 --device cpu --reduced --ckpt-dir`` with a rank
  that raises at step 3 (the rank function passed to ``launch``) recovers
  to the uninterrupted one-device run's bits.
"""

import dataclasses
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.common import ParamFactory  # noqa: E402
from repro.models.moe import moe_apply as ref_moe_apply  # noqa: E402
from repro.models.moe import moe_init as ref_moe_init  # noqa: E402
from repro.models.transformer import param_dims as ref_param_dims  # noqa: E402
from repro.parallel import sharding as rs  # noqa: E402
from repro.runtime import checkpoint as ref_ckpt  # noqa: E402
from repro.train import OptConfig as ROptConfig  # noqa: E402
from repro.train import init_train_state as r_init_train  # noqa: E402
from repro.train import make_train_step as r_make_train_step  # noqa: E402
from repro.train import opt_state_dims as ref_opt_state_dims  # noqa: E402
from repro.train.compression import _quantize_int8 as r_q8  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, main as train_main  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_dims, param_shapes  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.sharding import (MeshShape, local_slices,  # noqa: E402
                                           make_rules, train_rules)
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.train import (OptConfig, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.train.optimizer import opt_state_dims  # noqa: E402
from repro_torch.train.train_step import train_state_specs  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

TIMEOUT = 240.0
OPT = dict(lr=1e-2, warmup_steps=0, schedule="const")
# the elastic run: 2 steps on 4x2 (D = 8), then 2 on 2x2 (D = 4)
ELASTIC_OPT = dict(lr=3e-3, warmup_steps=1, total_steps=4)
ELASTIC_LOOP = dict(global_batch=8, seq_len=16, log_every=1, ckpt_every=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops in several processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    """A tensor's values as float32 numpy (exact for float32 / bfloat16)
    or int numpy."""
    t = t.detach().cpu()
    return (t.numpy() if not t.dtype.is_floating_point
            else t.to(torch.float32).numpy())


def _flat_np(tree):
    return {k: _np(v) for k, v in flatten_with_paths(tree).items()}


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _batch(cfg, B, T, seed=0):
    """The reference test's batch: tokens and labels from ``rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_mesh(shape, axes):
    """As ``tests/test_torch_sharding.py::_ref_mesh`` builds it."""
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


# ---------------------------------------------------------------------------
# no ranks: the state's dims and specs against the reference
# ---------------------------------------------------------------------------

_REF_SHAPES: dict = {}


def _ref_shapes(arch: str, reduced: bool):
    key = (arch, reduced)
    if key not in _REF_SHAPES:
        cfg = ref_reduced(arch) if reduced else ref_get_config(arch)
        tree = jax.eval_shape(lambda k: ref_init(cfg, k)[0],
                              jax.random.PRNGKey(0))
        _REF_SHAPES[key] = jax.tree.map(lambda a: tuple(a.shape), tree)
    return _REF_SHAPES[key]


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(s, int) for s in x)


def _ref_tuples(tree):
    """The reference's specs / dims tree with tuples for leaves."""
    if isinstance(tree, dict):
        return {k: _ref_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_dims_equal_the_reference(arch, factored):
    shapes = _ref_shapes(arch, True)
    rdims = ref_param_dims(ref_reduced(arch))
    sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                       shapes, is_leaf=_is_shape)
    want = ref_opt_state_dims(rdims, sds, factored)
    got = opt_state_dims(param_dims(reduced_config(arch)), shapes, factored)
    assert got == _ref_tuples(want)
    if factored:
        assert any(k.endswith("/row") for k in flatten_with_paths(got["nu"]))


STATE_MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                ((2, 2), ("data", "model")), ((1, 8), ("data", "model")),
                ((16, 16), ("data", "model")),
                ((2, 16, 16), ("pod", "data", "model"))]
STATE_MODELS = [(a, r) for a in ("deepseek-7b", "granite-moe-1b-a400m",
                                 "dbrx-132b") for r in (False, True)]


@pytest.mark.parametrize("shape,axes", STATE_MESHES,
                         ids=["x".join(map(str, m)) for m, _ in STATE_MESHES])
@pytest.mark.parametrize("arch,reduced", STATE_MODELS,
                         ids=[f"{a}{'-reduced' if r else ''}"
                              for a, r in STATE_MODELS])
def test_train_state_specs_equal_the_reference(arch, reduced, shape, axes):
    """The reference's ``_shardings``: ``resolve_spec({"params": dims,
    "opt": opt_state_dims(dims, shapes, factored)}, state shapes,
    train_rules(mesh))``."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    rcfg = ref_reduced(arch) if reduced else ref_get_config(arch)
    shapes = _ref_shapes(arch, reduced)
    factored = cfg.opt_factored
    assert param_shapes(cfg) == _ref_tuples(shapes)
    got = train_state_specs(cfg, train_rules(MeshShape(axes, shape)),
                            factored)
    rdims = ref_param_dims(rcfg)
    sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                       shapes, is_leaf=_is_shape)
    state_sds = jax.eval_shape(
        lambda: r_init_train(jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), sds), factored=factored))
    ref_dims = {"params": rdims,
                "opt": ref_opt_state_dims(rdims, state_sds["params"],
                                          factored)}
    want = rs.resolve_spec(ref_dims,
                           jax.tree.map(lambda s: s.shape, state_sds),
                           rs.train_rules(_ref_mesh(shape, axes),
                                          fsdp=rcfg.fsdp))
    assert got == _ref_tuples(want)
    # every leaf the reference shards is sharded here too
    if shape == (16, 16) and not reduced:
        assert any(s != () for s in flatten_with_paths(got).values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_are_init_params_shapes(arch):
    cfg = reduced_config(arch)
    assert param_shapes(cfg) == tree_map(lambda t: tuple(t.shape),
                                         init_params(cfg, 0))
    assert param_shapes(get_config(arch)) == _ref_tuples(
        _ref_shapes(arch, False))


# ---------------------------------------------------------------------------
# what the ranks run (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------


class _Recorder:
    """A stop handler that never stops and snapshots the collective
    counters at each poll (once a step), and stops from poll ``stop_at``
    when given."""

    def __init__(self, stop_at=None):
        self.polls, self.stop_at, self.snaps = 0, stop_at, [
            dict(comm.COMM_STATS)]

    @property
    def should_stop(self):
        self.polls += 1
        self.snaps.append(dict(comm.COMM_STATS))
        return self.stop_at is not None and self.polls >= self.stop_at

    def deltas(self):
        """Each step's collectives, with the previous step's stop flag
        (from the second step on)."""
        return [{k: b[k] - a[k] for k in a}
                for a, b in zip(self.snaps[1:], self.snaps[2:])]


def _mesh_steps(cfg, mesh, batch, n_steps, opt):
    """``n_steps`` mesh steps from ``init_params(cfg, 0)`` on ``batch``:
    (each step's metrics, this rank's state, the last step's
    collectives)."""
    from repro_torch.runtime.elastic import reshard
    specs = train_state_specs(cfg, train_rules(mesh), opt.factored)
    state = reshard(init_train_state(init_params(cfg, 0),
                                     factored=opt.factored), specs, mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
    ms = []
    for _ in range(n_steps):
        comm.reset_comm_stats()
        state, m = step(state, _tensors(batch))
        ms.append(_metrics(m))
    return ms, _flat_np(state), dict(comm.COMM_STATS)


def _rank8(rank, tmp):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.parallel.sharding import named_sharding
    from repro_torch.runtime.elastic import reshard
    from repro_torch.train import compression
    from repro_torch.train import train_step as ts
    out = {}
    cfg = reduced_config("deepseek-7b")
    opt = OptConfig(**OPT)
    mesh = make_mesh((2, 4), ("data", "model"))
    out["coord24"] = mesh.coord
    for name, B in (("d2", 4), ("d8", 8)):
        out[name] = _mesh_steps(cfg, mesh, _batch(cfg, B, 16), 2, opt)
    out["d2_first"] = _mesh_steps(cfg, mesh, _batch(cfg, 4, 16), 1, opt)[1]
    # the planted fault: each rank updates from its own gradient alone
    ordered_sum = ts._ordered_sum
    ts._ordered_sum = lambda local, axes, mesh, n: tree_map(
        lambda g: g.to(ts._acc_dtype(g)), local)
    out["fault"] = _mesh_steps(cfg, mesh, _batch(cfg, 4, 16), 1, opt)[1]
    ts._ordered_sum = ordered_sum

    # the compressed reduce on a mesh of 8 (the data axis)
    m8 = make_mesh((8,), ("data",))
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (32,)).astype(np.float32))}
    reduce_fn = compression.make_compressed_reduce(m8, ("data",))
    mean, err = reduce_fn(g, compression.init_error_state(g))
    out["same"] = (float((mean["w"] - g["w"]).abs().max()),
                   _np(err["w"]))
    gr = torch.from_numpy(np.random.default_rng(100 + rank).normal(
        0, 1, (5, 7)).astype(np.float32))
    er = torch.from_numpy(np.random.default_rng(200 + rank).normal(
        0, 0.01, (5, 7)).astype(np.float32))
    total, mscale, nrep, new_err = compression._compressed_parts(
        gr, er, ("data",), m8)
    mean_r, err_r = compression.compress_leaf_psum(gr, er, ("data",), m8)
    out["diff"] = dict(total=_np(total), mean_scale=float(mscale),
                       nrep=nrep, new_err=_np(new_err), mean=_np(mean_r),
                       err=_np(err_r))

    # the elastic run's first half on 4x2, and the round trip's save
    m42 = make_mesh((4, 2), ("data", "model"))
    out["coord42"] = m42.coord
    loop = TrainLoopConfig(steps=2, ckpt_dir=os.path.join(tmp, "elastic"),
                           **ELASTIC_LOOP)
    rec = _Recorder()
    res = train_loop(cfg, loop, device="cpu", mesh=m42,
                     opt_cfg=OptConfig(**ELASTIC_OPT), handler=rec)
    out["elastic_a"] = [dict(h) for h in res["history"]]
    out["elastic_a_comm"] = rec.deltas()
    tree = {"w": torch.arange(64.0).reshape(8, 8), "g": torch.arange(8.0)}
    r42 = make_rules(m42, "train")
    specs = {"w": r42.resolve(("embed", "ffn"), (8, 8)),
             "g": r42.resolve(("ffn",), (8,))}
    ckpt.save(os.path.join(tmp, "roundtrip"), 1, reshard(tree, specs, m42),
              shardings=named_sharding(specs, m42))
    return out


class _Never:
    should_stop = False


def _rank4(rank, tmp, moe_np, moe_dims, x_np):
    from repro_torch.launch.mesh import make_mesh, virtual_devices
    from repro_torch.launch.train import train_loop
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.sharding import named_sharding, replicate
    from repro_torch.runtime.elastic import make_elastic_mesh, reshard
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))
    out["coord"] = mesh.coord
    cfg = reduced_config("dbrx-132b")
    out["dbrx"] = _mesh_steps(cfg, mesh, _batch(cfg, 4, 16), 2,
                              OptConfig(**OPT, factored=True))

    # the reference's MoE dispatch case: parameters held by the train
    # specs, gathered whole, float32
    rules = train_rules(mesh)
    specs = {k: rules.resolve(d, moe_np[k].shape)
             for k, d in moe_dims.items()}
    local = reshard(moe_np, specs, mesh)
    whole = {k: replicate(local[k], specs[k], mesh) for k in local}
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              param_dtype="float32")
    y, aux = moe_apply(whole, torch.from_numpy(x_np), f32)
    out["moe"] = (_np(y), float(aux),
                  {k: tuple(v.shape) for k, v in local.items()}, specs)

    # the elastic run's second half: 4 of 8 slots excluded -> 2x2
    sub = make_elastic_mesh(2, devices=virtual_devices("cpu", 8),
                            exclude=(4, 5, 6, 7))
    out["elastic_mesh"] = (sub.shape, sub.ids)
    m22 = make_mesh(tuple(sub.shape.values()), sub.axis_names)
    cfg = reduced_config("deepseek-7b")
    loop = TrainLoopConfig(steps=4, ckpt_dir=os.path.join(tmp, "elastic"),
                           **ELASTIC_LOOP)
    res = train_loop(cfg, loop, device="cpu", mesh=m22,
                     opt_cfg=OptConfig(**ELASTIC_OPT), resume_step=2)
    out["elastic_b"] = ([dict(h) for h in res["history"]],
                        _flat_np(res["state"]))

    # the reference's round trip: saved on 4x2, restored onto 2x2
    r22 = make_rules(m22, "train")
    specs = {"w": r22.resolve(("embed", "ffn"), (8, 8)),
             "g": r22.resolve(("ffn",), (8,))}
    template = {"w": torch.empty(0), "g": torch.empty(0)}
    _, t2, _ = ckpt.restore(os.path.join(tmp, "roundtrip"), 1,
                            template=template,
                            shardings=named_sharding(specs, m22))
    out["roundtrip"] = ({k: _np(v) for k, v in t2.items()}, specs)

    # a stop request on rank 1 alone, after its second step
    loop = TrainLoopConfig(steps=4, global_batch=4, seq_len=8, log_every=1)
    res = train_loop(cfg, loop, device="cpu", mesh=m22,
                     opt_cfg=OptConfig(**OPT),
                     handler=_Recorder(stop_at=2) if rank == 1 else _Never())
    out["stop"] = (res["step"], len(res["history"]))
    return out


def _flaky_rank(rank, shape, cfg, loop, resume):
    """The CLI's rank with checkpoints every step; on the first attempt
    rank 1 raises at its step 3."""
    from repro_torch.launch import train as lt
    loop = dataclasses.replace(loop, ckpt_every=1)
    marker = loop.ckpt_dir + ".crashed"
    if rank == 1 and not os.path.exists(marker):
        make = lt.make_train_step

        def failing(*a, **kw):
            step_fn, calls = make(*a, **kw), [0]

            def step(state, batch):
                calls[0] += 1
                if calls[0] == 4:
                    open(marker, "w").close()
                    raise RuntimeError("planted rank failure at step 3")
                return step_fn(state, batch)
            return step
        lt.make_train_step = failing
    return lt._train_rank(rank, shape, cfg, loop, resume)


# ---------------------------------------------------------------------------
# the spawns (one per mesh) and the one-device runs they are held to
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("distributed"))


@pytest.fixture(scope="module")
def eight(shared_dir):
    return comm.launch(_rank8, 8, args=(shared_dir,), device="cpu",
                       threads=1, timeout=TIMEOUT, store_dir=shared_dir)


@pytest.fixture(scope="module")
def moe_case():
    """The reference test's MoE parameters and input (float32)."""
    rcfg = ref_reduced("dbrx-132b")
    f = ParamFactory(jax.random.PRNGKey(0), jnp.float32)
    ref_moe_init(f, rcfg)
    p, dims = f.collect()
    x = np.random.default_rng(0).normal(
        0, 1, (4, 16, rcfg.d_model)).astype(np.float32)
    y0, aux0 = ref_moe_apply(p, jnp.asarray(x), rcfg)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: tuple(d) for k, d in dims.items()}, x, np.asarray(y0),
            float(aux0))


@pytest.fixture(scope="module")
def four(eight, shared_dir, moe_case):
    moe_np, moe_dims, x, _, _ = moe_case
    return comm.launch(_rank4, 4, args=(shared_dir, moe_np, moe_dims, x),
                       device="cpu", threads=1, timeout=TIMEOUT,
                       store_dir=shared_dir)


def _one_device(cfg, batch, grad_accum, n_steps, opt):
    """The port's one-device steps: (metrics, whole state as numpy)."""
    state = init_train_state(init_params(cfg, 0), factored=opt.factored)
    step = make_train_step(cfg, opt, grad_accum=grad_accum)
    ms = []
    for _ in range(n_steps):
        state, m = step(state, _tensors(batch))
        ms.append(_metrics(m))
    return ms, _flat_np(state)


@pytest.fixture(scope="module")
def deepseek_one():
    cfg = reduced_config("deepseek-7b")
    return {name: _one_device(cfg, _batch(cfg, B, 16), B // 2 if B == 4
                              else 8, 2, OptConfig(**OPT))
            for name, B in (("d2", 4), ("d8", 8))}


def _specs(cfg, shape, factored=False):
    return flatten_with_paths(train_state_specs(
        cfg, train_rules(MeshShape(("data", "model"), shape)), factored))


def _local(whole, spec, coord, shape):
    mesh = SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           coord=coord)
    return whole[local_slices(spec, whole.shape, mesh)]


def _assert_slices_bitwise(results, key, want_state, specs, shape,
                           coord_key="coord24"):
    """Every rank holds exactly its slice of the one-device state."""
    for r, out in enumerate(results):
        got = out[key][1] if isinstance(out[key], tuple) else out[key]
        assert sorted(got) == sorted(want_state)
        for k, w in want_state.items():
            want = _local(w, specs[k], out[coord_key], shape)
            assert got[k].shape == want.shape, (r, k)
            np.testing.assert_array_equal(got[k], want, err_msg=f"{r} {k}")


# ---------------------------------------------------------------------------
# (1), (2): reduced deepseek-7b on 2x4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["d2", "d8"])
def test_mesh_step_is_bitwise_one_device_grad_accum(eight, deepseek_one,
                                                    name):
    cfg = reduced_config("deepseek-7b")
    want_ms, want_state = deepseek_one[name]
    for out in eight:
        assert out[name][0] == want_ms           # loss, aux, tokens, norm
    _assert_slices_bitwise(eight, name, want_state, _specs(cfg, (2, 4)),
                           (2, 4))


@pytest.mark.parametrize("name", ["d2", "d8"])
def test_no_gradient_is_cut_on_the_mesh(eight, deepseek_one, name):
    """A collective without autograd inside the forward would leave a leaf
    with no gradient on the mesh (``_grads_of`` fills it with zeros): the
    first moment after a step is (1 - b1) x the clipped gradient, so it
    is nonzero wherever one device's is."""
    cfg = reduced_config("deepseek-7b")
    _, want = deepseek_one[name]
    specs = _specs(cfg, (2, 4))
    for out in eight:
        for k in (k for k in want if k.startswith("opt/mu/")):
            mine = _local(want[k], specs[k], out["coord24"], (2, 4))
            if np.any(mine != 0):
                assert np.any(out[name][1][k] != 0), k


def test_batch_shards_follow_the_batch_spec():
    """B = 4 on 2x4 cuts the rows over data (D = 2, seq over model), B = 8
    over (data, model) (D = 8), B = 6 over data; B = 3 cuts nothing."""
    from repro_torch.train.train_step import batch_shards
    rules = train_rules(MeshShape(("data", "model"), (2, 4)))
    assert batch_shards(rules, 4, 16) == (("data",), 2)
    assert batch_shards(rules, 8, 16) == (("data", "model"), 8)
    assert batch_shards(rules, 6, 16) == (("data",), 2)
    assert batch_shards(rules, 3, 16) == ((), 1)
    ref = rs.train_rules(_ref_mesh((2, 4), ("data", "model")))
    assert tuple(ref.resolve(("batch", "seq"), (4, 16))) == \
        rules.resolve(("batch", "seq"), (4, 16)) == ("data", "model")


def test_mesh_step_is_within_the_reference_tests_bars(eight):
    """``tests/test_distributed.py::test_sharded_train_step_matches_single
    _device``'s bars, against the reference's single-device jitted step on
    the same parameters and batch (4 x 16)."""
    cfg = reduced_config("deepseek-7b")
    rcfg = ref_reduced("deepseek-7b")
    params = _flat_np(init_params(cfg, 0))
    np_tree = {}
    for k, v in params.items():
        node = np_tree
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    batch = _batch(cfg, 4, 16)
    s0, m0 = jax.jit(r_make_train_step(rcfg, ROptConfig(**OPT)))(
        r_init_train(jax.tree.map(jnp.asarray, np_tree)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    m1 = eight[0]["d2"][0][0]
    loss0, gn0 = float(m0["loss"]), float(m0["grad_norm"])
    assert abs(loss0 - m1["loss"]) < 5e-2 * max(1, loss0)
    assert abs(gn0 - m1["grad_norm"]) < 5e-2 * max(1.0, gn0)
    # the mesh's parameters after that step, put together from the ranks
    one = _mesh_steps_whole(eight, cfg)
    ref = {"/".join(str(p.key) for p in path): np.asarray(v, np.float32)
           for path, v in jax.tree_util.tree_flatten_with_path(
               s0["params"])[0]}
    wmax = max(float(np.abs(one["params/" + k] - w).max())
               for k, w in ref.items())
    assert wmax < 5e-2


def _mesh_steps_whole(eight, cfg):
    """The 2x4 mesh's parameters after its first 4 x 16 step (D = 2), put
    together from every rank's slices (each entry written by every rank
    holding it must agree)."""
    specs = _specs(cfg, (2, 4))
    shapes = flatten_with_paths(param_shapes(cfg))
    whole = {}
    for k, s in shapes.items():
        key = "params/" + k
        w = np.full(s, np.nan, np.float32)
        for out in eight:
            mesh = SimpleNamespace(shape={"data": 2, "model": 4},
                                   coord=out["coord24"])
            sl = local_slices(specs[key], s, mesh)
            got = out["d2_first"][key]
            prev = w[sl]
            assert np.all(np.isnan(prev) | (prev == got)), key
            w[sl] = got
        assert not np.isnan(w).any(), key
        whole[key] = w
    return whole


def test_a_rank_that_updates_from_its_own_gradient_fails(eight):
    """The planted fault: no ordered sum over the batch shards. The same
    check passes on the first step of the unplanted mesh."""
    want1 = _one_device(reduced_config("deepseek-7b"),
                        _batch(reduced_config("deepseek-7b"), 4, 16), 2, 1,
                        OptConfig(**OPT))[1]
    specs = _specs(reduced_config("deepseek-7b"), (2, 4))
    for out in eight:
        for key, same in (("fault", False), ("d2_first", True)):
            assert all(np.array_equal(out[key][k], _local(
                want1[k], specs[k], out["coord24"], (2, 4)))
                for k in want1) is same, key


@pytest.mark.parametrize("name,B", [("d2", 4), ("d8", 8)])
def test_step_collectives_equal_the_chip_smoke_prediction(eight, name, B):
    """``launch.dryrun.train_sharded_prediction`` (no host staging on the
    CPU) == each rank's counted collectives of a step (the step's own: the
    loop's stop flag is not in a bare step)."""
    cfg = reduced_config("deepseek-7b")
    pred = dryrun.train_sharded_prediction(cfg, (2, 4), B, 16,
                                                  staged=False)["step"]
    pred = dict(pred, calls=pred["calls"] - 1, bytes=pred["bytes"] - 4,
                all_reduce_max=pred["all_reduce_max"] - 1)
    for out in eight:
        got = out[name][2]
        assert {k: got[k] for k in pred} == pred


def test_loop_collectives_equal_the_chip_smoke_prediction(eight):
    """In ``train_loop`` on 4x2 (checkpoint at step 2): the second step's
    collectives with the first's stop flag == a step and a checkpoint's
    gathers."""
    cfg = reduced_config("deepseek-7b")
    p = dryrun.train_sharded_prediction(cfg, (4, 2), 8, 16,
                                               staged=False)
    want = {k: p["step"][k] + p["save"][k] for k in p["step"]}
    for out in eight:
        (got,) = out["elastic_a_comm"]
        assert {k: got[k] for k in want} == want


# ---------------------------------------------------------------------------
# (5) the compressed reduce on 8 ranks
# ---------------------------------------------------------------------------


def test_compressed_reduce_of_equal_gradients(eight):
    """The reference test's case: every rank holds the same gradient, the
    mean is that gradient within the int8 quantization."""
    errs = [out["same"][0] for out in eight]
    assert max(errs) < 0.02
    assert len({e for e in errs}) == 1          # every rank the same mean


def test_compressed_reduce_against_the_reference_quantizer(eight):
    """Different gradients per rank: the int32 total of the reference's
    per-rank int8 codes exactly; each residual as the reference's; the
    mean within the float order of the scale mean."""
    qs, scales = [], []
    for r in range(8):
        g = np.random.default_rng(100 + r).normal(0, 1, (5, 7)).astype(
            np.float32)
        e = np.random.default_rng(200 + r).normal(0, 0.01, (5, 7)).astype(
            np.float32)
        x = g + e
        q, s = r_q8(jnp.asarray(x))
        qs.append(np.asarray(q).astype(np.int32))
        scales.append(float(s))
        got = eight[r]["diff"]
        res = x - np.asarray(q).astype(np.float32) * np.float32(s)
        np.testing.assert_allclose(got["new_err"], res, rtol=0,
                                   atol=2e-7 * np.abs(x).max())
        np.testing.assert_array_equal(got["new_err"], got["err"])
    total = np.sum(qs, axis=0)
    mean = total.astype(np.float32) * np.float32(np.mean(scales)) / 8
    for out in eight:
        d = out["diff"]
        np.testing.assert_array_equal(d["total"], total)
        assert d["nrep"] == 8
        assert d["mean_scale"] == pytest.approx(np.mean(scales), rel=1e-6)
        np.testing.assert_allclose(d["mean"], mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(d["mean"], eight[0]["diff"]["mean"])


# ---------------------------------------------------------------------------
# (3) reduced dbrx-132b on 2x2, and the MoE dispatch case
# ---------------------------------------------------------------------------


def test_dbrx_mesh_step_is_bitwise_grad_accum_4(four):
    cfg = reduced_config("dbrx-132b")
    assert cfg.param_dtype == "bfloat16" and cfg.opt_factored
    opt = OptConfig(**OPT, factored=True)
    want_ms, want_state = _one_device(cfg, _batch(cfg, 4, 16), 4, 2, opt)
    assert any(k.endswith("/row") for k in want_state)
    for out in four:
        assert out["dbrx"][0] == want_ms
    _assert_slices_bitwise(four, "dbrx", want_state,
                           _specs(cfg, (2, 2), True), (2, 2), "coord")


def test_moe_dispatch_with_train_sharded_params(four, moe_case):
    """``tests/test_distributed.py::test_moe_dispatch_sharded_equivalence``
    : ``moe_apply`` on parameters each rank holds by the train specs and
    gathers, within 1e-3 (y) and 1e-4 (aux) of the reference's."""
    moe_np, moe_dims, _, y0, aux0 = moe_case
    for out in four:
        y, aux, shapes, specs = out["moe"]
        assert np.abs(y - y0).max() < 1e-3
        assert abs(aux - aux0) < 1e-4
        assert any(s != () for s in specs.values())   # something is cut
        for k, s in shapes.items():
            want = _local(moe_np[k], specs[k], out["coord"], (2, 2))
            assert s == want.shape, k


# ---------------------------------------------------------------------------
# (4) elastic: 4x2 -> checkpoint -> make_elastic_mesh -> 2x2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def elastic_one():
    """One device: 2 steps at grad_accum 8, then 2 at grad_accum 4, on the
    loop's batches and schedule."""
    cfg = reduced_config("deepseek-7b")
    opt = OptConfig(**ELASTIC_OPT)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8, seed=0))
    state = init_train_state(init_params(cfg, 0))
    ms, halves = [], []
    for accum, steps in ((8, (0, 1)), (4, (2, 3))):
        step = make_train_step(cfg, opt, grad_accum=accum)
        for i in steps:
            state, m = step(state, _tensors(data.make_batch(i)))
            ms.append(_metrics(m))
        halves.append(_flat_np(state))
    return ms, halves


def _hist(history):
    return [{k: v for k, v in h.items() if k not in ("step", "ms")}
            for h in history]


def test_elastic_run_is_bitwise_grad_accum_8_then_4(eight, four,
                                                    elastic_one):
    ms, (_, final) = elastic_one
    for out in eight:
        assert _hist(out["elastic_a"]) == ms[:2]
    cfg = reduced_config("deepseek-7b")
    for out in four:
        assert out["elastic_mesh"] == ({"data": 2, "model": 2},
                                       [0, 1, 2, 3])
        assert _hist(out["elastic_b"][0]) == ms[2:]
    _assert_slices_bitwise(four, "elastic_b", final, _specs(cfg, (2, 2)),
                           (2, 2), "coord")


def test_mesh_checkpoint_restores_in_the_references_restore(four,
                                                            elastic_one,
                                                            shared_dir):
    """The 4x2 checkpoint at step 2 and the 2x2 one at step 4 are the
    one-device state, read by ``repro.runtime.checkpoint.restore``."""
    _, halves = elastic_one
    d = os.path.join(shared_dir, "elastic")
    for step, want in zip((2, 4), halves):
        template = {}
        for k, v in want.items():
            node = template
            *path, last = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = np.zeros((), v.dtype)
        got_step, tree, extra = ref_ckpt.restore(d, step, template=template)
        assert got_step == step and extra["data"]["step"] == step
        got = {"/".join(str(p.key) for p in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_elastic_reshard_roundtrip(four):
    """``tests/test_distributed.py::test_elastic_reshard_roundtrip``:
    saved from 4x2, restored onto 2x2, values identical, each rank
    holding its slice of the new spec; 4 distinct shards of ``w``."""
    tree = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "g": np.arange(8.0, dtype=np.float32)}
    shards = set()
    for out in four:
        got, specs = out["roundtrip"]
        assert specs == {"w": ("data", "model"), "g": ("model",)}
        for k in tree:
            np.testing.assert_array_equal(
                got[k], _local(tree[k], specs[k], out["coord"], (2, 2)))
        shards.add(got["w"].tobytes())
    assert len(shards) == 4


def test_a_stop_request_on_one_rank_stops_every_rank(four):
    """Rank 1 alone asks to stop after its second step: every rank ends
    after that step (one that stopped alone would leave the others in its
    next collective until the deadline)."""
    assert [out["stop"] for out in four] == [(2, 2)] * 4


# ---------------------------------------------------------------------------
# (6) the CLI, with a rank that fails
# ---------------------------------------------------------------------------


def test_cli_mesh_recovers_a_failed_rank_bitwise(tmp_path, capfd,
                                                 monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    d = str(tmp_path / "ck")
    args = ["--arch", "deepseek-7b", "--reduced", "--steps", "4", "--batch",
            "8", "--seq", "16", "--mesh", "2x2", "--device", "cpu",
            "--ckpt-dir", d]
    train_main(args, rank_fn=_flaky_rank)
    out, err = capfd.readouterr()
    restarts = [json.loads(line) for line in err.splitlines()
                if line.startswith("{") and "recovery_restart" in line]
    assert len(restarts) == 1 and "planted rank failure" in \
        restarts[0]["error"]
    # rank 0 prints step 0 and the last step: the restart resumed past 0
    assert out.count("step     0 ") == 1 and out.count("step     3 ") == 1
    final = json.loads(out[out.index("{"):])
    # the uninterrupted run: one device, grad_accum = D = 4
    from repro_torch.launch.train import train_loop
    cfg = reduced_config("deepseek-7b")
    one = train_loop(cfg, TrainLoopConfig(steps=4, global_batch=8,
                                          seq_len=16, grad_accum=4),
                     device="cpu")
    assert final == one["final"]
    step, got, _ = ckpt.restore(d)
    assert step == 4
    want = _flat_np(one["state"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)


def test_cli_mesh_refusals():
    with pytest.raises(SystemExit):
        train_main(["--reduced", "--mesh", "auto", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_main(["--reduced", "--mesh", "2by2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--reduced", "--mesh", "1x2", "--steps", "1"])


def test_train_state_on_a_mesh_needs_deterministic_cuda():
    """A CUDA mesh step refuses to run without deterministic algorithms
    (ranks holding one slice must compute the same bits)."""
    mesh = SimpleNamespace(size=2, device=torch.device("cuda"),
                           axis_names=("data", "model"),
                           shape={"data": 1, "model": 2})
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="deterministic"):
        make_train_step(reduced_config("deepseek-7b"), OptConfig(),
                        mesh=mesh)


def test_gather_parts_and_barrier_on_one_rank():
    """A mesh of one rank: ``all_gather_parts`` is ``[x]``, the barrier a
    no-op, nothing counted."""
    comm.reset_comm_stats()
    m = comm.RankMesh((1, 1))
    x = torch.arange(3)
    assert m.all_gather_parts(x, ("data",)) == [x]
    m.barrier()
    assert comm.COMM_STATS["calls"] == 0


# ---------------------------------------------------------------------------
# the ordered reduce's hazards, without ranks
# ---------------------------------------------------------------------------


class _Parts:
    """A mesh stand-in whose gather returns fixed parts in shard order."""

    def __init__(self, parts):
        self.parts, self.device = parts, torch.device("cpu")

    def all_gather_parts(self, x, axes):
        return self.parts


def test_ordered_sum_adds_bf16_leaves_in_bf16_in_shard_order():
    """A rank >= 2 bfloat16 leaf sums in bfloat16 (the one-device
    ``grad_accum`` accumulator), a rank-1 one in float32, in shard order;
    another order or dtype gives other bits."""
    from repro_torch.train import train_step as ts
    vals = [1.0, 2.0 ** -8, 2.0 ** -8, -1.0]
    parts = [torch.full((2, 2), v, dtype=torch.bfloat16) for v in vals]
    got = ts._ordered_sum({"w": parts[0]}, ("data",), _Parts(parts), 4)["w"]
    acc = torch.zeros((2, 2), dtype=torch.bfloat16)
    for p in parts:
        acc = acc + p
    assert got.dtype == torch.bfloat16 and torch.equal(got, acc / 4)
    rev = torch.zeros((2, 2), dtype=torch.bfloat16)
    for p in reversed(parts):
        rev = rev + p
    f32 = sum(p.float() for p in parts)
    assert not torch.equal(rev, acc) and not torch.equal(f32, acc.float())
    vec = [p[0] for p in parts]
    got1 = ts._ordered_sum({"b": vec[0]}, ("data",), _Parts(vec), 4)["b"]
    assert got1.dtype == torch.float32
    assert torch.equal(got1, (sum(v.float() for v in vec) + 0) / 4)


def test_gathered_metrics_combine_as_one_device():
    """The gathered (A, 3) table rows combine from ``0.0`` in order to the
    same bits as the one-device microbatch metrics."""
    from repro_torch.train import train_step as ts
    rng = np.random.default_rng(3)
    ms = [{"loss": torch.tensor(rng.normal() * 5, dtype=torch.float32),
           "aux_loss": torch.tensor(rng.normal(), dtype=torch.float32),
           "tokens": torch.tensor(float(rng.integers(1, 99)))}
          for _ in range(6)]
    table = [torch.stack([torch.stack([m[k] for k in
                                       ("loss", "aux_loss", "tokens")])
                          for m in ms[i:i + 2]]) for i in (0, 2, 4)]
    got = ts._mean_metrics(ts._gathered_metrics(ms[:2], ("data",),
                                                _Parts(table)), 6, "cpu")
    want = ts._mean_metrics(ms, 6, "cpu")
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
