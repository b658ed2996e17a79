"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``), in one process: no ranks are
needed to resolve a spec.

* the 14 cases of ``tests/test_sharding.py``, on the port's rules over a
  plain mesh record, each also against the reference's result;
* every leaf of ``param_dims`` and the three prepared planes of every
  prepared weight (and the logits head) of deepseek-7b and
  granite-moe-1b-a400m, full and reduced, resolve to the reference's specs
  on the serving and production meshes;
* ``param_dims`` equals the reference's for every arch of the catalog.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models.transformer import init_params as ref_init  # noqa: E402
from repro.models.transformer import param_dims as ref_param_dims  # noqa: E402
from repro.parallel import sharding as rs  # noqa: E402
from repro.quant import prepared as rprep  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.transformer import param_dims  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    MeshShape, make_rules, prepared_plane_dims, prepared_specs, resolve_spec)
from repro_torch.quant import prepared as pprep  # noqa: E402


def _mesh(shape=(4, 2), axes=("data", "model")):
    return MeshShape(tuple(axes), tuple(shape))


def _ref_mesh(shape=(4, 2), axes=("data", "model")):
    """As ``tests/test_sharding.py::_mesh`` builds it."""
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


def _both(shape, axes, strategy, fn, **kw):
    """``fn(rules)`` under the port's and the reference's rules."""
    return (fn(make_rules(_mesh(shape, axes), strategy, **kw)),
            fn(rs.make_rules(_ref_mesh(shape, axes), strategy, **kw)))


def _same(port, ref):
    assert port == tuple(ref), (port, ref)
    return port


# ---------------------------------------------------------------------------
# tests/test_sharding.py, case by case
# ---------------------------------------------------------------------------


def test_basic_resolution():
    spec = _same(*_both((4, 2), ("data", "model"), "train", lambda r: r.resolve(
        ("embed", "heads", "head_dim"), (64, 8, 16))))
    assert spec == ("data", "model")


def test_divisibility_fallback():
    spec = _same(*_both((4, 2), ("data", "model"), "serve", lambda r: r.resolve(
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        (4, 8, 128, 3, 16))))
    assert spec == (None, "data", "model")


def test_priority_kv_heads_over_kv_seq():
    spec = _same(*_both((4, 2), ("data", "model"), "serve", lambda r: r.resolve(
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        (4, 8, 128, 4, 16))))
    assert spec == (None, "data", None, "model")


def test_batch_tuple_on_multipod():
    axes = ("pod", "data", "model")
    spec = _same(*_both((2, 2, 2), axes, "train",
                        lambda r: r.resolve(("batch", "seq"), (8, 64))))
    assert spec == (("pod", "data", "model"),)
    spec = _same(*_both((2, 2, 2), axes, "train",
                        lambda r: r.resolve(("batch", "seq"), (4, 64))))
    assert spec == (("pod", "data"), "model")


def test_missing_axis_skipped_on_single_pod():
    ax = ("data", "model")
    assert _same(*_both((4, 2), ax, "train", lambda r: r.resolve(
        ("batch", "seq"), (8, 64)))) == (("data", "model"),)
    assert _same(*_both((4, 2), ax, "train", lambda r: r.resolve(
        ("batch", "seq"), (4, 64)))) == ("data", "model")
    assert _same(*_both((4, 2), ax, "train", lambda r: r.resolve(
        ("batch", "seq"), (8, 64)), prefer_sp=True)) == ("data", "model")


def test_batch_one_replicates():
    spec = _same(*_both((4, 2), ("data", "model"), "serve", lambda r: r.resolve(
        ("batch", "kv_seq"), (1, 1024))))
    assert spec == (None, "data")


def test_no_axis_used_twice():
    spec = _same(*_both((4, 4), ("data", "model"), "train", lambda r: r.resolve(
        ("experts", "embed", "ffn"), (16, 64, 128))))
    flat = [a for part in spec for a in
            (part if isinstance(part, tuple) else (part,)) if a]
    assert len(flat) == len(set(flat))


def test_resolve_spec_tree():
    rules = make_rules(_mesh(), "train")
    dims = {"w": ("embed", "ffn"), "b": ("ffn",), "step": (None,)}
    shapes = {"w": (64, 128), "b": (128,), "step": ()}
    specs = resolve_spec(dims, shapes, rules)
    ref = rs.resolve_spec(dims, shapes, rs.make_rules(_ref_mesh(), "train"))
    assert specs == {k: tuple(v) for k, v in ref.items()}
    assert specs["w"] == ("data", "model")
    assert specs["b"] == ("model",)
    assert specs["step"] == ()


def test_scalar_dims_none():
    assert _same(*_both((4, 2), ("data", "model"), "train",
                        lambda r: r.resolve((None,), ()))) == ()


def test_size_one_axes_canonicalized_away():
    ax = ("data", "model")
    assert _same(*_both((1, 8), ax, "serve", lambda r: r.resolve(
        ("batch", "seq"), (8, 64)))) == ()
    assert _same(*_both((1, 8), ax, "serve", lambda r: r.resolve(
        ("embed", "ffn"), (64, 128)))) == (None, "model")


def test_prepared_plane_dims_uses_leading_tail_dim():
    rules = make_rules(_mesh(), "serve")
    codes_d, limbs_d, out_d = prepared_plane_dims(
        ("layers", "embed", "heads", "head_dim"), rules, stacked=True)
    assert out_d == "heads"
    assert codes_d == ("layers", "embed", "heads")
    assert limbs_d == ("layers", None, "embed", "heads")
    codes_d, limbs_d, out_d = prepared_plane_dims(("embed", "ffn"), rules)
    assert (codes_d, out_d) == (("embed", "ffn"), "ffn")
    assert limbs_d == (None, "embed", "ffn")
    _, _, out_d = prepared_plane_dims(("embed", "head_dim", "heads"), rules)
    assert out_d is None
    ref = rs.prepared_plane_dims(("layers", "embed", "heads", "head_dim"),
                                 rs.make_rules(_ref_mesh(), "serve"),
                                 stacked=True)
    assert prepared_plane_dims(("layers", "embed", "heads", "head_dim"),
                               rules, stacked=True) == ref


def test_prepared_specs_planes():
    w_dims = ("layers", "embed", "heads", "head_dim")
    w_shape = (4, 64, 8, 16)
    port, ref = _both((4, 2), ("data", "model"), "serve",
                      lambda r: (prepared_specs if isinstance(
                          r.mesh, MeshShape) else rs.prepared_specs)(
                          w_dims, w_shape, r, stacked=True,
                          per_channel=True))
    codes, limbs, scale = port
    assert port == tuple(tuple(s) for s in ref)
    assert codes == (None, "data", "model")
    assert limbs == (None, None, "data", "model")
    assert scale == (None, None, "model")
    _, _, scale_pt = prepared_specs(w_dims, w_shape,
                                    make_rules(_mesh(), "serve"),
                                    stacked=True, per_channel=False)
    assert scale_pt == ()


def test_prepared_specs_divisibility_fallback():
    rules = make_rules(_mesh((2, 8)), "serve")
    codes, limbs, _ = prepared_specs(("embed", "heads", "head_dim"),
                                     (64, 3, 7), rules)
    assert codes == ("data",)
    assert limbs == (None, "data")
    ref = rs.prepared_specs(("embed", "heads", "head_dim"), (64, 3, 7),
                            rs.make_rules(_ref_mesh((2, 8)), "serve"))
    assert (codes, limbs) == (tuple(ref[0]), tuple(ref[1]))


def test_prepared_specs_never_shard_mid_head():
    rules = make_rules(_mesh((2, 8)), "serve")
    codes, _, _ = prepared_specs(("embed", "heads", "head_dim"),
                                 (64, 4, 16), rules)
    assert codes == ("data",)
    codes, _, _ = prepared_specs(("embed", "heads", "head_dim"),
                                 (64, 8, 16), rules)
    assert codes == ("data", "model")


# ---------------------------------------------------------------------------
# every leaf and prepared plane of two models, on every mesh
# ---------------------------------------------------------------------------

MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MODELS = [("deepseek-7b", False), ("deepseek-7b", True),
          ("granite-moe-1b-a400m", False), ("granite-moe-1b-a400m", True)]
_SHAPES: dict = {}


def _ref_shapes(arch: str, reduced: bool):
    """The reference's parameter shapes (an abstract trace: nothing is
    allocated)."""
    key = (arch, reduced)
    if key not in _SHAPES:
        cfg = ref_reduced(arch) if reduced else ref_get_config(arch)
        tree = jax.eval_shape(lambda k: ref_init(cfg, k)[0],
                              jax.random.PRNGKey(0))
        _SHAPES[key] = jax.tree.map(lambda a: tuple(a.shape), tree)
    return _SHAPES[key]


def _leaves(dims, shapes, path=()):
    if isinstance(dims, dict):
        for k in dims:
            yield from _leaves(dims[k], shapes[k], path + (k,))
    else:
        yield path, dims, shapes


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m)) for m, _ in MESHES])
@pytest.mark.parametrize("arch,reduced", MODELS,
                         ids=[f"{a}{'-reduced' if r else ''}"
                              for a, r in MODELS])
def test_every_leaf_and_plane_resolves_as_the_reference(arch, reduced, shape,
                                                        axes):
    cfg = reduced_config(arch) if reduced else get_config(arch)
    rcfg = ref_reduced(arch) if reduced else ref_get_config(arch)
    dims = param_dims(cfg)
    assert dims == ref_param_dims(rcfg)
    shapes = _ref_shapes(arch, reduced)
    port = make_rules(_mesh(shape, axes), "serve", shard_batch=False)
    ref = rs.make_rules(_ref_mesh(shape, axes), "serve", shard_batch=False)
    n_planes = 0
    for path, d, s in _leaves(dims, shapes):
        assert port.resolve(d, s) == tuple(ref.resolve(d, s)), path
        if not (len(path) >= 2 and path[-1] in pprep._PROJ_WEIGHTS.get(
                path[-2], ())):
            continue
        k_ndim = pprep._K_NDIM.get((path[-2], path[-1]), 1)
        stack = pprep._stack_ndim_of(path, len(s), k_ndim, cfg.is_hybrid)
        assert stack == rprep._stack_ndim_of(path, d, len(s), k_ndim), path
        for per_channel in (False, True):
            got = prepared_specs(d, s, port, stack_ndim=stack,
                                 k_ndim=k_ndim, per_channel=per_channel)
            want = rs.prepared_specs(d, s, ref, stack_ndim=stack,
                                     k_ndim=k_ndim, per_channel=per_channel)
            assert got == tuple(tuple(w) for w in want), path
        n_planes += 1
    # the logits head: the tied table's (d_model, vocab) view
    head = ("embed", "vocab"), (cfg.d_model, cfg.vocab)
    assert prepared_specs(*head, port) == tuple(
        tuple(w) for w in rs.prepared_specs(*head, ref))
    assert n_planes >= 7


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_dims_equal_the_reference(arch, reduced):
    cfg = reduced_config(arch) if reduced else get_config(arch)
    rcfg = ref_reduced(arch) if reduced else ref_get_config(arch)
    assert param_dims(cfg) == ref_param_dims(rcfg)


def test_kv_seq_on_pure_tensor_parallel_meshes_replicates():
    """The reference's rule for a cache whose kv heads do not divide the
    model axis: on a 1xM mesh the ``kv_seq`` candidates start with the
    size-1 data axis, which ends the search, so the cache replicates (its
    sequence is cut only where the data axis is wider than one)."""
    dims = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    for shape, kv, want in (((1, 4), 2, ()), ((1, 8), 4, ()),
                            ((2, 2), 4, (None, None, "model", "data")),
                            ((2, 4), 2, (None, None, None, "data"))):
        got = _same(*_both(shape, ("data", "model"), "serve",
                           lambda r: r.resolve(dims, (4, 2, kv, 128, 16)),
                           shard_batch=False))
        assert got == want, (shape, kv, got)
