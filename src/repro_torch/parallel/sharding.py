"""Logical-axis sharding: rules, best-fit resolution, resharding at the
model's constraint sites (the port's ``repro.parallel.sharding``).

Models name the dims of every parameter and activation ("batch", "heads",
"ffn", "experts", ...). A :class:`Rules` maps each name to an ordered list
of candidate mesh axes; resolution is greedy over dims in priority order,
divisibility-checked, and never uses a mesh axis twice in one tensor, so
``kv_heads=2`` on a 4-way model axis replicates instead of failing.

A spec is a tuple with one entry per leading dim: ``None`` (replicated), an
axis name, or a tuple of axis names (major to minor); trailing ``None`` s
are dropped and size-1 axes never appear, so a spec equals the reference's
``PartitionSpec`` entry for entry. Rules resolve over any mesh record with
``axis_names`` and a ``shape`` dict: no process group is needed to resolve
a spec.

torch has no partitioner, so what GSPMD inserts the port writes out:
:func:`local_slices` gives the part of a tensor a rank holds (the
counterpart of ``named_sharding``), and :func:`reshard` / :func:`constrain`
move a tensor between layouts with the mesh's collectives
(:mod:`repro_torch.parallel.comm`): an all-gather where the target
replicates a sharded dim, a slice where it shards a replicated one. Both
are exact (no float is added), so a layout change never moves a bit.
Outside a :func:`use_rules` context :func:`constrain` is the identity.

Prepared weights take their planes' layout from :func:`prepared_specs`
(the section at the bottom).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

__all__ = ["MeshShape", "Rules", "TRAIN_RULES", "make_rules", "train_rules",
           "use_rules", "current_rules", "constrain", "resolve_spec",
           "Sharding", "named_sharding", "spec_axes", "spec_entry",
           "local_slices", "reshard", "replicate", "prepared_plane_dims",
           "prepared_specs"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A plain mesh record: axis names and their sizes. What the rules
    resolve over (a :class:`repro_torch.parallel.comm.RankMesh` has the
    same two attributes)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class Rules:
    """Logical dim -> ordered candidate mesh axes, with dim priorities.

    Resolution is greedy over dims in *priority* order (then positional),
    divisibility-checked, never assigning a mesh axis twice within one
    tensor: a KV cache prefers sharding kv_heads over kv_seq, and falls
    back to the seq dim when the head count doesn't divide.
    """

    def __init__(self, mesh, table: Dict[str, Sequence],
                 priority: Sequence[str] = (), name: str = "rules"):
        self.mesh = mesh
        self.table = dict(table)
        self.priority = list(priority)
        self.name = name

    def axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            return math.prod(self.mesh.shape[a] for a in axis)
        return self.mesh.shape[axis]

    def resolve(self, dims: Tuple[Optional[str], ...],
                shape: Optional[Tuple[int, ...]] = None) -> tuple:
        used = set()
        parts: list = [None] * len(dims)
        names = set(self.mesh.axis_names)
        sizes = self.mesh.shape

        def rank(i_dim):
            i, dim = i_dim
            try:
                return (0, self.priority.index(dim), i)
            except ValueError:
                return (1, 0, i)

        for i, dim in sorted(enumerate(dims), key=rank):
            for cand in self.table.get(dim, ()):   # ordered candidates
                flat = cand if isinstance(cand, tuple) else (cand,)
                if any(a not in names for a in flat):
                    continue   # axis absent from this mesh (e.g. one pod)
                # canonical form: size-1 axes shard nothing and are
                # dropped; a 1-tuple is a bare axis. A candidate left with
                # no axis still ends the search for this dim.
                eff = tuple(a for a in flat if sizes[a] > 1)
                if any(a in used for a in eff):
                    continue
                if shape is not None and shape[i] % self.axis_size(eff):
                    continue
                if eff:
                    parts[i] = eff[0] if len(eff) == 1 else eff
                    used.update(eff)
                break
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


_PRIORITY = ["batch", "experts", "vocab", "heads", "kv_heads", "ffn",
             "inner", "embed", "kv_seq", "seq", "vocab_act"]


def make_rules(mesh, strategy: str = "train", seq_shard_kv: bool = True,
               prefer_sp: bool = False, shard_seq: bool = True,
               shard_batch: bool = True) -> Rules:
    """The reference's rule sets for ``(pod?, data, model)`` meshes.

    ``"train"``: FSDP + sequence parallelism (batch over every axis for
    dense stacks, over ``(pod, data)`` with sequence parallelism over
    ``model`` under ``prefer_sp``; ``shard_seq=False`` keeps seq whole, for
    SSM stacks). ``"serve"``: tensor parallelism (heads / ffn / experts /
    vocab over ``model``) with weights also sharded over the data axes on
    their embed dim; KV caches shard kv_heads over model where it divides,
    else kv_seq. ``shard_batch=False`` (serve) replicates batch-indexed
    activations: the deterministic layout the serving engine uses, where
    every rank computes every float op at its one-device shape.
    """
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    fsdp_axes = [batch_axes, "data"]
    common = {
        "head_dim": [], "ssm_state": [], "dt_rank": [], "conv_k": [],
        "layers": [], "groups": [], "sub": [], "enc_seq": [],
        "groups_act": [batch_axes, "data"],
        "experts_act": ["model"],
        "embed_act": [],
        "vocab": ["model"],
        "heads": ["model"],
        "kv_heads": ["model"],
        "ffn": ["model"],
        "experts": ["model"],
        "inner": ["model"],
        "embed": fsdp_axes,
    }
    if strategy == "train":
        if prefer_sp:
            batch_cands = [batch_axes, "data"]
        elif "pod" in mesh.axis_names:
            batch_cands = [("pod", "data", "model"), ("pod", "data"),
                           "data"]
        else:
            batch_cands = [("data", "model"), "data"]
        table = dict(common)
        table.update({
            "batch": batch_cands,
            "seq": ["model"] if shard_seq else [],
            "vocab_act": ["model"],
            "kv_seq": [],
        })
    elif strategy == "serve":
        table = dict(common)
        table.update({
            "batch": ([batch_axes, "data"] if shard_batch else []),
            "seq": [],
            "vocab_act": ["model"],
            "kv_seq": (["data", "model"] if seq_shard_kv else []),
        })
        if not shard_batch:
            table["groups_act"] = []
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return Rules(mesh, table, priority=_PRIORITY, name=strategy)


def train_rules(mesh, fsdp: bool = True, seq_shard_kv: bool = True,
                **_kw) -> Rules:
    """Alias of ``make_rules(mesh, "train", seq_shard_kv)``."""
    return make_rules(mesh, "train", seq_shard_kv)


TRAIN_RULES = train_rules


_ctx = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def resolve_spec(dims_tree, shapes_tree, rules: Rules):
    """A dims tree (nested dicts of dims tuples) and the matching shapes ->
    the tree of specs."""
    if isinstance(dims_tree, dict):
        return {k: resolve_spec(v, shapes_tree[k], rules)
                for k, v in dims_tree.items()}
    return rules.resolve(tuple(dims_tree), tuple(shapes_tree))


class Sharding(NamedTuple):
    """A leaf's layout: its spec on a mesh (``NamedSharding``'s
    counterpart)."""
    spec: tuple
    mesh: Any


def named_sharding(specs, mesh):
    """A tree of specs -> the tree of :class:`Sharding` on ``mesh``."""
    if isinstance(specs, dict):
        return {k: named_sharding(v, mesh) for k, v in specs.items()}
    return Sharding(tuple(specs), mesh)


# ---------------------------------------------------------------------------
# local slices and resharding
# ---------------------------------------------------------------------------


def spec_axes(spec: tuple, i: int) -> Tuple[str, ...]:
    """The mesh axes sharding dim ``i`` of ``spec`` (major to minor)."""
    if i >= len(spec) or spec[i] is None:
        return ()
    return spec[i] if isinstance(spec[i], tuple) else (spec[i],)


def spec_entry(axes: Sequence[str]):
    """The canonical spec entry of ``axes``: ``None``, a bare axis, or a
    tuple."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _shard_of(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's index, shard count) along ``axes``, row-major."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord[a]
        n *= mesh.shape[a]
    return idx, n


def local_slices(spec: tuple, shape: Tuple[int, ...], mesh) -> tuple:
    """The ``slice`` per dim of the part of a ``shape`` tensor laid out by
    ``spec`` that this rank of ``mesh`` holds (``named_sharding``'s
    counterpart)."""
    out = []
    for i, size in enumerate(shape):
        axes = spec_axes(spec, i)
        if not axes:
            out.append(slice(0, int(size)))
            continue
        idx, n = _shard_of(mesh, axes)
        if size % n:
            raise ValueError(f"dim {i} of size {size} does not split over "
                             f"{axes} ({n} shards)")
        part = int(size) // n
        out.append(slice(idx * part, (idx + 1) * part))
    return tuple(out)


def reshard(x, src: tuple, dst: tuple, mesh=None):
    """``x`` (this rank's part under ``src``) in the layout ``dst``: dims
    whose axes differ are all-gathered over the source axes, then sliced
    over the target axes. Exact."""
    if tuple(src) == tuple(dst):
        return x
    if mesh is None:
        mesh = current_rules().mesh
    for i in range(x.dim()):
        s, d = spec_axes(src, i), spec_axes(dst, i)
        if s == d:
            continue
        if s:
            x = mesh.all_gather(x, i, s)
        if d:
            idx, n = _shard_of(mesh, d)
            part = x.shape[i] // n
            x = x.narrow(i, idx * part, part)
    return x


def replicate(x, spec: tuple, mesh=None):
    """The whole tensor from this rank's part under ``spec``."""
    return reshard(x, spec, (), mesh)


def constrain(x, dims: Tuple[Optional[str], ...], spec: tuple = ()):
    """``x``, laid out by ``spec`` (default replicated), resharded to the
    layout the active rules give ``dims`` (the reference's
    ``with_sharding_constraint`` sites); the identity outside a rules
    context or on a mesh of one rank."""
    rules = current_rules()
    if rules is None or getattr(rules.mesh, "size", 1) == 1:
        return x
    full = list(x.shape)
    for i in range(x.dim()):
        full[i] *= math.prod(rules.mesh.shape[a] for a in spec_axes(spec, i))
    return reshard(x, spec, rules.resolve(tuple(dims), tuple(full)),
                   rules.mesh)


# ---------------------------------------------------------------------------
# PreparedWeight plane specs
# ---------------------------------------------------------------------------
#
# A ``quant.prepared.PreparedWeight`` stores a (*stack, K, *tail) weight as
# kernel-ready planes whose trailing output axes are flattened:
#
#   codes  (*stack, K, n)        packed FP8 codes, n = prod(tail)
#   limbs  (*stack, 3, K, n)     int8 limb planes (optional)
#   scale  (*stack, 1, n) | (*stack,)   per-channel | per-tensor scales
#
# The K axis keeps the weight's input dim, the flattened output axis
# inherits the *leading* tail dim (divisibility checked against that dim's
# size, so a shard always covers whole trailing slices, e.g. whole heads),
# and per-channel scales follow the output axis.


def prepared_plane_dims(w_dims: Tuple[Optional[str], ...], rules: Rules, *,
                        stacked: bool = False,
                        stack_ndim: Optional[int] = None, k_ndim: int = 1):
    """``(codes_dims, limbs_dims, out_dim)`` of a PreparedWeight's planes
    from the raw weight's dims ``(*stack, *k, *tail)``: a single contracted
    axis keeps its dim on K, a flattened multi-axis K stays replicated,
    and only the leading tail dim may name the output axis (``None`` when
    it has no mesh candidates)."""
    n_stack = (1 if stacked else 0) if stack_ndim is None else stack_ndim
    stack_dims = tuple(w_dims[:n_stack])
    in_dim = w_dims[n_stack] if k_ndim == 1 else None
    tail_dims = tuple(w_dims[n_stack + k_ndim:])
    out_dim = None
    if tail_dims and tail_dims[0] is not None and rules.table.get(
            tail_dims[0]):
        out_dim = tail_dims[0]
    codes_dims = stack_dims + (in_dim, out_dim)
    limbs_dims = stack_dims + (None, in_dim, out_dim)  # 3-limb axis local
    return codes_dims, limbs_dims, out_dim


def prepared_specs(w_dims: Tuple[Optional[str], ...],
                   w_shape: Tuple[int, ...], rules: Rules, *,
                   stacked: bool = False, stack_ndim: Optional[int] = None,
                   k_ndim: int = 1, per_channel: bool = False):
    """``(codes_spec, limbs_spec, scale_spec)`` of a PreparedWeight built
    from a raw ``w_shape`` weight with dims ``w_dims`` (the flattened plane
    shapes are derived here; divisibility is checked against the leading
    tail dim's size, never the flattened ``n``)."""
    n_stack = (1 if stacked else 0) if stack_ndim is None else stack_ndim
    stack_shape = tuple(int(s) for s in w_shape[:n_stack])
    K = math.prod(int(s) for s in w_shape[n_stack:n_stack + k_ndim])
    tail = tuple(int(s) for s in w_shape[n_stack + k_ndim:])
    out_size = tail[0] if tail else 1
    codes_dims, limbs_dims, out_dim = prepared_plane_dims(
        w_dims, rules, stack_ndim=n_stack, k_ndim=k_ndim)
    codes_spec = rules.resolve(codes_dims, stack_shape + (K, out_size))
    limbs_spec = rules.resolve(limbs_dims, stack_shape + (3, K, out_size))
    if per_channel:
        scale_spec = rules.resolve(tuple(w_dims[:n_stack]) + (None, out_dim),
                                   stack_shape + (1, out_size))
    else:
        scale_spec = rules.resolve(tuple(w_dims[:n_stack]), stack_shape)
    return codes_spec, limbs_spec, scale_spec
