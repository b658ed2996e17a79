"""Dry run of every (arch x shape x mesh) cell on the H100, with nothing
allocated: the port's counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for a TPU mesh and reads its
memory and cost from the compiled program. The port runs eagerly, so its
dry run computes the same record from the cell's shapes:

* **argument bytes per device**: the parameters as the cell holds them
  (prepared planes under a kernel preset: codes, scales, and limbs where
  ``quant.prepared._keep_limbs`` keeps them; raw leaves at the dtype
  ``cast_params`` gives), the serving cache (its planes built on the
  ``meta`` device) or the train state (``train_state_specs``), each this
  rank's slice under the sharding rules;
* a stated estimate of the transient bytes (:func:`_transient_bytes`),
  ``live_bytes`` and ``fits_hbm`` against
  :data:`repro_torch.launch.roofline.H100_SXM`;
* the FLOPs, dot bytes and kernel launches of one step from per-layer
  closed forms (:func:`step_dots`: every dot of the step with its shape and
  the ``LAUNCHES`` entry it runs under a kernel preset), which
  ``tests/test_torch_dryrun.py`` holds equal to a recorded step
  (:mod:`repro_torch.launch.step_cost`) at reduced widths;
* the collectives of a step on the mesh (:func:`step_dots`' ``coll``;
  a train step's from :func:`train_sharded_prediction`) and their ring
  traffic;
* the three roofline terms and the bottleneck (:mod:`.roofline`).

The mesh is a :class:`repro_torch.parallel.sharding.MeshShape`: no world
of ranks, no card and no JAX. A cell the port cannot run is recorded with
the port's own reason (serving on a mesh takes dense and MoE stacks, under
any ``QuantConfig``; ``long_500k`` needs sub-quadratic attention).
Training cells are costed under the float path.

This module also owns the per-step launch and collective predictions that
``chip_smoke.py`` holds its counted launches and collectives to
(:func:`group_launches`, :func:`family_b1_shapes`, :func:`eval_b1_shapes`,
:func:`eval_launches`, :func:`fleet_group_launches`,
:func:`sharded_prediction`, :func:`continuous_sharded_prediction`,
:func:`train_sharded_prediction`).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh 1x8 \
      --quant fp8_mgs_serve_kv
  python -m repro_torch.launch.dryrun --all --mesh 2x16x16 --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as rl
from repro_torch.models.common import dtype_of
from repro_torch.parallel.sharding import (MeshShape, make_rules,
                                           prepared_specs, spec_axes)
from repro_torch.quant import QuantConfig
from repro_torch.quant.config import FP8_MGS_SERVE_KV

__all__ = ["QUANT_MODES", "parse_mesh", "input_specs", "build_cell",
           "run_cell", "step_dots", "Dot", "param_bytes", "cache_bytes",
           "pool_bytes", "state_bytes", "group_launches", "family_b1_shapes",
           "eval_b1_shapes", "eval_launches", "fleet_group_launches",
           "sharded_prediction", "continuous_sharded_prediction",
           "train_sharded_prediction", "main"]

#: the reference's four modes and the port's serving kernel preset
QUANT_MODES = {
    "none": QuantConfig(),
    "fp8_wide": QuantConfig(dtype="fp8_e4m3", accum="wide"),
    "fp8_mgs_exact": QuantConfig(dtype="fp8_e4m3", accum="mgs_exact",
                                 use_kernel=False),
    "int8": QuantConfig(dtype="int8", accum="wide"),
    "fp8_mgs_serve_kv": FP8_MGS_SERVE_KV,
}


def parse_mesh(text: str) -> MeshShape:
    """``"DxM"`` -> a ``(data, model)`` mesh; ``"PxDxM"`` adds ``pod``."""
    sizes = tuple(int(s) for s in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if axes is None:
        raise ValueError(f"mesh {text!r}: DxM or PxDxM")
    return MeshShape(axes, sizes)


@dataclasses.dataclass(frozen=True)
class _Rank0:
    """Rank 0 of a :class:`MeshShape`: what ``init_cache`` and the rules
    read to lay out a rank's part (every rank's part has the same size)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coord(self) -> Dict[str, int]:
        return {a: 0 for a in self.axis_names}


def _rank0(mesh) -> _Rank0:
    return _Rank0(tuple(mesh.axis_names), tuple(mesh.sizes))


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)


def _cfg_for(arch: str, shape: ShapeConfig, quant: str,
             overrides: Optional[Dict] = None) -> ModelConfig:
    cfg = get_config(arch)
    kw: Dict[str, Any] = {"quant": QUANT_MODES[quant]}
    if shape.kind == "train":
        kw["remat"] = "layer"
    else:
        # serving runs bf16 weights (no optimizer, no master copies)
        kw["remat"] = "none"
        kw["param_dtype"] = "bfloat16"
    if overrides:
        kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len

    def f(s, dt):
        return torch.empty(s, dtype=dt, device="meta")
    cdt = torch.bfloat16
    if shape.kind == "train":
        specs = {"tokens": f((B, S), torch.int32),
                 "labels": f((B, S), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": f((B, S), torch.int32)}
    else:  # decode
        specs = {"tokens": f((B, 1), torch.int32)}
    if cfg.vision_prefix and shape.kind != "decode":
        specs["vision_embeds"] = f((B, cfg.vision_prefix, cfg.d_model), cdt)
    if cfg.encoder_layers and shape.kind != "decode":
        specs["audio_embeds"] = f((B, cfg.encoder_len, cfg.d_model), cdt)
    return specs


def _cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.seq_len + (cfg.vision_prefix or 0)


# ---------------------------------------------------------------------------
# bytes: parameters, caches, train state
# ---------------------------------------------------------------------------


def _local(spec: tuple, shape: Sequence[int], sizes: Dict[str, int]):
    """This rank's part of a ``shape`` tensor laid out by ``spec``."""
    out = []
    for i, s in enumerate(shape):
        n = math.prod(sizes[a] for a in spec_axes(spec, i))
        out.append(int(s) // n)
    return tuple(out)


def _nbytes(shape, itemsize: int) -> int:
    return math.prod(int(s) for s in shape) * itemsize


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _prepared(cfg: ModelConfig) -> bool:
    q = cfg.quant
    return q.is_fp8 and q.accum in ("mgs_exact", "mgs_dmac")


def _proj_site(path, shape, cfg: ModelConfig):
    """(stack_ndim, k_ndim) of a projection leaf ``prepare_params``
    prepares, else ``None`` (``quant.prepared``'s rule)."""
    from repro_torch.quant.prepared import (_K_NDIM, _PROJ_WEIGHTS,
                                            _stack_ndim_of)
    if len(path) >= 2 and path[-1] in _PROJ_WEIGHTS.get(path[-2], ()) \
            and len(shape) >= 2:
        k_ndim = _K_NDIM.get((path[-2], path[-1]), 1)
        return (_stack_ndim_of(path, len(shape), k_ndim, cfg.is_hybrid),
                k_ndim)
    return None


def _plane_bytes(shape, dims, rules, sizes, cfg: ModelConfig,
                 stack_ndim: int, k_ndim: int) -> int:
    """Codes, scales and (kept) limbs of one prepared weight, this rank's
    part."""
    from repro_torch.quant.prepared import _keep_limbs
    q = cfg.quant
    stack = tuple(shape[:stack_ndim])
    K = math.prod(shape[stack_ndim:stack_ndim + k_ndim])
    n = math.prod(shape[stack_ndim + k_ndim:])
    if rules is None:
        cspec = lspec = sspec = ()
    else:
        cspec, lspec, sspec = prepared_specs(
            dims, shape, rules, stack_ndim=stack_ndim, k_ndim=k_ndim,
            per_channel=q.per_channel)
    codes = _nbytes(_local(cspec, stack + (K, n), sizes), 1)
    limbs = (_nbytes(_local(lspec, stack + (3, K, n), sizes), 1)
             if _keep_limbs(q, None) else 0)
    sshape = stack + ((1, n) if q.per_channel else ())
    return codes + limbs + _nbytes(_local(sspec, sshape, sizes), 4)


def _raw_slice_bytes(shape, dims, rules, sizes, cfg: ModelConfig,
                     stack_ndim: int, k_ndim: int, itemsize: int) -> int:
    """A raw projection weight as this rank holds it on a mesh: its
    :class:`~repro_torch.quant.prepared.RawSlice` (the values' slice and
    the whole weight's absmax, per stack slice, per column under
    ``per_channel``), or the whole weight where the rules leave it whole
    (``quant.prepared.shard_raw_params``)."""
    cspec, _, _ = prepared_specs(dims, shape, rules, stack_ndim=stack_ndim,
                                 k_ndim=k_ndim)
    if not any(cspec):
        return _nbytes(shape, itemsize)
    stack = tuple(shape[:stack_ndim])
    K = math.prod(shape[stack_ndim:stack_ndim + k_ndim])
    n = math.prod(shape[stack_ndim + k_ndim:])
    local = _local(cspec, stack + (K, n), sizes)
    amax = local[:-2] + (1, local[-1] if cfg.quant.per_channel else 1)
    return _nbytes(local, itemsize) + _nbytes(amax, 4)


def param_bytes(cfg: ModelConfig, rules=None) -> Dict[str, int]:
    """This rank's parameter bytes as a serving engine holds them:
    ``prepared`` planes of every projection and the logits head under an
    MGS preset (``prepare_params`` + ``prepare_logits_head``), ``raw``
    leaves at the dtype ``cast_params`` gives them (rank >= 2 at the
    compute dtype, norms at the parameter dtype): whole on every rank,
    except the projection weights (and an untied ``unembed``) of the
    configurations that keep them raw, which a mesh cuts as it cuts the
    planes (``shard_raw_params``)."""
    from repro_torch.models.transformer import (_KEEP_F32, param_dims,
                                                param_shapes)
    from repro_torch.quant.prepared import _K_NDIM, _PROJ_WEIGHTS, \
        _stack_ndim_of
    sizes = rules.mesh.shape if rules is not None else {}
    dims = dict(_walk(param_dims(cfg)))
    cdt, pdt = dtype_of(cfg.compute_dtype), dtype_of(cfg.param_dtype)
    prep = _prepared(cfg)
    out = {"prepared": 0, "raw": 0}
    for path, shape in _walk(param_shapes(cfg)):
        site = _proj_site(path, shape, cfg) if prep else None
        if site is not None:
            out["prepared"] += _plane_bytes(shape, dims[path], rules, sizes,
                                            cfg, *site)
            continue
        dt = cdt if len(shape) >= 2 and path[-1] not in _KEEP_F32 else pdt
        cut = None
        if rules is not None and len(shape) >= 2:
            if path == ("unembed",):
                cut = (0, 1)
            elif len(path) >= 2 and path[-1] in _PROJ_WEIGHTS.get(
                    path[-2], ()):
                k_ndim = _K_NDIM.get((path[-2], path[-1]), 1)
                cut = (_stack_ndim_of(path, len(shape), k_ndim,
                                      cfg.is_hybrid), k_ndim)
        if cut is not None:
            out["raw"] += _raw_slice_bytes(shape, dims[path], rules, sizes,
                                           cfg, *cut, dt.itemsize)
        else:
            out["raw"] += _nbytes(shape, dt.itemsize)
    if prep:
        shape = (cfg.d_model, cfg.vocab)
        out["prepared"] += _plane_bytes(shape, ("embed", "vocab"), rules,
                                        sizes, cfg, 0, 1)
        if not cfg.tie_embeddings:      # the raw unembed is replaced
            out["raw"] -= _nbytes(shape, cdt.itemsize)
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _walk(tree)
               if isinstance(t, torch.Tensor))


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                rules=None) -> int:
    """This rank's serving cache (``init_cache`` on the ``meta`` device)."""
    from repro_torch.models.transformer import init_cache
    return _tree_bytes(init_cache(cfg, batch, max_len, device="meta",
                                  rules=rules))


def pool_bytes(cfg: ModelConfig, slots: int, max_len: int, n_blocks: int,
               rules=None) -> int:
    """This rank's paged pool (``init_paged_cache`` on the ``meta``
    device)."""
    from repro_torch.models.transformer import init_paged_cache
    return _tree_bytes(init_paged_cache(cfg, slots, max_len, n_blocks,
                                        device="meta", rules=rules))


def state_bytes(cfg: ModelConfig, rules, factored: bool) -> Dict[str, int]:
    """This rank's slice of the train state by ``train_state_specs``:
    parameters at the parameter dtype, ``mu`` (bf16 for a factored leaf of
    rank >= 2, else float32) and ``nu`` (float32, or its row / column
    factors)."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.train_step import train_state_specs
    from repro_torch.tree import flatten_with_paths
    specs = flatten_with_paths(train_state_specs(cfg, rules, factored))
    shapes = flatten_with_paths(param_shapes(cfg))
    sizes = rules.mesh.shape
    pdt = dtype_of(cfg.param_dtype)
    out = {"params": 0, "opt": 0}
    for k, spec in specs.items():
        if k.startswith("params/"):
            s, isz, part = shapes[k[7:]], pdt.itemsize, "params"
        elif k.startswith("opt/mu/"):
            s = shapes[k[7:]]
            isz, part = (2 if factored and len(s) >= 2 else 4), "opt"
        elif k.startswith("opt/nu/"):
            name = k[7:]
            if name in shapes:
                s = shapes[name]
            else:
                base, which = name.rsplit("/", 1)
                s = shapes[base][:-1] if which == "row" else \
                    shapes[base][:-2] + shapes[base][-1:]
            isz, part = 4, "opt"
        else:                           # opt/step
            s, isz, part = (), 4, "opt"
        out[part] += _nbytes(_local(spec, s, sizes), isz)
    return out


# ---------------------------------------------------------------------------
# the dots and kernel launches of one step, per layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dot:
    """``calls`` dots (or kernel launches) of one shape in a step:
    ``(Bt, M, K) x (Bt, K, N)``; ``entry`` is the ``LAUNCHES`` key it runs
    under a kernel preset (``None``: a float dot), ``activation`` B1's
    epilogue. B2's ``(Bt, M, K, N)`` is ``(N slices, T rows, D, live
    keys)``."""
    name: str
    Bt: int
    M: int
    K: int
    N: int
    calls: int = 1
    entry: Optional[str] = None
    segments: int = 1
    table: int = 0
    scale_rows: int = 1
    scale_elems: int = 1
    activation: str = "none"

    @property
    def flops(self) -> float:
        if self.entry == "mgs_flash_attention":
            return self.calls * 2.0 * 2 * self.M * self.K * self.N
        if self.entry in _CLOSING:
            return 0.0
        return self.calls * 2.0 * self.Bt * self.M * self.K * self.N

    def bound(self) -> Tuple[float, str]:
        return rl.kernel_bound(self.entry, self._shape(),
                               segments=self.segments,
                               scale_rows=self.scale_rows,
                               scale_elems=self.scale_elems)

    def nbytes(self) -> float:
        """The bytes a launch must move (:func:`roofline.kernel_work`)."""
        return rl.kernel_work(self.entry, self._shape(),
                              segments=self.segments,
                              scale_rows=self.scale_rows,
                              scale_elems=self.scale_elems)[0]

    def _shape(self):
        if self.entry == "mgs_flash_attention":
            return (self.Bt, self.M, self.K, self.N, self.table)
        return (self.Bt, self.M, self.K, self.N)


#: the entries that close a cut K's exact sums: no product of their own
_CLOSING = ("mgs_matmul_exact_flush", "mgs_matmul_dmac_combine")


def _chunks(cfg, keys: int) -> int:
    """Score / value launch pairs of a prefill over ``keys`` keys: one a
    key chunk (``attn_chunk``), one with dense scores."""
    return -(-keys // cfg.attn_chunk) if cfg.attn_chunk else 1


class _Layout:
    """A rank's cut of each projection under the serving rules: the
    divisors of its stack, K and N and the mesh axes of K and N (all 1 /
    empty off a mesh)."""

    def __init__(self, cfg: ModelConfig, rules=None, coll=None):
        self.cfg, self.rules = cfg, rules
        self.sizes = rules.mesh.shape if rules is not None else {}
        #: the step's collectives, ``(kind, payload bytes, group size)``
        self.coll = [] if coll is None else coll
        self.act = dtype_of(cfg.compute_dtype).itemsize

    def collective(self, kind: str, nbytes: int, group: int, calls: int):
        if group > 1:
            self.coll.extend([(kind, int(nbytes), int(group))] * calls)

    def kv_seq_cut(self, batch: int, keys: int) -> int:
        """Shards of a packed cache's sequence under the rules (1: whole)."""
        if self.rules is None:
            return 1
        cfg = self.cfg
        bs = cfg.quant.block_k
        spec = self.rules.resolve(
            ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
            (cfg.n_layers, batch, cfg.n_kv_heads, -(-keys // bs) * bs,
             cfg.head_dim))
        return math.prod(self.sizes[a] for a in spec_axes(spec, 3))

    def float_cache_gather(self, batch: int, keys: int) -> Tuple[int, int]:
        """(payload bytes, group) of gathering one layer's K (or V) of a
        float cache of ``keys`` positions whole along its sequence cut
        (group 1: not cut)."""
        if self.rules is None:
            return 0, 1
        cfg = self.cfg
        spec = self.rules.resolve(
            ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            (cfg.n_layers, batch, keys, cfg.n_kv_heads, cfg.head_dim))
        local = _local(spec, (1, batch, keys, cfg.n_kv_heads, cfg.head_dim),
                       self.sizes)
        return (_nbytes(local, dtype_of(cfg.kv_cache_dtype).itemsize),
                math.prod(self.sizes[a] for a in spec_axes(spec, 2)))

    def cut(self, module: str, name: str):
        """(stack div, K div, N div, K axes, N axes) of ``module.name``
        (``head``: the logits head)."""
        cfg = self.cfg
        if self.rules is None or (module == "head" and cfg.tie_embeddings
                                  and not _prepared(cfg)):
            # a raw tied table stays whole: the head is every rank's
            return 1, 1, 1, (), ()
        from repro_torch.models.transformer import param_dims, param_shapes
        if module == "head":
            shape, dims, stack, k_ndim = ((cfg.d_model, cfg.vocab),
                                          ("embed", "vocab"), 0, 1)
        else:
            shape = dict(_walk(param_shapes(cfg)))[("layers", module, name)]
            dims = dict(_walk(param_dims(cfg)))[("layers", module, name)]
            stack, k_ndim = _proj_site(("layers", module, name), shape, cfg)
        spec = prepared_specs(dims, shape, self.rules, stack_ndim=stack,
                              k_ndim=k_ndim)[0]
        n = len(spec) if spec else 0

        def axes(i):
            return spec_axes(spec, i) if i < n else ()

        def div(ax):
            return math.prod(self.sizes[a] for a in ax)
        sdiv = math.prod(div(axes(i)) for i in range(1, stack))
        return (sdiv, div(axes(stack)), div(axes(stack + 1)), axes(stack),
                axes(stack + 1))


def _path(q: QuantConfig) -> str:
    """The kernel a config's projections launch: ``"b1"`` (the fused
    exact kernels, B3 under a stationary schedule), ``"b4"``, ``"b5"``, or
    ``"float"`` (no kernel: float dots, the integer sums and the twins)."""
    if q.is_fp8 and q.use_kernel and q.accum == "mgs_exact":
        return "b1" if q.fused else "b4"
    if q.is_fp8 and q.use_kernel and q.accum == "mgs_dmac":
        return "b5"
    return "float"


#: each path's one-call entry, and its entries over a cut of K
_ENTRY = {"b1": "mgs_matmul_exact_fused", "b4": "mgs_matmul_exact",
          "b5": "mgs_matmul_dmac", "float": None}
_CUT_ENTRIES = {"b1": ("mgs_matmul_exact_partials", "mgs_matmul_exact_flush"),
                "b4": ("mgs_matmul_exact_limb_partials",
                       "mgs_matmul_exact_flush"),
                "b5": ("mgs_matmul_dmac_partials", "mgs_matmul_dmac_combine")}


def _k_cut_collectives(lay: _Layout, shape, K: int, Bt: int, M: int,
                       calls: int, k_local: bool) -> bool:
    """The collectives of one projection whose K the rules cut
    (``quant.qmatmul._sharded_k``): ``True`` where it gathers both
    operands whole along K (an order-dependent sum) and runs the whole K.
    """
    q = lay.cfg.quant
    kd = K // shape[2]
    rows, n = shape[0] * M, shape[3]
    if q.accum == "swamp" or (q.is_int and q.accum in ("clip", "wrap")):
        if k_local:
            lay.collective("all_gather", rows * shape[2] * lay.act, kd,
                           calls)
        lay.collective("all_gather", shape[0] * shape[2] * n * lay.act, kd,
                       calls)
        return True
    if k_local and q.dtype != "none":
        per = rows if q.per_row_act else shape[0]
        lay.collective("all_reduce_max", per * 4, kd, calls)
    if q.dtype == "none" or (q.is_fp8 and q.accum == "wide"):
        # the float32 partials, gathered and added in rank order
        lay.collective("all_gather", rows * n * 4, kd, calls)
    elif q.is_int:
        lay.collective("all_reduce_sum", rows * n * 4, kd, calls)
    elif q.accum == "mgs_dmac":
        lay.collective("all_reduce_sum", q.fmt.n_bins * rows * n * 4, kd,
                       calls)
    else:
        from repro_torch.kernels.mgs_matmul import partial_segments
        _, nseg = partial_segments(K, q.block_k, None)
        lay.collective("all_reduce_sum", nseg * 5 * rows * n * 4, kd, calls)
    return False


def _scale_elems(q: QuantConfig, shape, path: str) -> int:
    """The scale elements a cut K's closing entry reads as stored
    (``quant.qmatmul._sharded_k``): the activation's scale (a row's under
    ``per_row_act``, else a slice's) times the weight's (a column's under
    ``per_channel``, else a slice's). B1's flush takes it only without
    ``per_row_act``; the models pass no bias."""
    if path != "b5" and q.per_row_act:
        return 0
    Bt, M, _, N = shape
    return Bt * (M if q.per_row_act else 1) * (N if q.per_channel else 1)


def _proj(out: List[Dot], lay: _Layout, module: str, name: str, label: str,
          M: int, K: int, N: int, kernels: bool, Bt: int = 1,
          calls: int = 1, gather: bool = True, k_local: bool = False,
          out_bytes: Optional[int] = None, activation: str = "none"):
    """One projection's dot(s) on this rank, and its collectives.

    Under a kernel path a launch of its entry (B1 fused, B4, B5) or, where
    the rules cut its K, the entries over a cut and their closing one
    (B1's or B4's partials and B1's flush; B5's partials and combine); a
    float dot otherwise. A cut K reduces as ``quant.qmatmul._sharded_k``
    does (:func:`_k_cut_collectives`): the activation's amax max-reduced
    over the K group when ``x`` arrives cut along K (``k_local``: the
    hidden of an up-projection left local), then the exact sums
    sum-reduced (B1 / B4 class partials, B5 bins, integer sums), the float
    partials gathered, or both operands gathered whole along K. An output
    cut along N is all-gathered unless ``gather=False`` (``out_bytes`` a
    value; default the compute dtype's)."""
    sdiv, kd, nd, _, _ = lay.cut(module, name)
    shape = (Bt // sdiv, M, K // kd, N // nd)
    rows = shape[0] * M
    path = _path(lay.cfg.quant) if kernels else "float"
    kw = dict(calls=calls,
              activation=activation if path == "b1" else "none")
    if kd > 1 and _k_cut_collectives(lay, shape, K, Bt, M, calls, k_local):
        shape = (shape[0], M, K, shape[3])      # the whole K, gathered
        kd = 1
    if kd > 1 and path != "float":
        part, close = _CUT_ENTRIES[path]
        q = lay.cfg.quant
        if path == "b5":
            nseg = q.fmt.n_bins
        else:
            from repro_torch.kernels.mgs_matmul import partial_segments
            _, nseg = partial_segments(K, q.block_k, None)
        out.append(Dot(label, *shape, calls=calls, entry=part,
                       segments=nseg))
        out.append(Dot(label + (" combine" if path == "b5" else " flush"),
                       shape[0], M, 0, shape[3], entry=close,
                       segments=nseg,
                       scale_elems=_scale_elems(q, shape, path), **kw))
    else:
        out.append(Dot(label, *shape, entry=_ENTRY[path], **kw))
    if gather:
        item = lay.act if out_bytes is None else out_bytes
        lay.collective("all_gather", rows * shape[3] * item, nd, calls)


def _heads(lay: _Layout) -> int:
    """This rank's share of the heads: wq / wk / wv cut alike over their
    output (``models.attention._heads_axes``), else 1."""
    cuts = [lay.cut("attn", w)[4] for w in ("wq", "wk", "wv")]
    if cuts[0] and all(c == cuts[0] for c in cuts[1:]):
        return math.prod(lay.sizes[a] for a in cuts[0])
    return 1


def _attention(out, lay, cfg, pre: str, B: int, Tq: int, keys: int, *,
               kernels: bool, decode: bool, kv_rows: Optional[int] = None,
               calls: int = 1, live=None, float_cache: bool = False):
    """One attention sublayer: its projections (K / V over ``kv_rows`` rows:
    default the queries', the encoder's frames for cross-attention, 0 for
    the stored cross planes at decode), then the score / value contractions
    over ``keys`` keys (B2 at a packed decode, over ``live`` keys a slice;
    a ``float_cache`` of ``keys`` positions gathered whole along its
    sequence cut first, K and V), then the out-projection."""
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    h = _heads(lay)
    Hl, KVl, G = H // h, KV // h, H // KV
    M = B * Tq
    _proj(out, lay, "attn", "wq", f"{pre} wq", M, d, H * hd, kernels,
          calls=calls, gather=h == 1)
    kv_rows = M if kv_rows is None else kv_rows
    if kv_rows:
        for w in ("wk", "wv"):
            _proj(out, lay, "attn", w, f"{pre} {w}", kv_rows, d, KV * hd,
                  kernels, calls=calls, gather=h == 1)
    if decode and kernels and cfg.quant.quantized_kv:
        bs = cfg.quant.block_k
        lives = [keys if live is None else live] * B if isinstance(
            live, (int, type(None))) else list(live)
        live_keys = KVl * sum(-(-n // bs) * bs for n in lives)
        nb = -(-keys // bs)
        seq = lay.kv_seq_cut(B, keys)
        if seq > 1:     # a sequence-cut cache is gathered whole first
            part = B * KVl * (nb * bs // seq)
            for nbytes in (part * hd, part * hd, part * 4, part * 4):
                lay.collective("all_gather", nbytes, seq, calls)
        out.append(Dot(f"{pre} attention", B * KVl, G * Tq, hd,
                       live_keys, calls=calls,
                       entry="mgs_flash_attention", table=B * KVl * nb))
    else:
        if float_cache:
            nbytes, seq = lay.float_cache_gather(B, keys)
            for _ in ("k", "v"):
                lay.collective("all_gather", nbytes, seq, calls)
        S = cfg.attn_chunk if (cfg.attn_chunk and Tq > 1) else keys
        n = _chunks(cfg, keys) if (cfg.attn_chunk and Tq > 1) else 1
        entry = _ENTRY[_path(cfg.quant)] if kernels else None
        # a float decode step contracts at the model's kv heads, a rank's
        # share and zeros (``models.attention._sdpa_dense``)
        kv = KV if (Tq == 1 and not cfg.quant.is_fp8) else KVl
        out.append(Dot(f"{pre} scores", B * kv, G * Tq, hd, S,
                       calls=calls * n, entry=entry))
        out.append(Dot(f"{pre} values", B * kv, G * Tq, S, hd,
                       calls=calls * n, entry=entry))
    lay.collective("all_gather", M * Hl * hd * lay.act, h, calls)
    _proj(out, lay, "attn", "wo", f"{pre} wo", M, H * hd, d, kernels,
          calls=calls)


# the epilogue activation of the up projections (``models.ffn`` / ``moe``)
_ACT = {"wg": "silu", "wi": "gelu"}


def _ffn(out, lay, cfg, pre: str, M: int, kernels: bool, calls: int = 1,
         module: str = "ffn"):
    d, f = cfg.d_model, cfg.d_ff
    names = ("wg", "wu") if cfg.act == "silu" else ("wi",)
    for w in names:
        _proj(out, lay, module, w, f"{pre} {w}", M, d, f, kernels,
              calls=calls, gather=False, activation=_ACT.get(w, "none"))
    _proj(out, lay, module, "wd", f"{pre} wd", M, f, d, kernels, calls=calls,
          k_local=lay.cut(module, names[0])[4] == lay.cut(module, "wd")[3])


def _moe(out, lay, cfg, pre: str, rows: int, kernels: bool, calls: int = 1):
    from repro_torch.models.moe import _n_groups
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    G = _n_groups(rows, cfg)
    g = rows // G
    C = max(1, int(math.ceil(cfg.top_k * g * cfg.capacity_factor / E)))
    _proj(out, lay, "moe", "wr", f"{pre} router", rows, d, E, kernels,
          calls=calls, out_bytes=4)
    names = ("wg", "wu") if cfg.act == "silu" else ("wi",)
    for w in names:
        _proj(out, lay, "moe", w, f"{pre} experts {w}", G * C, d, f,
              kernels, Bt=E, calls=calls, gather=False,
              activation=_ACT.get(w, "none"))
    _proj(out, lay, "moe", "wd", f"{pre} experts wd", G * C, f, d, kernels,
          Bt=E, calls=calls,
          k_local=lay.cut("moe", names[0])[4] == lay.cut("moe", "wd")[3])
    ep = lay.cut("moe", "wd")[0]
    lay.collective("all_gather", G * (E // ep) * C * d * lay.act, ep, calls)


def _ssm(out, cfg, pre: str, B: int, T: int, decode: bool, kernels: bool,
         calls: int = 1):
    """A Mamba sublayer: its seven projections and the float contractions
    of its scan (``C`` against the state; at decode also the conv)."""
    lay = _Layout(cfg)
    d, di, r, N = cfg.d_model, cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    M = B * T
    for w, K, n in (("wx", d, di), ("wz", d, di), ("wdt_down", di, r),
                    ("wdt_up", r, di), ("wB", di, N), ("wC", di, N),
                    ("wo", di, d)):
        _proj(out, lay, "ssm", w, f"{pre} {w}", M, K, n, kernels,
              calls=calls)
    if decode:
        out.append(Dot(f"{pre} conv", di, B, cfg.d_conv, 1, calls=calls))
    out.append(Dot(f"{pre} scan C", M, di, N, 1, calls=calls))


def _head(out, lay, cfg, rows: int, kernels: bool):
    _proj(out, lay, "head", "logits", "logits", rows, cfg.d_model,
          cfg.vocab, kernels, out_bytes=4)


def step_dots(cfg: ModelConfig, kind: str, batch: int, seq: int,
              cache_len: int = 0, *, rules=None, live=None,
              coll: Optional[list] = None) -> List[Dot]:
    """Every dot of one step of ``cfg`` on one rank, as :class:`Dot` s.

    ``kind``: ``"forward"`` (teacher-forced logits at every position),
    ``"prefill"`` (``seq`` prompt tokens into a cache; the head on the last
    position), ``"decode"`` (one token against ``cache_len`` cached keys,
    ``live`` of them live a slot, default all; or a list, one a slot) or
    ``"train"`` (a forward
    and its backward: two dots per forward dot, the layers' forward again
    under ``remat == "layer"``, the streamed cross entropy's chunks again
    past 65536 tied entries). Under a kernel config (``use_kernel``: B1
    under ``fused``, B4 without, B5 under ``mgs_dmac``) each projection and
    each fp8 score / value contraction is a launch of that kernel (its
    entries over a cut and the closing one where ``rules`` cut its K), and
    decode attention over the packed cache a B2 launch; otherwise every
    dot is a float one. A VLM's prefix rides before the tokens; an
    encoder-decoder's encoder runs at ``forward``, ``prefill`` and
    ``train`` over ``encoder_len`` frames. With ``rules`` (the serving
    rules of a mesh, every rank on every row) each dot is this rank's
    part, and ``coll`` (a list) receives the step's collectives as
    ``(kind, payload bytes, group size)``, as ``RankMesh`` counts them."""
    q = cfg.quant
    kernels = _path(q) != "float" and kind != "train"
    if kind == "train":
        fwd = step_dots(cfg, "forward", batch, seq, rules=rules)
        return _train_dots(cfg, fwd, batch, seq)
    if kind not in ("forward", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}")
    lay = _Layout(cfg, rules, coll)
    decode = kind == "decode"
    B = batch
    T = 1 if decode else seq
    Tq = T if decode else T + (cfg.vision_prefix or 0)
    # a float cache is attended whole (its ``cache_len`` keys), a packed
    # prefill over the prompt's own keys
    float_cache = bool(kind != "forward" and cache_len
                       and not q.quantized_kv)
    keys = cache_len if decode or float_cache else Tq
    M = B * Tq
    out: List[Dot] = []
    if cfg.encoder_layers and not decode:
        F = cfg.encoder_len
        for i in range(cfg.encoder_layers):
            _attention(out, lay, cfg, "encoder", B, F, F, kernels=kernels,
                       decode=False)
            _ffn(out, lay, cfg, "encoder", B * F, kernels)
    if cfg.is_ssm_only:
        _ssm(out, cfg, "ssm", B, Tq, decode, kernels, calls=cfg.n_layers)
    elif cfg.is_hybrid:
        G, per = cfg.n_layers // cfg.attn_every, cfg.attn_every
        n_moe = sum(1 for j in range(per)
                    if j % cfg.moe_every == cfg.moe_offset)
        _attention(out, lay, cfg, "attn", B, Tq, keys, kernels=kernels,
                   decode=decode, calls=G, live=live)
        _ssm(out, cfg, "ssm", B, Tq, decode, kernels, calls=G * (per - 1))
        if n_moe:
            _moe(out, lay, cfg, "moe", M, kernels, calls=G * n_moe)
        if per - n_moe:
            _ffn(out, lay, cfg, "ffn", M, kernels, calls=G * (per - n_moe))
    else:
        L = cfg.n_layers
        _attention(out, lay, cfg, "attn", B, Tq, keys, kernels=kernels,
                   decode=decode, calls=L, live=live,
                   float_cache=float_cache)
        if cfg.encoder_layers:
            F = cfg.encoder_len
            if decode:
                # the packed cross planes, stored at prefill
                _attention(out, lay, cfg, "cross", B, 1, F, kernels=kernels,
                           decode=True, kv_rows=0, calls=L)
            else:
                _attention(out, lay, cfg, "cross", B, Tq, F, kernels=kernels,
                           decode=False, kv_rows=B * F, calls=L)
        if cfg.is_moe:
            _moe(out, lay, cfg, "moe", M, kernels, calls=L)
        else:
            _ffn(out, lay, cfg, "ffn", M, kernels, calls=L)
    _head(out, lay, cfg, B * (T if kind == "forward" else 1), kernels)
    return _merge(out)


def _merge(dots: List[Dot]) -> List[Dot]:
    """Dots of one name and shape summed into one entry."""
    acc: Dict[tuple, Dot] = {}
    for d in dots:
        key = dataclasses.replace(d, calls=1)
        prev = acc.get(key)
        acc[key] = d if prev is None else dataclasses.replace(
            prev, calls=prev.calls + d.calls)
    return list(acc.values())


def _train_dots(cfg: ModelConfig, fwd: List[Dot], batch: int,
                seq: int) -> List[Dot]:
    """A train step's dots from its forward's: each forward dot, its two
    gradient dots, the layers' forward once more under layer remat, and
    the streamed cross entropy's chunks (each rematerialized) in place of
    the plain head past 65536 tied entries."""
    from repro_torch.models.transformer import (_CE_CHUNK_THRESHOLD,
                                                _CE_VCHUNK)
    out = []
    streamed = cfg.tie_embeddings and cfg.vocab > _CE_CHUNK_THRESHOLD
    for d in fwd:
        if d.name == "logits":
            if streamed:
                n = -(-cfg.vocab // _CE_VCHUNK)
                d = dataclasses.replace(d, N=_CE_VCHUNK, calls=n)
                out.append(dataclasses.replace(d, calls=4 * n))
            else:
                out.append(dataclasses.replace(d, calls=3 * d.calls))
            continue
        # the encoder runs outside the per-layer checkpoints
        extra = 1 if cfg.remat == "layer" and not d.name.startswith(
            "encoder") else 0
        out.append(dataclasses.replace(d, calls=(3 + extra) * d.calls))
    return out


def dot_bytes(dots: List[Dot], itemsize: int) -> float:
    """Operand and result bytes of the float dots, ``itemsize`` each."""
    return float(sum(d.calls * itemsize * d.Bt * (d.M * d.K + d.K * d.N
                                                  + d.M * d.N)
                     for d in dots if d.entry is None))


def launches(dots: List[Dot]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dots:
        if d.entry is not None:
            out[d.entry] = out.get(d.entry, 0) + d.calls
    return out


def kernel_bound_ms(dots: List[Dot]) -> float:
    """The step's kernel launches back to back at their bounds."""
    return sum(d.calls * d.bound()[0] for d in dots if d.entry is not None)


def kernel_bytes(dots: List[Dot]) -> float:
    """The bytes the kernel launches must move, as their bounds count them
    (:mod:`.roofline`)."""
    return sum(d.calls * d.nbytes() for d in dots if d.entry is not None)


def _refusal(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Optional[str]:
    """Why the port's engine does not run this cell today (``None``: it
    does); the dry run costs it as the rules lay it out all the same."""
    if shape.kind == "train" or math.prod(mesh.sizes) == 1:
        return None
    from repro_torch.launch.serve import mesh_refusal
    return mesh_refusal(cfg)


def _rules(cfg: ModelConfig, shape: ShapeConfig, mesh):
    rank = _rank0(mesh)
    if shape.kind == "train":
        from repro_torch.parallel.sharding import train_rules
        return train_rules(rank)
    return make_rules(rank, "serve", shard_batch=False)


def _transient_bytes(cfg: ModelConfig, kind: str, rows: int, T: int,
                     keys: int) -> int:
    """A stated estimate of one step's transient bytes: one layer's
    activations over ``rows`` x ``T`` tokens at the compute dtype (the
    residual, its norm, q / k / v and the attention output, the FFN
    hidden twice, the experts' rows) plus the float32 scores and weights
    of one attention chunk and the float32 logits; a train step keeps
    every layer's input (layer remat) and twice one layer's activations
    (the recompute and its gradients)."""
    act = dtype_of(cfg.compute_dtype).itemsize
    d, hd = cfg.d_model, cfg.head_dim
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd
    hidden = 2 * (cfg.d_ff * (cfg.top_k if cfg.is_moe else 1))
    if cfg.ssm_state:
        hidden = max(hidden, 3 * cfg.d_inner)
    M = rows * T
    layer = M * (3 * d + qkv + hidden) * act
    chunk = cfg.attn_chunk if (cfg.attn_chunk and T > 1) else keys
    scores = 2 * rows * cfg.n_heads * T * chunk * 4
    logits_rows = M if kind == "train" else rows
    logits = logits_rows * cfg.vocab * 4
    if kind == "train":
        from repro_torch.models.transformer import (_CE_CHUNK_THRESHOLD,
                                                    _CE_VCHUNK)
        if cfg.tie_embeddings and cfg.vocab > _CE_CHUNK_THRESHOLD:
            logits = M * _CE_VCHUNK * 4
        return (cfg.n_layers * M * d * act + 2 * (layer + scores)
                + 2 * logits)
    return layer + scores + logits


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """The cell's shapes and per-device bytes, nothing allocated: the
    rules, the inputs (``meta``), this rank's rows, the dots and
    collectives of a step and the argument / transient bytes."""
    rules = _rules(cfg, shape, mesh)
    n_dev = math.prod(mesh.sizes)
    B, S = shape.global_batch, shape.seq_len
    cache_len = _cache_len(cfg, shape)
    mem: Dict[str, float] = {}
    if shape.kind == "train":
        from repro_torch.train.train_step import batch_shards
        _, D = batch_shards(rules, B, S)
        rows = B // D
        # the ranks a batch shard spans compute the same rows (sequence
        # parallelism in training is ROADMAP A12.2c)
        repeat = n_dev // D
        dots = step_dots(cfg, "train", rows, S)
        # the parameters gathered whole, the gradients over the batch
        # shards, the metrics, the stop flag
        coll = train_sharded_prediction(
            cfg, mesh, B, S, grad_accum=cfg.grad_accum,
            staged=False)["step_ops"] if n_dev > 1 else []
        st = state_bytes(cfg, rules, cfg.opt_factored)
        mem["params_bytes"], mem["opt_bytes"] = st["params"], st["opt"]
        whole = param_bytes(dataclasses.replace(
            cfg, compute_dtype=cfg.param_dtype, quant=QuantConfig()))["raw"]
        # the step holds the whole parameters (gathered) and their gradients
        gathered = whole if n_dev > 1 else 0
        mem["argument_bytes"] = st["params"] + st["opt"]
        mem["temp_bytes"] = (gathered + whole + _transient_bytes(
            cfg, "train", rows, S, S))
        keys = S
    else:
        r = rules if n_dev > 1 else None
        rows, T = B, (1 if shape.kind == "decode" else S)
        repeat = 1
        coll = []
        dots = step_dots(cfg, shape.kind, B, T, cache_len, rules=r,
                         coll=coll)
        pb = param_bytes(cfg, r)
        try:
            cb = cache_bytes(cfg, B, cache_len, r)
        except NotImplementedError:   # no mesh layout for SSM / cross caches
            cb = cache_bytes(cfg, B, cache_len)
        mem["params_bytes"] = pb["prepared"] + pb["raw"]
        mem["prepared_bytes"], mem["raw_bytes"] = pb["prepared"], pb["raw"]
        mem["cache_bytes"] = cb
        mem["argument_bytes"] = mem["params_bytes"] + cb
        keys = cache_len
        mem["temp_bytes"] = _transient_bytes(cfg, shape.kind, rows, T, keys)
    mem["live_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    return {"rules": rules, "inputs": input_specs(cfg, shape), "rows": rows,
            "repeat": repeat, "dots": dots, "collectives": coll,
            "memory": mem}


def run_cell(arch: str, shape_name: str, mesh="16x16", quant: str = "none",
             overrides: Optional[Dict] = None,
             hw: rl.Hardware = rl.H100_SXM) -> Dict[str, Any]:
    """One cell's record: the reference's fields (``RooflineReport``) and
    the port's (launches, the kernels' step bound, argument bytes by part,
    ``fits_hbm``, and why the port's engine refuses it, if it does).

    ``hlo_flops_per_device`` is what one rank computes in the port today;
    in a train cell the ranks that share a batch shard repeat it
    (``repeat`` of them), so ``useful_flops_ratio_layout`` is the useful
    ratio once the rules' sequence cut is computed and not repeated."""
    mesh = parse_mesh(mesh) if isinstance(mesh, str) else mesh
    shape = SHAPES[shape_name]
    cfg = _cfg_for(arch, shape, quant, overrides)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention; "
                          "this arch is pure full attention"}
    if shape.kind == "train" and QUANT_MODES[quant].use_kernel:
        return {"arch": arch, "shape": shape_name, "quant": quant,
                "skipped": True,
                "reason": "the kernel preset serves; train cells are "
                          "costed under the float and emulated configs"}
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    dots, mem = cell["dots"], cell["memory"]
    n_dev = math.prod(mesh.sizes)
    act = dtype_of(cfg.compute_dtype).itemsize
    traffic = rl.collective_traffic(cell["collectives"])
    cost = {"flops": sum(d.flops for d in dots),
            "bytes accessed": dot_bytes(dots, act) + kernel_bytes(dots)}
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mflops = rl.model_flops(cfg.n_params(), cfg.n_active_params(), tokens,
                            shape.kind)
    report = rl.analyze(
        arch=arch, shape=shape_name, mesh_name=_mesh_name(mesh),
        n_devices=n_dev, cost=cost, mem=mem, mflops=mflops,
        collective_bytes=traffic.bytes_per_device,
        collective_per_op=traffic.per_op, hw=hw)
    rec = report.to_json()
    rec.update(
        quant=quant, kind=shape.kind, rows_per_device=cell["rows"],
        n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
        fits_hbm=mem["live_bytes"] <= hw.hbm_bytes,
        launches=launches(dots), kernel_bound_ms=kernel_bound_ms(dots),
        collective_counts=traffic.counts, overrides=overrides or {},
        port_refuses=_refusal(cfg, shape, mesh), repeat=cell["repeat"],
        useful_flops_ratio_layout=(report.useful_flops_ratio
                                   * cell["repeat"]),
        dryrun_s=round(time.time() - t0, 3))
    return rec


def _cells():
    for arch in ARCHS:
        if arch == "mgs-paper-eval":
            continue
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="16x16",
                    help="DxM (data, model) or PxDxM (pod, data, model)")
    ap.add_argument("--quant", default="none", choices=list(QUANT_MODES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="a directory for one JSON file a cell")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all")
    mesh = parse_mesh(args.mesh)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    cells = list(_cells()) if args.all else [(args.arch, args.shape)]
    ok = 0
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{_mesh_name(mesh)}__{args.quant}"
        try:
            rec = run_cell(arch, shape_name, mesh, args.quant)
            ok += 1
        except Exception as e:  # record the failure: it is a bug
            rec = {"arch": arch, "shape": shape_name, "error": str(e),
                   "traceback": traceback.format_exc()}
            if not args.continue_on_error:
                raise
        if args.out:
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        print(json.dumps(rec), flush=True)
    print(f"{ok}/{len(cells)} cells recorded", flush=True)
    return 0 if ok == len(cells) else 1


# ---------------------------------------------------------------------------
# per-step launch and collective predictions of chip_smoke.py's traffic
# ---------------------------------------------------------------------------


_B1, _B2 = "mgs_matmul_exact_fused", "mgs_flash_attention"


def group_launches(cfg, prompt: int = 32, batch: int = 4, new: int = 16,
                   requests: int = 8):
    """Kernel launches of ``chip_smoke.py`` phase 4's traffic under
    FP8_MGS_SERVE_KV through the group engine (``requests / batch``
    groups, each a ``prompt``-token prefill and ``new - 1`` decode steps),
    from :func:`step_dots`; and ``(B1, B2)`` launches of one decode
    step."""
    cfg = dataclasses.replace(cfg, quant=FP8_MGS_SERVE_KV)
    max_len = cfg.vision_prefix + prompt + new + 1
    pre = launches(step_dots(cfg, "prefill", batch, prompt, max_len))
    dec = launches(step_dots(cfg, "decode", batch, 1, max_len))
    groups = requests // batch
    return ({_B1: groups * (pre.get(_B1, 0) + (new - 1) * dec.get(_B1, 0)),
             _B2: groups * (new - 1) * dec.get(_B2, 0)},
            (dec.get(_B1, 0), dec.get(_B2, 0)))


def _b1_shapes(cfg, steps, prefix: str = ""):
    """Every distinct ``(name, Bt, M, K, N, epilogue activation)`` that B1
    runs at over ``steps`` (``(label, kind, batch, seq, cache_len)``), the
    dots that share one named together."""
    names: Dict[tuple, List[str]] = {}
    for label, kind, batch, seq, cache_len in steps:
        for d in step_dots(cfg, kind, batch, seq, cache_len):
            if d.entry == _B1:
                key = (d.Bt, d.M, d.K, d.N, d.activation)
                names.setdefault(key, []).append(f"{label}{d.name}")
    return [(f"{prefix}{'/'.join(dict.fromkeys(v))}",) + key
            for key, v in names.items()]


def family_b1_shapes(cfg, batch: int = 4, prompt: int = 32):
    """Every B1 launch shape of phase 4's traffic (``batch`` requests of
    ``prompt`` tokens, FP8_MGS_SERVE_KV) through the group engine on any
    family, as ``(name, Bt, M, K, N, epilogue activation)``: a decode
    step's and a prefill's dots (:func:`step_dots`)."""
    cfg = dataclasses.replace(cfg, quant=FP8_MGS_SERVE_KV)
    max_len = cfg.vision_prefix + prompt + 16 + 1
    return _b1_shapes(cfg, [("decode ", "decode", batch, 1, max_len),
                            ("prefill ", "prefill", batch, prompt,
                             max_len)], f"{cfg.family} ")


def _eval_cfg(cfg):
    return dataclasses.replace(cfg, quant=QuantConfig(
        dtype="fp8_e4m3", accum="mgs_exact", use_kernel=True, fused=True))


def eval_b1_shapes(cfg, batch: int = 8, seq: int = 64):
    """Every shape a teacher-forced forward of ``cfg`` over ``batch`` x
    ``seq`` tokens launches B1 (``mgs_exact``) or B5 (``dmac_mgs``) at, as
    ``(name, Bt, M, K, N, B1's epilogue activation)``."""
    return _b1_shapes(_eval_cfg(cfg), [("", "forward", batch, seq, 0)])


def eval_launches(cfg, batch: int = 8, seq: int = 64):
    """B1 (or B5) launches of one eval forward (9 a dense layer and the
    head)."""
    return launches(step_dots(_eval_cfg(cfg), "forward", batch,
                              seq)).get(_B1, 0)


def fleet_group_launches(cfg, new: int, full: int, partial: int):
    """Predicted launches of ``full`` whole groups (a prefill and ``new -
    1`` decode steps each) and ``partial`` runs of a prefill and one decode
    step (an attempt cut at decode step 2, a rebuild's warmup)."""
    want, (dec, b2) = group_launches(cfg)
    pre = want["mgs_matmul_exact_fused"] // 2 - 15 * dec
    return {"mgs_matmul_exact_fused": full * (pre + (new - 1) * dec)
            + partial * (pre + dec),
            "mgs_flash_attention": full * (new - 1) * b2 + partial * b2}


def _comm_totals(coll, staged: bool, kinds: Sequence[str]) -> dict:
    """Calls by kind, payload bytes and the bytes gloo stages through the
    host on one card (``staged``: an all-gather's payload down and the
    ``g`` shards back, an all-reduce's down and back) of ``coll``."""
    out = dict(calls=len(coll), bytes=sum(nb for _, nb, _ in coll),
               host_bytes=staged * sum(nb * (g + 1) if k == "all_gather"
                                       else 2 * nb for k, nb, g in coll),
               **dict.fromkeys(kinds, 0))
    for k, _, _ in coll:
        out[k] += 1
    return out


#: the serving path's ``LAUNCHES`` entries (every kernel path)
_SERVE_KEYS = ("mgs_matmul_exact_fused", "mgs_matmul_exact_partials",
               "mgs_matmul_exact_flush", "mgs_flash_attention",
               "mgs_matmul_exact", "mgs_matmul_exact_limb_partials",
               "mgs_matmul_dmac", "mgs_matmul_dmac_partials",
               "mgs_matmul_dmac_combine")


def sharded_prediction(cfg, model: int = 2, batch: int = 4,
                       prompt: int = 32, new: int = 16, requests: int = 8,
                       staged: bool = True,
                       quant: QuantConfig = FP8_MGS_SERVE_KV) -> dict:
    """Per rank of a ``1 x model`` mesh serving ``requests`` of ``prompt``
    tokens at ``batch``, ``new`` tokens each, under ``quant`` (phase 4's
    traffic under ``FP8_MGS_SERVE_KV``, the default; phase 17's first group
    of phase 7's under its configurations): kernel launches by entry and
    collectives (calls by kind, bytes sent, bytes staged through the host
    by gloo when ``staged``) of one decode step and of the run, from
    :func:`step_dots` under the serving rules (heads, ffn, experts and
    vocab cut over ``model`` where it divides them)."""
    cfg = dataclasses.replace(cfg, quant=quant)
    rules = make_rules(_rank0(MeshShape(("data", "model"), (1, model))),
                       "serve", shard_batch=False)
    max_len = cfg.vision_prefix + prompt + new + 1
    keys = _SERVE_KEYS
    kinds = ("all_gather", "all_reduce_max", "all_reduce_sum")

    def step(kind, seq):
        coll: list = []
        got = launches(step_dots(cfg, kind, batch, seq, max_len,
                                 rules=rules, coll=coll))
        return {k: got.get(k, 0) for k in keys}, coll

    dec, dec_c = step("decode", 1)
    pre, pre_c = step("prefill", prompt)
    groups = requests // batch
    return {"step_launches": dec,
            "step_comm": _comm_totals(dec_c, staged, kinds),
            "run_launches": {k: groups * (pre[k] + (new - 1) * dec[k])
                             for k in keys},
            "run_comm": _comm_totals(groups * (pre_c + (new - 1) * dec_c),
                                     staged, kinds)}


def _stationary_ok(M: int, K: int, block_k: int) -> bool:
    """An activation-stationary call of ``M`` rows over ``K`` runs B3 (its
    stripe admitted), not B1 (``kernels.ops._fused_schedule``)."""
    from repro_torch.kernels.mgs_matmul import (WS_STRIPE_BUDGET_BYTES,
                                                stationary_block,
                                                ws_stripe_bytes)
    return ws_stripe_bytes(K, stationary_block("activation", M),
                           block_k) <= WS_STRIPE_BUDGET_BYTES


def continuous_sharded_prediction(cfg, ref_launches, ref_steps: int,
                                  buckets, steps: int, rounds: int,
                                  model: int = 2, slots: int = 4,
                                  spec_k: int = 0, staged: bool = True
                                  ) -> dict:
    """Per rank of a ``1 x model`` mesh serving phase 6's traffic on the
    continuous engine (``continuous_cfg``, dense, heads / kv heads / ffn /
    vocab cut over ``model``): launches and collectives of one decode step
    of ``slots`` rows or, with ``spec_k``, one speculative round
    (``spec_k - 1`` draft steps through ``cfg.quant.draft_layers`` layers,
    one verify of ``slots x spec_k`` rows), and of a run of ``steps`` such
    steps or rounds, ``rounds`` scheduling rounds (one agreement each) and
    one prefill a prompt bucket of ``buckets``.

    Launches of a forward of M rows: each of the six whole-K projections
    (q, k, v, o, g, u) and the head is B3 where its stripe is admitted at
    M rows (``_stationary_ok``), else B1; the K-cut ``wd`` is B3's
    partials where the cut's stripe is admitted, else B1's, then the
    flush; B2 once a layer at decode. A prefill's launches depend on its
    bucket alone: they are phase 6's (``ref_launches`` of a one-card run of
    ``ref_steps`` decode steps, less the steps': 7L + 1 B3 at 4 rows),
    each prefill's ``wd`` moved to the partials and the flush.
    Collectives of a forward: a layer all-gathers the attention heads
    (bf16), all-reduces ``wd``'s per-row amax (max, float32) and its int32
    partials (sum, the segments of the whole K); the head all-gathers the
    vocab (float32 rows: M, one at a prefill's last position). gloo on one
    card stages every payload through the host (``staged``): an all-reduce
    down and back, an all-gather down and the ``model`` shards back."""
    from repro_torch.kernels.mgs_matmul import partial_segments
    L, H, hd, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    bk = cfg.quant.block_k
    kcut = cfg.d_ff // model
    _, nseg = partial_segments(cfg.d_ff, bk, None)
    keys = ("mgs_matmul_exact_fused", "mgs_matmul_exact_fused_stationary",
            "mgs_matmul_exact_partials", "mgs_matmul_stationary_partials",
            "mgs_matmul_exact_flush", "mgs_flash_attention")
    kinds = ("all_gather", "all_reduce_max", "all_reduce_sum", "agree")

    def blank():
        return ({k: 0 for k in keys},
                dict(calls=0, bytes=0, host_bytes=0, **dict.fromkeys(kinds,
                                                                    0)))

    def add(out, other, times=1):
        for a, b in zip(out, other):
            for k in a:
                a[k] += times * b[k]

    def coll(c, kind, nb):
        c["calls"] += 1
        c[kind] += 1
        c["bytes"] += nb
        c["host_bytes"] += staged * (nb * (model + 1) if kind == "all_gather"
                                     else 2 * nb)

    def forward(M: int, layers: int, head_rows: int, b2: bool):
        k, c = blank()
        projs = (d, d, d, H * hd, d, d)
        stat = sum(_stationary_ok(M, K, bk) for K in projs)
        head = _stationary_ok(head_rows, d, bk)
        k["mgs_matmul_exact_fused_stationary"] = layers * stat + head
        k["mgs_matmul_exact_fused"] = layers * (6 - stat) + 1 - head
        part = ("mgs_matmul_stationary_partials" if _stationary_ok(M, kcut, bk)
                else "mgs_matmul_exact_partials")
        k[part] = k["mgs_matmul_exact_flush"] = layers
        k["mgs_flash_attention"] = layers * b2
        for _ in range(layers):
            coll(c, "all_gather", M * (H // model) * hd * 2)
            coll(c, "all_reduce_max", M * 4)
            coll(c, "all_reduce_sum", nseg * 5 * M * d * 4)
        coll(c, "all_gather", head_rows * (cfg.vocab // model) * 4)
        return k, c

    if spec_k:
        Ld = min(cfg.quant.draft_layers or L, L)
        step = blank()
        add(step, forward(slots, Ld, slots, True), spec_k - 1)
        add(step, forward(slots * spec_k, L, slots * spec_k, True))
    else:
        step = forward(slots, L, slots, True)
    run = blank()
    add(run, step, steps)
    b3 = "mgs_matmul_exact_fused_stationary"
    # the one-card decode step: the seven projections over their whole K
    one = (L * sum(_stationary_ok(slots, K, bk)
                   for K in (d, d, d, H * hd, d, d, cfg.d_ff))
           + _stationary_ok(slots, d, bk))
    run[0][b3] += ref_launches[b3] - ref_steps * one
    run[0]["mgs_matmul_exact_fused"] += (ref_launches["mgs_matmul_exact_fused"]
                                         - ref_steps * (7 * L + 1 - one))
    for b in buckets:
        pk, pc = forward(b, L, 1, False)
        add(run, (blank()[0], pc))
        # the one-card prefill's wd, B3 or B1 over the whole K, becomes
        # the cut's partials and the flush
        whole = b3 if _stationary_ok(b, cfg.d_ff, bk) else \
            "mgs_matmul_exact_fused"
        run[0][whole] -= L
        for key in ("mgs_matmul_exact_partials",
                    "mgs_matmul_stationary_partials",
                    "mgs_matmul_exact_flush"):
            run[0][key] += pk[key]
    run[1]["calls"] += rounds
    run[1]["agree"] += rounds
    run[1]["bytes"] += 4 * rounds
    return {"step_launches": step[0], "step_comm": step[1],
            "run_launches": run[0], "run_comm": run[1]}


def _spec_gathers(spec, shape, sizes, itemsize, staged, ops=None):
    """(calls, bytes, host bytes) of gathering a leaf of ``shape`` laid
    out by ``spec`` whole: one all-gather per sharded dim, in dim order,
    each sending what this rank holds by then (each appended to ``ops``
    as ``("all_gather", payload, group)``)."""
    cur = [int(s) for s in shape]
    for i, e in enumerate(spec):
        if e is not None:
            cur[i] //= math.prod(sizes[a] for a in
                                 (e if isinstance(e, tuple) else (e,)))
    calls = nbytes = host = 0
    for i, e in enumerate(spec):
        if e is None:
            continue
        n = math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
        nb = math.prod(cur) * itemsize
        calls, nbytes = calls + 1, nbytes + nb
        host += staged * nb * (1 + n)
        if ops is not None:
            ops.append(("all_gather", nb, n))
        cur[i] *= n
    return calls, nbytes, host


def train_sharded_prediction(cfg, shape, batch: int, seq: int,
                             grad_accum: int = 1, staged: bool = True):
    """Per rank of a ``shape`` (data, model) mesh (or a
    :class:`MeshShape`, a ``pod`` axis too) training ``cfg`` on
    ``batch`` x ``seq`` tokens (``make_train_step(..., mesh=)`` in
    ``train_loop``): the collectives (calls by kind, bytes sent, bytes
    staged through the host by gloo when ``staged``: a gather's payload
    down and the ``n`` parts back, an all-reduce's down and back) of a
    step with its agreed stop flag (``step``), and of a checkpoint's
    gathers (``save``). A step gathers every parameter whole (a gather a
    sharded dim), gathers each gradient leaf over the ``D`` batch shards
    (its dtype: the parameter's at ``grad_accum`` 1, the accumulator's
    otherwise) and the (A, 3) float32 metrics, gathers a factored leaf's
    row / column factors, and max-reduces one int32 stop flag;
    ``step_ops`` lists the step's calls as ``(kind, payload, group)``."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel.sharding import train_rules
    from repro_torch.train.train_step import batch_shards, train_state_specs
    from repro_torch.tree import flatten_with_paths
    mesh = (shape if isinstance(shape, MeshShape)
            else MeshShape(("data", "model"), tuple(shape)))
    sizes = mesh.shape
    rules = train_rules(mesh)
    factored = cfg.opt_factored
    specs = train_state_specs(cfg, rules, factored)
    shapes = flatten_with_paths(param_shapes(cfg))
    pspec = flatten_with_paths(specs["params"])
    nu_specs = flatten_with_paths(specs["opt"]["nu"])
    pdt = dtype_of(cfg.param_dtype)
    _, D = batch_shards(rules, batch, seq)
    kinds = ("all_gather", "all_reduce_max", "all_reduce_sum", "barrier")

    def blank():
        return dict(calls=0, bytes=0, host_bytes=0, **{k: 0 for k in kinds})

    def add(out, kind, calls, nb, host):
        out["calls"] += calls
        out[kind] += calls
        out["bytes"] += nb
        out["host_bytes"] += host

    step, save = blank(), blank()
    ops: list = []
    f32 = 4
    for k, s in shapes.items():
        add(step, "all_gather", *_spec_gathers(pspec[k], s, sizes,
                                                pdt.itemsize, staged, ops))
        if D > 1:
            gdt = (torch.float32 if grad_accum > 1 and len(s) < 2 else pdt)
            nb = math.prod(s) * gdt.itemsize
            add(step, "all_gather", 1, nb, staged * nb * (1 + D))
            ops.append(("all_gather", nb, D))
        if factored and len(s) >= 2:
            for part, fs in (("row", s[:-1]), ("col", s[:-2] + s[-1:])):
                add(step, "all_gather", *_spec_gathers(
                    nu_specs[f"{k}/{part}"], fs, sizes, f32, staged, ops))
    if D > 1:
        nb = grad_accum * 3 * f32
        add(step, "all_gather", 1, nb, staged * nb * (1 + D))
        ops.append(("all_gather", nb, D))
    add(step, "all_reduce_max", 1, 4, staged * 8)
    ops.append(("all_reduce_max", 4, math.prod(mesh.sizes)))
    # a checkpoint gathers every state leaf whole
    flat_specs = flatten_with_paths(specs)
    for k, spec in flat_specs.items():
        if k.startswith("params/"):
            s, isz = shapes[k[7:]], pdt.itemsize
        elif k.startswith("opt/mu/"):
            s = shapes[k[7:]]
            isz = 2 if factored and len(s) >= 2 else f32
        elif k.startswith("opt/nu/"):
            name = k[7:]
            if name in shapes:
                s = shapes[name]
            else:
                base, part = name.rsplit("/", 1)
                s = shapes[base][:-1] if part == "row" else \
                    shapes[base][:-2] + shapes[base][-1:]
            isz = f32
        else:                       # opt/step: replicated
            continue
        add(save, "all_gather", *_spec_gathers(spec, s, sizes, isz, staged))
    return {"step": step, "save": save, "D": D, "step_ops": ops}


if __name__ == "__main__":
    raise SystemExit(main())
