"""Prepared weights: quantize + encode static parameters *once*.

A static weight's absmax scale, packed FP8 codes and (for the
pre-decomposed kernel, B4) int8 limb planes are functions of the
parameter alone, so they are computed once at engine construction and
reused by every request. ``PREP_STATS`` counts builds and cache hits;
serving must keep ``prepared`` flat.

Stacked weights (leading per-layer, per-sublayer or per-expert axes) get
one scale per slice — the reference's ``vmap`` of the per-tensor
quantizer, here a loop over slices so a full-width layer stack never
holds more than one slice's float temporaries. Model code indexes a
stack axis with :meth:`PreparedWeight.slice`.

Each prepared leaf also carries the std of its weight's limb values
(``limb_sigma``, the Markov flush planner's ``sigma_w``), from an int64
histogram of the packed codes: every code maps to three balanced limbs,
so the histogram of limb values follows from the code counts with no
limb plane built, and the std is taken in float64 on the host, the same
number on the CPU and the card.

On a mesh of ranks (``rules=`` with the weight's logical dims) a rank builds
only its own slice of the planes, laid out by
:func:`repro_torch.parallel.sharding.prepared_specs` and recorded as the
weight's :class:`PlaneLayout`. The two whole-weight quantities stay whole:
each scale is a max over the whole weight (per tensor) or the whole K (per
channel), taken by a max all-reduce over the ranks holding the other
pieces, and ``limb_sigma`` comes from the code counts summed over every
piece (an int64 all-reduce: exact), so the flush planner sees the one-device
number. The cache key includes the layout.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FPFormat, decode_bits, encode_bits, \
    get_format
from repro_torch.core.markov import Pmf
from repro_torch.core.formats import round_to_format
from repro_torch.kernels.mgs_matmul import _decode_limbs, limb_decompose
from repro_torch.parallel.sharding import (local_slices, prepared_specs,
                                           spec_axes)
from .config import QuantConfig
from .quantize import TINY, quantize_fp8, recip

__all__ = ["PreparedWeight", "PlaneLayout", "prepare_weight", "prepare_params",
           "prepare_unembed", "prepare_logits_head", "PREP_STATS",
           "clear_prepared_cache"]

PREP_STATS = {"prepared": 0, "cache_hits": 0}

_CACHE: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class PlaneLayout:
    """Where a sharded prepared weight's planes live on a mesh of ranks.

    ``spec`` is the codes plane's spec over the whole ``shape`` =
    ``(*stack, K, N)`` (``N`` the flattened output axis; the limb and scale
    planes follow it); this rank holds the slice
    :func:`~repro_torch.parallel.sharding.local_slices` gives."""
    mesh: Any
    spec: tuple
    shape: Tuple[int, ...]

    def axes(self, i: int) -> Tuple[str, ...]:
        return spec_axes(self.spec, i % len(self.shape))

    @property
    def k_axes(self) -> Tuple[str, ...]:
        return self.axes(-2)

    @property
    def n_axes(self) -> Tuple[str, ...]:
        return self.axes(-1)

    def range(self, i: int) -> Tuple[int, int]:
        sl = local_slices(self.spec, self.shape, self.mesh)[i % len(
            self.shape)]
        return sl.start, sl.stop

    @property
    def group_axes(self) -> Tuple[str, ...]:
        """Every mesh axis that cuts the planes."""
        return tuple(a for i in range(len(self.shape)) for a in self.axes(i))

    def drop_leading(self) -> Optional["PlaneLayout"]:
        """The layout of one index of the leading (stack) axis."""
        if self.axes(0):
            raise ValueError("cannot take one slice of a stack axis sharded "
                             f"over {self.axes(0)}")
        spec = tuple(self.spec[1:])
        if not any(spec):
            return None
        return PlaneLayout(self.mesh, spec, self.shape[1:])

    @property
    def key(self):
        return (id(self.mesh), self.mesh.rank, tuple(self.spec),
                tuple(self.shape))


class PreparedWeight:
    """A weight quantized once, in kernel-ready planes.

    * ``codes``: uint8 ``(*stack, K, N)`` packed FP8 codes.
    * ``scale``: float32 dequantization scale, ``(*stack,)`` per tensor
      or ``(*stack, 1, N)`` per channel.
    * ``limbs``: int8 ``(*stack, 3, K, N)`` balanced limb planes, the B4
      kernel's weight operand; ``None`` unless the config streams them
      (``use_kernel and not fused``): at 3 bytes per element they would
      otherwise be dead device memory beside the codes.

    ``tail`` is the logical shape of the flattened ``N``. ``limb_sigma``
    is the observed std of the weight's limb values (one per prepared leaf,
    every stack slice pooled) and ``act_sigma`` the calibrated activation
    limb sigma of its call site (``None`` until a calibration table is
    stamped): the Markov flush planner's inputs.
    """

    def __init__(self, codes, scale, fmt_name: str, tail: Tuple[int, ...],
                 limbs=None, limb_sigma: Optional[float] = None,
                 act_sigma: Optional[float] = None,
                 layout: Optional[PlaneLayout] = None):
        self.codes = codes
        self.scale = scale
        self.fmt_name = fmt_name
        self.tail = tuple(tail)
        self.limbs = limbs
        self.limb_sigma = limb_sigma
        self.act_sigma = act_sigma
        self.layout = layout

    @property
    def local_tail(self) -> Tuple[int, ...]:
        """The logical shape of this rank's part of the flattened ``N``: a
        shard of ``N`` covers whole trailing slices of the leading tail
        dim."""
        if self.layout is None or not self.layout.n_axes or not self.tail:
            return self.tail
        n = self.codes.shape[-1]
        return (n // math.prod(self.tail[1:]),) + self.tail[1:]

    @property
    def fmt(self) -> FPFormat:
        return get_format(self.fmt_name)

    @property
    def shape(self):
        return self.codes.shape

    def values(self, dtype=torch.float32):
        """Format-exact weight values (for the plain path)."""
        return decode_bits(self.codes, self.fmt, dtype)

    def slice(self, i: int) -> "PreparedWeight":
        """The planes of leading stack index ``i`` (one layer)."""
        return PreparedWeight(
            self.codes[i], self.scale[i], self.fmt_name, self.tail,
            None if self.limbs is None else self.limbs[i], self.limb_sigma,
            self.act_sigma,
            None if self.layout is None else self.layout.drop_leading())

    def with_act_sigma(self, act_sigma: Optional[float]) -> "PreparedWeight":
        """Copy sharing the same planes, with a calibrated act sigma."""
        return PreparedWeight(self.codes, self.scale, self.fmt_name,
                              self.tail, self.limbs, self.limb_sigma,
                              act_sigma, self.layout)

    def __repr__(self):
        return (f"PreparedWeight(shape={tuple(self.codes.shape)}, "
                f"fmt={self.fmt_name}, tail={self.tail}, "
                f"limbs={self.limbs is not None}, "
                f"limb_sigma={self.limb_sigma}, act_sigma={self.act_sigma}"
                + ("" if self.layout is None else
                   f", spec={self.layout.spec}") + ")")


def _keep_limbs(cfg: QuantConfig, keep_limbs: Optional[bool]) -> bool:
    """Keep the limb planes only where the config streams them."""
    if keep_limbs is None:
        return bool(cfg.use_kernel and not cfg.fused)
    return bool(keep_limbs)


def _limb_sigma(code_counts: torch.Tensor, fmt: FPFormat) -> float:
    """Std of the limb values of codes with the given ``(256,)`` counts:
    each code contributes its three balanced limbs."""
    limbs = torch.stack(_decode_limbs(torch.arange(256, dtype=torch.uint8),
                                      fmt)).to(torch.int64).numpy()
    counts = code_counts.cpu().numpy().astype(np.int64)
    lo = int(limbs.min())
    hist = np.zeros(int(limbs.max()) - lo + 1, np.int64)
    for row in limbs:
        np.add.at(hist, row - lo, counts)
    return Pmf(lo, hist / hist.sum()).std


def _build(w, cfg: QuantConfig, stack_ndim: int, k_ndim: int,
           keep_limbs: bool, layout: Optional[PlaneLayout] = None
           ) -> PreparedWeight:
    fmt = cfg.fmt
    if stack_ndim + k_ndim >= w.dim() and not (
            stack_ndim + k_ndim == w.dim() and w.dim() >= 2):
        raise ValueError(f"weight rank {w.dim()} too small for "
                         f"stack_ndim={stack_ndim} + k_ndim={k_ndim}")
    stack = tuple(int(s) for s in w.shape[:stack_ndim])
    K = math.prod(w.shape[stack_ndim:stack_ndim + k_ndim])
    tail = tuple(int(s) for s in w.shape[stack_ndim + k_ndim:])
    n = math.prod(tail) if tail else 1
    axis = 0 if cfg.per_channel else None
    wg = w.reshape(stack + (K, n))
    if layout is not None:       # this rank's slice of (*stack, K, N)
        wg = wg[local_slices(layout.spec, layout.shape, layout.mesh)]
        stack = tuple(int(s) for s in wg.shape[:-2])
        K, n = int(wg.shape[-2]), int(wg.shape[-1])
    n_stack = math.prod(stack) if stack else 1
    w3 = wg.reshape((n_stack, K, n))
    amax = None
    if layout is not None:
        # whole-weight scales: a max over the other pieces of each slice
        # (per tensor: K and N; per channel: K)
        amax = torch.stack([
            (w3[i].to(torch.float32).abs().amax(dim=0, keepdim=True)
             if cfg.per_channel else w3[i].to(torch.float32).abs().amax())
            for i in range(n_stack)])
        over = (layout.k_axes if cfg.per_channel
                else layout.k_axes + layout.n_axes)
        amax = torch.clamp_min(layout.mesh.all_reduce(amax, "max", over),
                               TINY)
    codes = torch.empty((n_stack, K, n), dtype=torch.uint8, device=w.device)
    limbs = torch.empty((n_stack, 3, K, n), dtype=torch.int8,
                        device=w.device) if keep_limbs else None
    scales = []
    code_counts = torch.zeros(256, dtype=torch.int64, device=w.device)
    for i in range(n_stack):
        if amax is None:
            qt = quantize_fp8(w3[i], fmt, axis=axis, margin=cfg.fp8_margin)
            q, sc = qt.q, qt.scale
        else:   # quantize_fp8's ops, on the slice, with the whole amax
            sc = amax[i] * recip(fmt.max_finite * cfg.fp8_margin)
            q = round_to_format(w3[i].to(torch.float32) / sc, fmt)
        codes[i] = encode_bits(q, fmt)
        code_counts += torch.bincount(codes[i].reshape(-1), minlength=256)
        if keep_limbs:
            limbs[i] = limb_decompose(q, fmt)
        scales.append(sc)
    if layout is not None:
        code_counts = layout.mesh.all_reduce(code_counts, "sum",
                                             layout.group_axes)
    scale = torch.stack(scales)
    if stack:
        codes = codes.reshape(stack + (K, n))
        scale = scale.reshape(stack + tuple(scales[0].shape))
        if keep_limbs:
            limbs = limbs.reshape(stack + (3, K, n))
    else:
        codes, scale = codes[0], scale[0]
        if keep_limbs:
            limbs = limbs[0]
    PREP_STATS["prepared"] += 1
    return PreparedWeight(codes, scale, fmt.name, tail, limbs,
                          _limb_sigma(code_counts, fmt), layout=layout)


def _layout(w_shape, dims, rules, cfg: QuantConfig, stack_ndim: int,
            k_ndim: int) -> Optional[PlaneLayout]:
    """The planes' layout on ``rules``' mesh (``None``: replicated, or no
    mesh)."""
    if rules is None or dims is None or getattr(rules.mesh, "size", 1) == 1:
        return None
    if len(dims) != len(w_shape):
        raise ValueError(f"dims {dims} do not match the weight's shape "
                         f"{tuple(w_shape)}")
    spec, _, _ = prepared_specs(tuple(dims), tuple(w_shape), rules,
                                stack_ndim=stack_ndim, k_ndim=k_ndim,
                                per_channel=cfg.per_channel)
    if not any(spec):
        return None
    stack = tuple(int(s) for s in w_shape[:stack_ndim])
    K = math.prod(int(s) for s in w_shape[stack_ndim:stack_ndim + k_ndim])
    n = math.prod(int(s) for s in w_shape[stack_ndim + k_ndim:])
    return PlaneLayout(rules.mesh, spec, stack + (K, n))


def _cached(key, src, build):
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is src:
        PREP_STATS["cache_hits"] += 1
        return hit[1]
    pw = build()
    _CACHE[key] = (weakref.ref(src), pw)
    return pw


def prepare_weight(w: torch.Tensor, cfg: QuantConfig, *,
                   stack_ndim: int = 0, k_ndim: int = 1,
                   keep_limbs: Optional[bool] = None, dims=None,
                   rules=None) -> PreparedWeight:
    """Quantize + encode ``w`` (``(*stack, *kdims, *tail)``) under ``cfg``,
    cached per process on the tensor's identity (held weakly) and layout.
    ``keep_limbs`` (default: ``cfg.use_kernel and not cfg.fused``) also
    keeps the limb planes resident. With ``rules`` (on a mesh of ranks) and
    the weight's logical ``dims``, only this rank's slice of the planes is
    built (module docstring)."""
    if not cfg.is_fp8:
        raise ValueError(f"prepare_weight requires an fp8 dtype, got "
                         f"{cfg.dtype!r}")
    keep = _keep_limbs(cfg, keep_limbs)
    layout = _layout(w.shape, dims, rules, cfg, stack_ndim, k_ndim)
    key = (id(w), cfg.dtype, cfg.accum, cfg.per_channel, int(stack_ndim),
           int(k_ndim), keep, None if layout is None else layout.key)
    return _cached(key, w, lambda: _build(w, cfg, stack_ndim, k_ndim, keep,
                                          layout))


def prepare_unembed(embed: torch.Tensor, cfg: QuantConfig, *,
                    rules=None) -> PreparedWeight:
    """Prepared ``(d_model, vocab)`` view of a tied embedding table (with
    limb planes when ``cfg`` streams them); with ``rules``, this rank's
    slice of it, laid out by the dims ``("embed", "vocab")``."""
    if not cfg.is_fp8:
        raise ValueError(f"prepare_unembed requires an fp8 dtype, got "
                         f"{cfg.dtype!r}")
    if embed.dim() != 2:
        raise ValueError(f"embedding table must be 2D, got shape "
                         f"{tuple(embed.shape)}")
    keep = _keep_limbs(cfg, None)
    layout = _layout(embed.shape[::-1], ("embed", "vocab"), rules, cfg, 0, 1)
    key = ("unembed", id(embed), cfg.dtype, cfg.accum, cfg.per_channel, keep,
           None if layout is None else layout.key)
    return _cached(key, embed, lambda: _build(embed.transpose(0, 1), cfg, 0,
                                              1, keep, layout))


def prepare_logits_head(params, cfg: QuantConfig, *, tied: bool,
                        rules=None):
    """``params`` with the logits-head weight prepared (``unembed_prepared``
    for a tied table, a prepared ``unembed`` otherwise; with ``rules``,
    this rank's slice). Idempotent; a no-op for non-MGS configs."""
    if not (cfg.is_fp8 and cfg.accum in ("mgs_exact", "mgs_dmac")):
        return params
    if tied:
        embed = params.get("embed")
        if "unembed_prepared" in params or getattr(embed, "ndim", 0) != 2:
            return params
        out = dict(params)
        out["unembed_prepared"] = prepare_unembed(embed, cfg, rules=rules)
        return out
    w = params.get("unembed")
    if isinstance(w, PreparedWeight) or getattr(w, "ndim", 0) != 2:
        return params
    out = dict(params)
    out["unembed"] = prepare_weight(w, cfg, dims=("embed", "vocab"),
                                    rules=rules)
    return out


def clear_prepared_cache():
    _CACHE.clear()


# Weights consumed by proj / qeinsum call sites, keyed by parent module.
# The rest (embedding tables, norms, conv filters, biases, A_log, D) stay
# raw.
_PROJ_WEIGHTS = {
    "attn": {"wq", "wk", "wv", "wo"},
    "ffn": {"wg", "wu", "wi", "wd"},
    "moe": {"wr", "wg", "wu", "wi", "wd"},
    "ssm": {"wx", "wz", "wdt_down", "wdt_up", "wB", "wC", "wo"},
}
# the attention out-projection flattens (heads, head_dim) into K
_K_NDIM = {("attn", "wo"): 2}
# roots whose subtrees stack a leading per-layer axis: the decoder's layers
# (a hybrid's groups), an encoder-decoder's encoder and cross-attention
_STACKED_ROOTS = {"layers", "encoder", "cross"}
# a hybrid group's modules stacked again over its sublayers
_SUB_STACKED = {"ssm", "ffn", "moe"}


def _stack_ndim_of(path, ndim: int, k_ndim: int, hybrid: bool) -> int:
    """Leading stack axes of one weight, as the reference's logical dims
    give them (``layers`` / ``groups``, ``sub``, ``experts``): the layer
    axis under a stacked root; in a hybrid's ``layers``, the sublayer axis
    of its Mamba / FFN / MoE weights; the expert axis of the MoE expert
    weights (the router ``wr`` has none). So each (layer | group[, sub][,
    expert]) slice gets its own scale."""
    n = 1 if path[0] in _STACKED_ROOTS else 0
    if hybrid and path[0] == "layers" and path[-2] in _SUB_STACKED:
        n += 1
    if path[-2] == "moe" and path[-1] != "wr":
        n += 1
    return min(n, ndim - k_ndim - 1)


def prepare_params(params, cfg: QuantConfig, *, hybrid: bool = False,
                   dims=None, rules=None):
    """``params`` with every projection weight prepared, one scale per
    stack slice (``_stack_ndim_of``; ``hybrid``: the tree is a hybrid
    model's, ``ModelConfig.is_hybrid``). With ``rules`` and the matching
    logical ``dims`` tree (``models.transformer.param_dims``), each rank
    builds its own slice of every weight's planes. Idempotent and
    cache-backed; non-MGS configs pass through untouched."""
    if not (cfg.is_fp8 and cfg.accum in ("mgs_exact", "mgs_dmac")):
        return params

    def walk(node, dnode, path):
        if isinstance(node, dict):
            return {k: walk(v, dnode.get(k) if isinstance(dnode, dict)
                            else None, path + (k,))
                    for k, v in node.items()}
        if (len(path) >= 2 and path[-1] in _PROJ_WEIGHTS.get(path[-2], ())
                and isinstance(node, torch.Tensor) and node.dim() >= 2):
            k_ndim = _K_NDIM.get((path[-2], path[-1]), 1)
            return prepare_weight(
                node, cfg, k_ndim=k_ndim,
                stack_ndim=_stack_ndim_of(path, node.dim(), k_ndim, hybrid),
                dims=dnode if isinstance(dnode, tuple) else None,
                rules=rules)
        return node

    return walk(params, dims, ())
