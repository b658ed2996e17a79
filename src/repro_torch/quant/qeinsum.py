"""Unified quantized-einsum dispatch — every model contraction routes here.

``qeinsum(spec, x, w, cfg)`` canonicalizes a 2-operand einsum into the
exact kernel's ``(M, K) @ (K, N)`` form by reshape/transpose planning
(``repro.quant.qeinsum``). Index classes:

* **batch** — in x, w and the output: one slice each, quantized with its
  own scale, all slices in one batched kernel launch (the reference
  ``vmap``\\ s ``qmatmul`` over them);
* **k** — in x and w only: flattened into K;
* **m** / **n** — x-and-output / w-and-output: flattened into M / N.

A :class:`PreparedWeight` ``w`` must already be in canonical
``batch + k + n`` order. ``cfg.dtype == "none"`` is a plain float32
``torch.einsum``. ``site`` names the call site for calibration
statistics and per-site flush planning (``quant.calibrate``).

A prepared weight sharded over a mesh of ranks (``w.layout``) contracts
this rank's part: an x whose batch dim the weight shards is sliced to this
rank's slices (an x already holding them is taken as is), an x holding
this rank's K range goes to ``qmatmul``'s K-sharded path, and the output
holds this rank's batch slices and columns. ``gather=True`` (default)
all-gathers the columns; ``gather=False`` leaves them this rank's (the
attention heads and the FFN hidden of tensor parallelism).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.mgs_matmul import ACTIVATIONS
from .config import QuantConfig
from .prepared import PreparedWeight
from .qmatmul import qmatmul

__all__ = ["qeinsum", "plan_qeinsum", "QeinsumPlan"]


@dataclasses.dataclass(frozen=True)
class QeinsumPlan:
    """Reshape/transpose plan of one canonicalized contraction."""

    x_ix: str
    w_ix: str
    out_ix: str
    batch: str
    m: str
    k: str
    n: str
    x_perm: Tuple[int, ...]
    w_perm: Tuple[int, ...]
    out_perm: Tuple[int, ...]

    @property
    def canonical_w(self) -> bool:
        return self.w_ix == self.batch + self.k + self.n


def _parse(spec: str) -> Tuple[str, str, str]:
    spec = spec.replace(" ", "")
    if "..." in spec:
        raise ValueError(f"qeinsum does not support ellipsis: {spec!r}")
    if "->" not in spec:
        raise ValueError(f"qeinsum requires an explicit output: {spec!r}")
    lhs, out_ix = spec.split("->")
    terms = lhs.split(",")
    if len(terms) != 2:
        raise ValueError(f"qeinsum is 2-operand only: {spec!r}")
    x_ix, w_ix = terms
    for term in (x_ix, w_ix, out_ix):
        if len(set(term)) != len(term):
            raise ValueError(f"repeated index in term {term!r} of {spec!r}")
    return x_ix, w_ix, out_ix


def plan_qeinsum(spec: str) -> QeinsumPlan:
    """Classify a spec's indices and derive the canonicalization plan."""
    x_ix, w_ix, out_ix = _parse(spec)
    xs, ws, outs = set(x_ix), set(w_ix), set(out_ix)
    batch = "".join(i for i in w_ix if i in xs and i in outs)
    k = "".join(i for i in w_ix if i in xs and i not in outs)
    n = "".join(i for i in w_ix if i not in xs)
    m = "".join(i for i in x_ix if i not in ws)
    if not set(m) <= outs:
        raise ValueError(f"x-only indices must appear in the output "
                         f"({spec!r}: {set(m) - outs})")
    if not set(n) <= outs:
        raise ValueError(f"w-only indices must appear in the output "
                         f"({spec!r}: {set(n) - outs})")
    if outs != set(batch) | set(m) | set(n):
        raise ValueError(f"output indices must come from the operands "
                         f"({spec!r})")
    if not k:
        raise ValueError(f"no contracted index in {spec!r}")
    x_perm = tuple(x_ix.index(i) for i in batch + m + k)
    w_perm = tuple(w_ix.index(i) for i in batch + k + n)
    canonical_out = batch + m + n
    out_perm = tuple(canonical_out.index(i) for i in out_ix)
    return QeinsumPlan(x_ix=x_ix, w_ix=w_ix, out_ix=out_ix, batch=batch,
                       m=m, k=k, n=n, x_perm=x_perm, w_perm=w_perm,
                       out_perm=out_perm)


def _sizes_of(plan: QeinsumPlan, x, w) -> Dict[str, int]:
    sizes: Dict[str, int] = {}

    def assign(term, shape, who):
        if len(term) != len(shape):
            raise ValueError(f"operand {who} rank {len(shape)} != term "
                             f"{term!r}")
        for i, s in zip(term, shape):
            if sizes.setdefault(i, int(s)) != int(s):
                raise ValueError(f"size mismatch for index {i!r}: "
                                 f"{sizes[i]} vs {s}")

    assign(plan.x_ix, x.shape, "x")
    if isinstance(w, PreparedWeight):
        if not plan.canonical_w:
            raise ValueError(
                f"PreparedWeight requires the w term in (batch, k, n) "
                f"order; got {plan.w_ix!r} (canonical: "
                f"{plan.batch + plan.k + plan.n!r})")
        stack = tuple(int(s) for s in w.codes.shape[:-2])
        if len(stack) != len(plan.batch):
            raise ValueError(
                f"PreparedWeight stack rank {len(stack)} != batch indices "
                f"{plan.batch!r}")
        assign(plan.batch, stack, "w.codes stack")
        k_flat = math.prod(sizes[i] for i in plan.k)
        k_ok = {int(w.codes.shape[-2])}
        if w.layout is not None:
            k_ok.add(int(w.layout.shape[-2]))
        if k_flat not in k_ok:
            raise ValueError(f"contracted size {k_flat} != prepared K "
                             f"{int(w.codes.shape[-2])}")
        assign(plan.n, w.local_tail, "w.tail")
    else:
        assign(plan.w_ix, w.shape, "w")
    return sizes


def _local_batch(plan: QeinsumPlan, x, w: PreparedWeight):
    """``x`` with every batch dim the weight shards cut to this rank's
    slices (an x already holding them is returned as is)."""
    lay = w.layout
    for j, i in enumerate(plan.batch):
        axes = lay.axes(j)
        if not axes:
            continue
        d = plan.x_ix.index(i)
        a, b = lay.range(j)
        if x.shape[d] == lay.shape[j]:
            x = x.narrow(d, a, b - a)
        elif x.shape[d] != b - a:
            raise ValueError(f"x's batch dim {i!r} of {x.shape[d]} is "
                             f"neither the plane's {lay.shape[j]} nor this "
                             f"rank's {b - a}")
    return x


def qeinsum(spec: str, x, w, cfg: QuantConfig, *, bias=None,
            activation: str = "none", out_dtype=None,
            flush_period: Optional[int] = None, site: Optional[str] = None,
            gather: bool = True):
    """Quantized 2-operand einsum under the numerics of ``cfg``.

    ``bias`` is a flattened-N row and, like ``activation``, requires the
    output to end with the n indices; both run in the kernel epilogue on
    the fused exact path and after the output cast otherwise. ``gather``:
    a sharded weight's columns all-gathered (module docstring).
    """
    plan = plan_qeinsum(spec)
    prepared = isinstance(w, PreparedWeight)
    lay = w.layout if prepared else None
    if lay is not None:
        x = _local_batch(plan, x, w)
        if bias is not None and lay.n_axes:
            a, b = lay.range(-1)
            bias = bias.reshape(-1)[a:b]
    sizes = _sizes_of(plan, x, w)
    if out_dtype is None:
        out_dtype = x.dtype
    n_shape = tuple(sizes[i] for i in plan.n)
    if (bias is not None or activation != "none") and not \
            plan.out_ix.endswith(plan.n):
        raise ValueError(f"bias/activation epilogue requires the output to "
                         f"end with the n indices {plan.n!r}: {spec!r}")

    if cfg.dtype == "none":
        if prepared:
            raise ValueError("PreparedWeight requires an fp8 QuantConfig")
        out = torch.einsum(f"{plan.x_ix},{plan.w_ix}->{plan.out_ix}",
                           x.to(torch.float32),
                           w.to(x.dtype).to(torch.float32))
        if bias is not None:
            out = out + bias.reshape((1,) * (out.dim() - len(n_shape))
                                     + n_shape)
        return ACTIVATIONS[activation](out.to(out_dtype))

    batch_shape = tuple(sizes[i] for i in plan.batch)
    m_shape = tuple(sizes[i] for i in plan.m)
    B = math.prod(batch_shape)
    M = math.prod(m_shape)
    K = math.prod(sizes[i] for i in plan.k)
    N = math.prod(n_shape)

    xt = x.permute(plan.x_perm)
    fuse = cfg.fused_exact
    act_in = activation if fuse else "none"

    if not plan.batch:
        w2 = w if prepared else w.permute(plan.w_perm).reshape(K, N)
        out2 = qmatmul(xt.reshape(M, K), w2, cfg, out_dtype=out_dtype,
                       bias=bias, activation=act_in,
                       flush_period=flush_period, site=site)
    else:
        if prepared:
            if lay is not None and len(batch_shape) != 1:
                raise NotImplementedError(
                    "a sharded prepared weight takes one batch index")
            s_tail = tuple(w.scale.shape[len(batch_shape):])
            wb = PreparedWeight(
                w.codes.reshape((B,) + tuple(w.codes.shape[-2:])),
                w.scale.reshape((B,) + s_tail), w.fmt_name, w.tail,
                None if w.limbs is None else
                w.limbs.reshape((B,) + tuple(w.limbs.shape[-3:])),
                w.limb_sigma, w.act_sigma, lay)
        else:
            wb = w.permute(plan.w_perm).reshape(B, K, N)
        out2 = qmatmul(xt.reshape(B, M, K), wb, cfg, out_dtype=out_dtype,
                       bias=bias, activation=act_in, batched=True,
                       flush_period=flush_period, site=site)

    out = out2.reshape(batch_shape + m_shape + n_shape)
    if gather and lay is not None and lay.n_axes:
        out = lay.mesh.all_gather(out, len(batch_shape) + len(m_shape),
                                  lay.n_axes)
    if plan.out_perm != tuple(range(out.dim())):
        out = out.permute(plan.out_perm)
    if not fuse:
        out = ACTIVATIONS[activation](out)
    return out
