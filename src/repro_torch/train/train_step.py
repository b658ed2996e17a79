"""The train step: loss and gradients, microbatch accumulation, clipping,
AdamW (the port of ``repro.train.train_step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)`` over a
state ``{"params", "opt"}`` of nested dicts of tensors. Gradients come from
``torch.autograd.grad`` over the parameter leaves; the remat policy lives
in the model (``cfg.remat``). The step is out of place: the state passed in
is left as it was.

**On a mesh** (``make_train_step(..., mesh=)``, a
:class:`~repro_torch.parallel.comm.RankMesh` of this process's rank) the
state is this rank's slice of every leaf, laid out by the reference's
train specs (:func:`train_state_specs`: ``train_rules`` over ``param_dims``
and ``opt_state_dims``), and the batch is the whole global batch. The
reference lets GSPMD partition the step; here it is written out:

1. every parameter leaf is all-gathered whole (exact), as a plain tensor;
2. the batch spec of ``("batch", "seq")`` cuts the rows into ``D`` shards;
   this rank computes shard ``i`` (its row-major index along the batch
   axes), which is microbatch ``i`` of a one-device ``grad_accum = D``
   step, with no sharding rules active: ``constrain`` is the identity and
   no collective sits inside autograd. Ranks along axes that do not cut
   the batch compute the same rows. The rules' ``seq`` cut over ``model``
   is GSPMD's layout of activations: every rank computes whole sequences
   (sequence-parallel compute is ROADMAP A12.2c);
3. each gradient leaf is all-gathered over the batch axes and the ``D``
   parts added in shard order from zeros in the accumulator dtype (the
   parameter dtype for leaves of rank >= 2, else float32), then divided by
   ``D``: the one-device ``grad_accum`` sum, op for op. No float
   ``all_reduce``: its order is the backend's;
4. the global norm and clipping run on the whole gradients, the metrics
   are combined in shard order, and AdamW updates this rank's slice (a
   factored leaf's row / column means over the whole leaf).

So a mesh step whose batch spec gives ``D`` shards is **bitwise** the
one-device step with ``grad_accum = D``: loss, aux loss, grad norm,
parameters and optimizer state. With ``grad_accum = A > 1`` on a mesh,
each rank adds its ``A`` microbatches first and the mesh divides by
``D * A``: the metrics are still the one-device ``grad_accum = D * A``
bits, the gradients are held within a tolerance only (another order of
the same sum).

Cost: every rank holds the whole parameters and gradients for the step;
this is data parallelism over sharded state, not FSDP's per-layer
gathers (ROADMAP A12.2c). On CUDA the step needs
``torch.use_deterministic_algorithms(True)``: ranks that hold the same
slice must compute the same bits, and scatter-adds would not.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.models.transformer import param_dims, param_shapes
from repro_torch.parallel.sharding import (local_slices, replicate,
                                           resolve_spec, spec_axes,
                                           train_rules)
from repro_torch.tree import flatten_with_paths, tree_map, unflatten
from .optimizer import (OptConfig, adamw_leaf, adamw_scalars, adamw_update,
                        clip_by_global_norm, init_opt_state, opt_state_dims)

__all__ = ["init_train_state", "make_train_step", "make_eval_step",
           "train_state_specs", "batch_shards"]


def init_train_state(params, factored: bool = False) -> Dict[str, Any]:
    return {"params": params, "opt": init_opt_state(params, factored)}


def train_state_specs(cfg: ModelConfig, rules, factored: bool = False):
    """The spec of every leaf of ``init_train_state``'s tree under
    ``rules`` (the reference's ``resolve_spec({"params": param_dims,
    "opt": opt_state_dims}, shapes, rules)``)."""
    shapes = param_shapes(cfg)

    def nu_shape(s):
        if factored and len(s) >= 2:
            return {"row": s[:-1], "col": s[:-2] + s[-1:]}
        return s

    pdims = param_dims(cfg)
    dims = {"params": pdims, "opt": opt_state_dims(pdims, shapes, factored)}
    state_shapes = {"params": shapes,
                    "opt": {"mu": shapes, "nu": tree_map(nu_shape, shapes),
                            "step": ()}}
    return resolve_spec(dims, state_shapes, rules)


def batch_shards(rules, batch: int, seq: int):
    """(the mesh axes that cut the batch rows, their shard count ``D``)
    under ``rules``' spec of ``("batch", "seq")``."""
    axes = spec_axes(rules.resolve(("batch", "seq"), (batch, seq)), 0)
    n = 1
    for a in axes:
        n *= rules.mesh.shape[a]
    return axes, n


def _grads_of(params, cfg: ModelConfig, batch):
    """(total loss, metrics, gradients shaped as ``params``)."""
    flat = flatten_with_paths(params)
    leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
    with torch.enable_grad():
        total, metrics = loss_fn(unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return total.detach(), metrics, unflatten(params, grads)


def _acc_dtype(p: torch.Tensor) -> torch.dtype:
    """The accumulator of a gradient sum: the parameter dtype for leaves of
    rank >= 2, float32 for the rest."""
    return p.dtype if p.dim() >= 2 else torch.float32


def _accumulate(params, cfg: ModelConfig, batch, n: int):
    """(the gradients of the ``n`` microbatches of ``batch`` summed in
    order from zeros in the accumulator dtype, undivided; their metrics in
    order)."""
    acc = tree_map(lambda p: torch.zeros(p.shape, device=p.device,
                                         dtype=_acc_dtype(p)), params)
    ms = []
    for i in range(n):
        mb = {k: _micro(v, i, n) for k, v in batch.items()}
        _, m, g = _grads_of(params, cfg, mb)
        acc = tree_map(lambda a, gg: a + gg.to(a.dtype), acc, g)
        ms.append(m)
    return acc, ms


def _mean_metrics(ms, n: int, device) -> Dict[str, Any]:
    """The microbatch metrics ``ms`` combined in order: the mean cross
    entropy and aux loss over ``n``, the tokens summed."""
    loss_sum = 0.0
    aux_sum = tok_sum = torch.zeros((), device=device)
    for m in ms:
        loss_sum = loss_sum + m["loss"]
        aux_sum = aux_sum + m["aux_loss"]
        tok_sum = tok_sum + m["tokens"]
    return {"loss": loss_sum / n, "aux_loss": aux_sum / n,
            "tokens": tok_sum}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1, mesh=None):
    """The train step of ``cfg`` under ``opt_cfg``: ``grad_accum``
    microbatches (the batch's leading axis split evenly), their gradients
    summed in the parameter dtype for leaves of rank >= 2 and in float32
    for the rest, then divided by ``grad_accum``; clipped to
    ``opt_cfg.clip_norm``; one AdamW update. Metrics: ``loss`` (the total
    with the aux term in a single-batch step, the mean cross entropy over
    microbatches otherwise, as the reference), ``aux_loss``, ``tokens``,
    ``grad_norm`` (before clipping).

    With ``mesh`` (more than one rank) the state is this rank's slice by
    :func:`train_state_specs` and the batch the global one: the mesh step
    of the module docstring.

    Training runs unquantized: the port's quantizers are integer
    bit-manipulation with no gradient, and the reference trains under no
    quantized ``QuantConfig`` either, so a quantized ``cfg`` raises."""
    if cfg.quant.dtype != "none":
        raise ValueError(
            f"{cfg.name}: training needs an unquantized model config "
            f"(quant.dtype 'none'), got {cfg.quant!r}; quantize the trained "
            "weights for evaluation instead")
    if mesh is not None and mesh.size > 1:
        return _mesh_step(cfg, opt_cfg, grad_accum, mesh)

    def step_fn(state, batch):
        params = state["params"]
        if grad_accum > 1:
            acc, ms = _accumulate(params, cfg, batch, grad_accum)
            grads = tree_map(lambda g: g / grad_accum, acc)
            metrics = _mean_metrics(ms, grad_accum, _device_of(params))
            loss = metrics["loss"]
        else:
            loss, metrics, grads = _grads_of(params, cfg, batch)

        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        new_params, new_opt = adamw_update(params, grads, state["opt"],
                                           opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return step_fn


def _ordered_sum(local, axes, mesh, n: int):
    """Every rank's ``local`` gradients along ``axes``, added leaf by leaf
    in shard order from zeros in the accumulator dtype, divided by
    ``n``."""
    def one(g):
        acc = torch.zeros(g.shape, device=g.device, dtype=_acc_dtype(g))
        for part in mesh.all_gather_parts(g, axes):
            acc = acc + part.to(acc.dtype)
        return acc / n
    return tree_map(one, local)


def _gathered_metrics(ms, axes, mesh):
    """Every rank's microbatch metrics along ``axes``, in shard order (one
    all-gather of a float32 ``(A, 3)`` tensor)."""
    mine = torch.stack([torch.stack([
        torch.as_tensor(m[k], dtype=torch.float32, device=mesh.device)
        for k in ("loss", "aux_loss", "tokens")]) for m in ms])
    return [{"loss": row[0], "aux_loss": row[1], "tokens": row[2]}
            for part in mesh.all_gather_parts(mine, axes) for row in part]


def _mesh_step(cfg: ModelConfig, opt_cfg: OptConfig, grad_accum: int, mesh):
    if mesh.device.type == "cuda" and \
            not torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            "a train step on a mesh of CUDA ranks needs "
            "torch.use_deterministic_algorithms(True) (and "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts): ranks "
            "that hold the same slice must compute the same bits")
    rules = train_rules(mesh)
    specs = train_state_specs(cfg, rules, opt_cfg.factored)

    def step_fn(state, batch):
        B, T = batch["tokens"].shape[:2]
        axes, D = batch_shards(rules, B, T)
        rows = B // D
        if rows % grad_accum:
            raise ValueError(f"{rows} rows a batch shard do not split into "
                             f"grad_accum={grad_accum} microbatches")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.coord[a]
        mine = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        params = tree_map(lambda x, s: replicate(x, s, mesh),
                          state["params"], specs["params"])
        n = D * grad_accum
        if grad_accum > 1:
            local, ms = _accumulate(params, cfg, mine, grad_accum)
        else:
            loss, metrics, local = _grads_of(params, cfg, mine)
            ms = [metrics]
        del params
        if n > 1:
            grads = _ordered_sum(local, axes, mesh, n)
            metrics = _mean_metrics(_gathered_metrics(ms, axes, mesh), n,
                                    mesh.device)
            loss = metrics["loss"]
        else:
            grads = local
        del local
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        new_params, new_opt = _sliced_adamw(state, grads, specs, mesh,
                                            opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return step_fn


def _sliced_adamw(state, grads, specs, mesh, opt_cfg: OptConfig):
    """AdamW on this rank's slices from the whole gradients; a factored
    leaf's row / column factors are gathered whole, updated, and sliced
    back."""
    step, lr, c1, c2 = adamw_scalars(state["opt"]["step"], opt_cfg)

    def one(p, g, spec, mu, nu, nu_spec):
        part = local_slices(spec, tuple(g.shape), mesh)
        if isinstance(nu, dict):
            nu = {k: replicate(nu[k], nu_spec[k], mesh) for k in nu}
        new_p, new_mu, new_nu = adamw_leaf(p, g, mu, nu, lr, c1, c2,
                                           opt_cfg, part)
        if isinstance(new_nu, dict):
            new_nu = {k: v[local_slices(nu_spec[k], tuple(v.shape),
                                        mesh)].clone()
                      for k, v in new_nu.items()}
        return new_p, new_mu, new_nu

    opt = state["opt"]
    out = tree_map(one, state["params"], grads, specs["params"], opt["mu"],
                   opt["nu"], specs["opt"]["nu"])
    new_p, new_mu, new_nu = (tree_map(lambda o, i=i: o[i], out)
                             for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}


def _device_of(tree) -> torch.device:
    return next(iter(flatten_with_paths(tree).values())).device


def _micro(x, i: int, n: int):
    """Microbatch ``i`` of ``n`` along the leading axis."""
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_eval_step(cfg: ModelConfig):
    """``(params, batch) -> metrics`` of :func:`loss_fn`, no gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, cfg, batch)
        return metrics
    return eval_step
