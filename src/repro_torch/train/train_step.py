"""The train step: loss and gradients, microbatch accumulation, clipping,
AdamW (the port of ``repro.train.train_step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)`` over a
state ``{"params", "opt"}`` of nested dicts of tensors. Gradients come from
``torch.autograd.grad`` over the parameter leaves; the remat policy lives
in the model (``cfg.remat``). The step is out of place: the state passed in
is left as it was.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.tree import flatten_with_paths, tree_map, unflatten
from .optimizer import (OptConfig, adamw_update, clip_by_global_norm,
                        init_opt_state)

__all__ = ["init_train_state", "make_train_step", "make_eval_step"]


def init_train_state(params, factored: bool = False) -> Dict[str, Any]:
    return {"params": params, "opt": init_opt_state(params, factored)}


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


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1):
    """The train step of ``cfg`` under ``opt_cfg``: ``grad_accum``
    microbatches (the batch's leading axis split evenly), their gradients
    summed in the parameter dtype for leaves of rank >= 2 and in float32
    for the rest, then divided by ``grad_accum``; clipped to
    ``opt_cfg.clip_norm``; one AdamW update. Metrics: ``loss`` (the total
    with the aux term in a single-batch step, the mean cross entropy over
    microbatches otherwise, as the reference), ``aux_loss``, ``tokens``,
    ``grad_norm`` (before clipping).

    Training runs unquantized: the port's quantizers are integer
    bit-manipulation with no gradient, and the reference trains under no
    quantized ``QuantConfig`` either, so a quantized ``cfg`` raises."""
    if cfg.quant.dtype != "none":
        raise ValueError(
            f"{cfg.name}: training needs an unquantized model config "
            f"(quant.dtype 'none'), got {cfg.quant!r}; quantize the trained "
            "weights for evaluation instead")

    def step_fn(state, batch):
        params = state["params"]
        if grad_accum > 1:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, device=p.device,
                dtype=p.dtype if p.dim() >= 2 else torch.float32), params)
            loss_sum = 0.0
            aux_sum = tok_sum = torch.zeros((), device=_device_of(params))
            for i in range(grad_accum):
                mb = {k: _micro(v, i, grad_accum) for k, v in batch.items()}
                _, m, g = _grads_of(params, cfg, mb)
                acc = tree_map(lambda a, gg: a + gg.to(a.dtype), acc, g)
                loss_sum = loss_sum + m["loss"]
                aux_sum = aux_sum + m["aux_loss"]
                tok_sum = tok_sum + m["tokens"]
            grads = tree_map(lambda g: g / grad_accum, acc)
            loss = loss_sum / grad_accum
            metrics = {"loss": loss, "aux_loss": aux_sum / grad_accum,
                       "tokens": tok_sum}
        else:
            loss, metrics, grads = _grads_of(params, cfg, batch)

        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        new_params, new_opt = adamw_update(params, grads, state["opt"],
                                           opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return step_fn


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
