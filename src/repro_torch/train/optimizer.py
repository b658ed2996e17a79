"""AdamW and its learning-rate schedules on nested dicts of tensors (the
port of ``repro.train.optimizer``).

Plain functions, op for op the reference's, because ``torch.optim.AdamW``
is another function: it decays ``p *= 1 - lr * wd`` before the step, it
forms ``sqrt(v) / sqrt(c2)`` where the reference forms ``sqrt(v / c2)``,
and it has no factored moments. Every update is out of place: a state
passed in is never written.

Schedules: linear-warmup cosine, WSD (warmup-stable-decay, minicpm-2b's),
and constant. With ``factored``, leaves of rank >= 2 keep bfloat16 first
moments and Adafactor-style row / column second-moment factors.

:func:`opt_state_dims` names the dims of the state's leaves, so that the
sharding rules lay the moments out as the parameters (the reference's
ZeRO layout); :func:`adamw_leaf` updates one leaf, or the slice of it a
rank holds (``train_step``'s mesh step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "opt_state_dims", "adamw_update",
           "adamw_scalars", "adamw_leaf", "schedule_lr", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"       # cosine | wsd | const
    stable_frac: float = 0.8       # WSD: fraction of post-warmup steps at peak
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0
    # Adafactor-style factored second moment + bf16 momentum for >=2D
    # leaves: ~2 bytes/param of optimizer state instead of 8
    factored: bool = False


def _f32(step, device=None) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor), a float32 tensor."""
    step = _f32(step)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # stable at peak for stable_frac, then inverse-exp decay to min
        decay_t = torch.clamp((t - cfg.stable_frac)
                              / max(1 - cfg.stable_frac, 1e-6), 0.0, 1.0)
        frac = torch.where(t < cfg.stable_frac, torch.ones_like(t),
                           torch.pow(_f32(cfg.min_lr_frac, t.device),
                                     decay_t))
    elif cfg.schedule == "const":
        frac = torch.ones_like(t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * frac


def _is_factored_leaf(p: torch.Tensor, factored: bool) -> bool:
    return factored and p.dim() >= 2


def init_opt_state(params, factored: bool = False) -> Dict[str, Any]:
    """Zero moments shaped as ``params`` (``mu`` bfloat16 and ``nu`` row /
    column factors for factored leaves), and ``step`` 0 (int32)."""
    def mu_of(p):
        return torch.zeros(p.shape, device=p.device,
                           dtype=torch.bfloat16
                           if _is_factored_leaf(p, factored)
                           else torch.float32)

    def nu_of(p):
        if _is_factored_leaf(p, factored):
            return {"row": torch.zeros(p.shape[:-1], device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       device=p.device)}
        return torch.zeros(p.shape, device=p.device)

    device = leaves(params)[0].device
    return {"mu": tree_map(mu_of, params), "nu": tree_map(nu_of, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _shape_of(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def opt_state_dims(pdims, params_shapes, factored: bool = False):
    """The logical dims of :func:`init_opt_state`'s tree (the reference's
    ``opt_state_dims``): ``mu`` and an unfactored ``nu`` take each
    parameter's dims; a factored ``nu`` (leaves of rank >= 2) has ``row``
    (the dims but the last) and ``col`` (all but the second to last);
    ``step`` is ``(None,)``. ``params_shapes`` holds a tensor or a shape
    per leaf."""
    def nu_dims(d, p):
        if factored and len(_shape_of(p)) >= 2:
            return {"row": tuple(d[:-1]), "col": tuple(d[:-2]) + (d[-1],)}
        return d

    return {"mu": pdims, "nu": tree_map(nu_dims, pdims, params_shapes),
            "step": (None,)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled to a global norm of at most ``max_norm``, each leaf
    kept in its dtype; the norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm


def adamw_scalars(state_step, cfg: OptConfig):
    """(the new step, its learning rate, the bias corrections ``c1``,
    ``c2``) of one AdamW step from the state's ``step``."""
    step = state_step + 1
    lr = schedule_lr(cfg, step)
    step32 = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(cfg.beta1, step.device), step32)
    c2 = 1.0 - torch.pow(_f32(cfg.beta2, step.device), step32)
    return step, lr, c1, c2


def adamw_leaf(p, g, mu, nu, lr, c1, c2, cfg: OptConfig, part=None):
    """One leaf's AdamW update: (new p, new mu, new nu).

    ``part`` (a ``slice`` per dim) says that ``p``, ``mu`` and an
    unfactored ``nu`` hold that part of the leaf while ``g`` and a factored
    ``nu``'s ``row`` / ``col`` are whole: the factors' means run over the
    whole leaf, then the update is taken on the part. Every op is
    elementwise or one of those means, so the part of the update is the
    same bits as the whole update's part."""
    b1, b2 = cfg.beta1, cfg.beta2
    g_all = g.to(torch.float32)
    g32 = g_all if part is None else g_all[part]
    new_mu = b1 * mu.to(torch.float32) + (1 - b1) * g32
    mhat = new_mu / c1
    if isinstance(nu, dict):  # factored
        g2 = torch.square(g_all) + 1e-30
        row = b2 * nu["row"] + (1 - b2) * g2.mean(-1)
        col = b2 * nu["col"] + (1 - b2) * g2.mean(-2)
        den = torch.clamp_min(row.mean(-1, keepdim=True)[..., None], 1e-30)
        r, c = row, col
        if part is not None:
            r, c, den = row[part[:-1]], col[part[:-2] + part[-1:]], \
                den[part[:-2]]
        vhat = (r[..., None] * c[..., None, :] / den) / c2
        new_nu = {"row": row, "col": col}
    else:
        new_nu = b2 * nu + (1 - b2) * torch.square(g32)
        vhat = new_nu / c2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if p.dim() > 1:
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return ((p.to(torch.float32) - lr * delta).to(p.dtype),
            new_mu.to(mu.dtype), new_nu)


def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step: (new params, new state). Decay is skipped for leaves
    of rank <= 1 (norms, biases).

    With ``cfg.factored``, leaves of rank >= 2 keep Adafactor-style row /
    column second-moment factors (``v_ij = R_i C_j / mean(R)``) and
    bfloat16 momentum."""
    step, lr, c1, c2 = adamw_scalars(state["step"], cfg)
    out = tree_map(lambda p, g, mu, nu: adamw_leaf(p, g, mu, nu, lr, c1, c2,
                                                   cfg),
                   params, grads, state["mu"], state["nu"])
    new_p, new_mu, new_nu = (tree_map(lambda o, i=i: o[i], out)
                             for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}
