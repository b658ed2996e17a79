"""Top-k routed mixture-of-experts with exact gather-based dispatch
(``repro.models.moe``).

Tokens are split into groups; within a group the router's top-k choices
claim capacity slots per expert, rank-0 choices first, earlier tokens
first, by an integer cumsum. Each slot is claimed by at most one (token,
rank) selection, so dispatch is an integer slot -> token gather and the
combine reads each token's <= ``top_k`` expert rows back in rank order,
summed by an unrolled float32 loop: no float scatter or reduction whose
order could follow the shape (on the card a float ``index_add_`` is not
even deterministic). Over-capacity selections are dropped.

The expert contractions go through :func:`~repro_torch.quant.qeinsum`
with the expert axis as a batch index: one batched launch over every
expert, each expert slice quantized with its own scale.

On a mesh the reference's constraint sites are honoured: routing runs on
replicated activations (every rank computes it identically), the dispatched
rows are cut to this rank's experts where the experts divide the model
axis (``experts_act``), the batched launches run over those experts, and
the expert outputs are all-gathered along the expert axis before the
rank-order combine. Where the experts do not divide, ``ffn`` is sharded
instead (the FFN's tensor parallelism).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import (constrain, current_rules,
                                           replicate)
from repro_torch.quant import qeinsum

__all__ = ["moe_apply"]

_GROUP_SIZE = 2048  # tokens per dispatch group


def _n_groups(n_tokens: int, cfg: ModelConfig) -> int:
    if cfg.n_groups:
        return math.gcd(cfg.n_groups, n_tokens)
    g = max(1, n_tokens // _GROUP_SIZE)
    return math.gcd(g, n_tokens)


def _route(probs: torch.Tensor, k: int, C: int):
    """Top-k selection and capacity claims of router probabilities
    ``(G, g, E)``.

    Returns ``(gates, eidx, slot, sel, slot_token, claimed)``: the
    renormalized top-k gates and expert indices ``(G, g, k)`` (ties to the
    lower expert index, as ``jax.lax.top_k``); each selection's slot in its
    expert's queue, clamped to ``C - 1``, and whether it holds one
    (``sel``; claims go rank-major, then token-major); and the claiming
    token of every ``(G, E, C)`` slot with its 0 / 1 ``claimed`` count.
    """
    G, g, E = probs.shape
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :k], eidx[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(eidx, E)                              # (G, g, k, E)
    rank_major = onehot.transpose(1, 2).reshape(G, k * g, E)
    pos = torch.cumsum(rank_major, dim=1) - 1
    pos = pos.reshape(G, k, g, E).transpose(1, 2)            # (G, g, k, E)
    slot = torch.gather(pos, 3, eidx[..., None])[..., 0]     # (G, g, k)
    sel = slot < C
    slot = slot.clamp(0, C - 1)
    # a held slot is claimed by one selection alone: integer adds of the
    # token index (and of 1) into its column; the rest go to column E * C
    col = torch.where(sel, eidx * C + slot, E * C).reshape(G, g * k)
    tok = torch.arange(g, device=probs.device)[None, :, None].expand(
        G, g, k).reshape(G, g * k)
    slot_token = torch.zeros((G, E * C + 1), dtype=torch.int64,
                             device=probs.device)
    slot_token.scatter_add_(1, col, tok)
    claimed = torch.zeros_like(slot_token).scatter_add_(
        1, col, torch.ones_like(tok))
    return (gates, eidx, slot, sel, slot_token[:, :E * C].reshape(G, E, C),
            claimed[:, :E * C].reshape(G, E, C))


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, T, d) -> (y: (B, T, d), aux: the switch load-balance loss)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    G = _n_groups(N, cfg)
    g = N // G
    C = max(1, int(math.ceil(k * g * cfg.capacity_factor / E)))
    dtype = x.dtype

    xg = constrain(x.reshape(G, g, d), ("batch", None, None))
    logits = constrain(
        qeinsum("gtd,de->gte", xg, p["wr"], cfg.quant, site="moe.wr",
                out_dtype=torch.float32), ("batch", None, None))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx, slot, sel, slot_token, claimed = _route(probs, k, C)
    density = F.one_hot(eidx[..., 0], E).to(torch.float32).mean(1)
    aux = E * torch.mean(torch.sum(density * probs.mean(1), dim=-1))

    xe = torch.gather(xg, 1, slot_token.reshape(G, E * C, 1).expand(
        G, E * C, d)).reshape(G, E, C, d)
    # the expert-parallel layout: this rank's experts where they divide
    ep_dims = ("groups_act", "experts_act", None, None)
    rules = current_rules()
    ep = () if rules is None else rules.resolve(ep_dims, (G, E, C, d))
    xe = constrain(xe * claimed[..., None].to(dtype), ep_dims)
    q = cfg.quant
    if cfg.act == "silu":
        h = qeinsum("gecd,edf->gecf", xe, p["wg"], q, site="moe.wg",
                    activation="silu", out_dtype=dtype, gather=False)
        h = h * qeinsum("gecd,edf->gecf", xe, p["wu"], q, site="moe.wu",
                        out_dtype=dtype, gather=False)
    else:
        h = qeinsum("gecd,edf->gecf", xe, p["wi"], q, site="moe.wi",
                    activation="gelu", out_dtype=dtype, gather=False)
    ye = constrain(qeinsum("gecf,efd->gecd", h, p["wd"], q, site="moe.wd",
                           out_dtype=dtype), ep_dims, ep)
    ye = replicate(ye, ep).reshape(G, E * C, d)
    # combine: each token's <= k expert rows, summed in rank order
    y = torch.zeros((G, g, d), dtype=torch.float32, device=x.device)
    row = (eidx * C + slot)[..., None]                       # (G, g, k, 1)
    w = gates * sel.to(torch.float32)
    for r in range(k):
        rows = torch.gather(ye, 1, row[:, :, r].expand(G, g, d))
        y = y + w[:, :, r, None] * rows.to(torch.float32)
    return y.to(dtype).reshape(B, T, d), aux
