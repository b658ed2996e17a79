"""Mamba-1 selective SSM block (``repro.models.mamba``; falcon-mamba).

Prefill runs a *chunked* selective scan: a loop over time chunks of
``cfg.ssm_chunk`` carries the ``(B, d_inner, N)`` state, and inside a
chunk the recurrence ``h_t = a_t h_{t-1} + b_t`` is an associative scan
in the reference's (``jax.lax.associative_scan``) pairing order, so the
float32 products and sums associate as there. Decode is one recurrence
step on a carried ``(h, conv)`` state.

The seven projections go through :func:`~repro_torch.models.linear.proj`
(the exact MGS matmul under an FP8 config); the scan and the
``d_state``-long contractions are plain float32 PyTorch, as in the
reference, which keeps them outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .common import silu
from .linear import proj

__all__ = ["SSMCache", "mamba_apply", "mamba_decode_step"]


class SSMCache(NamedTuple):
    h: torch.Tensor      # (B, d_inner, N)
    conv: torch.Tensor   # (B, d_conv - 1, d_inner)


def _causal_conv(u, w, b):
    """Depthwise causal conv by k shifted adds. u: (B, T, di), w: (k, di)."""
    k = w.shape[0]
    T = u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + w[i].to(u.dtype) * up[:, i:i + T]
    return out + b.to(u.dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p, u, cfg: ModelConfig):
    """Per-token SSM coefficients ``(dt, B, C)`` (float32) from the conv'd
    activation u (B, T, di): the weight-bearing projections, once a layer."""
    dt = _softplus(
        proj(proj(u, p["wdt_down"], cfg.quant, site="ssm.wdt_down"),
             p["wdt_up"], cfg.quant, site="ssm.wdt_up").to(torch.float32)
        + p["dt_bias"].to(torch.float32))
    Bm = proj(u, p["wB"], cfg.quant, site="ssm.wB").to(torch.float32)
    Cm = proj(u, p["wC"], cfg.quant, site="ssm.wC").to(torch.float32)
    return dt, Bm, Cm


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1])
                      + tuple(even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b):
    """Inclusive scan of the pairs ``(a, b)`` along axis 1 under
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, pairing elements as
    ``jax.lax.associative_scan`` does: adjacent pairs reduced, the
    reduced sequence scanned, the even positions filled in."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def mamba_apply(p, x, cfg: ModelConfig, h0=None, return_state: bool = False):
    """Full-sequence selective scan. x: (B, T, d) -> (B, T, d); with
    ``return_state`` also the decode state (``h`` in x's dtype)."""
    B, T, d = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    Q = max(1, min(cfg.ssm_chunk, T))
    if T % Q:
        Q = 1  # odd lengths: one token a chunk

    u_raw = proj(x, p["wx"], cfg.quant, site="ssm.wx")
    z = proj(x, p["wz"], cfg.quant, site="ssm.wz")
    u = silu(_causal_conv(u_raw, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _ssm_inputs(p, u, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))             # (di, N)
    D = p["D"].to(torch.float32)

    h = (torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for c in range(0, T, Q):
        u_c = u[:, c:c + Q].to(torch.float32)
        dt_c = dt[:, c:c + Q]
        a = torch.exp(dt_c[..., None] * A)                   # (B, Q, di, N)
        b = (dt_c * u_c)[..., None] * Bm[:, c:c + Q, None, :]
        a_cum, b_cum = _scan(a, b)
        hs = a_cum * h[:, None] + b_cum
        y = torch.einsum("bqdn,bqn->bqd", hs, Cm[:, c:c + Q])
        y = y + D * u_c
        h = hs[:, -1]
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)
    out = proj(y * silu(z), p["wo"], cfg.quant, site="ssm.wo")
    if return_state:
        return out, SSMCache(h=h.to(x.dtype), conv=_conv_tail(u_raw, cfg))
    return out


def _conv_tail(u_raw, cfg: ModelConfig):
    """The last ``d_conv - 1`` pre-conv inputs: the decode conv state."""
    k = cfg.d_conv
    B, T, di = u_raw.shape
    if T >= k - 1:
        return u_raw[:, T - (k - 1):, :]
    pad = torch.zeros((B, k - 1 - T, di), dtype=u_raw.dtype,
                      device=u_raw.device)
    return torch.cat([pad, u_raw], dim=1)


def mamba_decode_step(p, x, cache: SSMCache, cfg: ModelConfig):
    """One-token recurrence. x: (B, 1, d) -> ((B, 1, d), new cache)."""
    u_raw = proj(x, p["wx"], cfg.quant, site="ssm.wx")      # (B, 1, di)
    z = proj(x, p["wz"], cfg.quant, site="ssm.wz")
    full = torch.cat([cache.conv.to(u_raw.dtype), u_raw], dim=1)
    w = p["conv_w"].to(u_raw.dtype)
    u = (torch.einsum("bkd,kd->bd", full, w)[:, None, :]
         + p["conv_b"].to(u_raw.dtype))
    u = silu(u)
    dt, Bm, Cm = _ssm_inputs(p, u, cfg)                     # (B, 1, ...)
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = torch.exp(dt[..., None] * A)                        # (B, 1, di, N)
    b = (dt * u.to(torch.float32))[..., None] * Bm[:, :, None, :]
    h = a[:, 0] * cache.h.to(torch.float32) + b[:, 0]       # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
    y = y + p["D"].to(torch.float32) * u.to(torch.float32)
    out = proj(y.to(x.dtype) * silu(z), p["wo"], cfg.quant, site="ssm.wo")
    return out, SSMCache(h=h.to(cache.h.dtype), conv=full[:, 1:, :])
