"""Canonical ``(B?, M, K) @ (B?, K, N)`` quantized matmul dispatch.

``qmatmul(x, w, cfg)`` quantizes the operands, runs the configured
numerics and rescales:

  dtype=none              -> float32 matmul (the reference's f32-accumulated
                             dot; a plain product outside any kernel)
  fp8_* + accum=wide      -> FP8 operands, float32 accumulation
                             (``kernels.ref.wide_matmul_ref``, the
                             baseline the paper compares against)
  fp8_* + accum=mgs_exact -> exact fixed-point accumulation: the fused B1
                             kernel over packed codes with the
                             scale / bias / activation epilogue in-kernel
                             (``use_kernel`` and ``fused``), the B4 kernel
                             over limb planes (``use_kernel``, not
                             ``fused``; epilogue afterwards), or the plain
                             oracle
  fp8_* + accum=mgs_dmac  -> the paper's Fig. 8 numerics: the B5 kernel
                             over packed codes (``use_kernel``; a prepared
                             weight's codes, never decoded) or the plain
                             oracle; operands quantized with
                             ``cfg.fp8_margin`` so no product saturates,
                             then ``out * scale`` and the epilogue
  fp8_* + accum=swamp     -> the Fig. 3 failure baseline: products rounded
                             to the format, summed in a sequential
                             ``narrow_bits - 1``-significant-bit
                             accumulator (``kernels.ref.swamp_matmul_ref``;
                             an evaluation tool for layer-sized problems)
  int8/int5/int4 + wide, mgs_exact or mgs_dmac
                          -> symmetric integer operands and an exact
                             int32 sum (the dMAC's narrow / wide split
                             changes the energy, not the value, §5.1)
  int* + clip / wrap      -> saturating / wrapping ``narrow_bits``
                             accumulation, each output a sequential dot
                             (``core.int_dmac.int_dot_clip`` /
                             ``int_dot_wrap``)

PyTorch has no integer matmul on CUDA, and its CPU int8 matmul wraps, so
the exact integer sum is a float64 matmul over the integer values, cast
to int32: every partial sum is an integer below ``2**53``, exact in any
order on either device, and equal to the reference's int32 sum while that
cannot wrap (``K * 2**(bx-1) * 2**(bw-1) < 2**31``); past that the call
raises.

With ``batched=True`` the leading axis of ``x`` (and of a raw or prepared
``w``) indexes independent slices, each quantized with its own scale —
the reference's ``vmap`` over ``qmatmul``, here one batched kernel
launch (B1, or B3 under ``cfg.schedule``, B4 or B5). Per-row activation
scales do not fit the fused kernel's ``(1, N)`` epilogue row, so they are
applied after it (the same float32 ops).

An integer config takes raw weights only (a ``PreparedWeight`` raises
``ValueError``, as in the reference).

A prepared weight sharded over a mesh of ranks (``PreparedWeight.layout``)
holds this rank's columns and / or K range. Cut along N only, it runs the
call above on its columns (the output is this rank's columns). Cut along
K, the output cannot be a sum of per-rank float32 results, so the exact
sum is reduced as integers (:func:`_sharded_exact`): the activation's
scale is maxed over the K group first (per row under ``per_row_act``),
this rank's K range is encoded, the class partials over it
(``mgs_matmul_exact_partials``: B1's under ``schedule="output"``, B3's
under a stationary schedule that the cut's stripe admits, else B1's) are
summed by an int32 all-reduce over the K group, then flushed with the
epilogue (``mgs_matmul_exact_flush``) — the one-device bits for any cut of
K. That path is the fused kernels' (``use_kernel``, ``fused``); B4, B5 and
raw weights on a K-sharded plane raise (ROADMAP A12.2c).

``site`` names the call site (``"ffn.wg"``, ``"attn.scores"``, ...) for
calibration: under ``quant.calibrate.calibrating()`` the quantized
activation's limb histogram is recorded per site (``mgs_exact`` and
``mgs_dmac``), and the exact kernels' flush period resolves per site
(:func:`_exact_flush_period`): the engine's applied runtime state, else
the Markov plan from ``cfg.flush_target`` with the site's activation and
weight limb sigmas, else the worst-case bound. An explicit
``flush_period`` overrides all three. The period is a runtime argument of
B1, B3 and B4: a new period builds nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import encode_bits, round_to_format
from repro_torch.core.int_dmac import int_dot_clip, int_dot_wrap
from repro_torch.core.markov import plan_flush_period
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.mgs_matmul import (limb_decompose,
                                            mgs_matmul_dmac_codes,
                                            mgs_matmul_exact,
                                            mgs_matmul_exact_flush,
                                            mgs_matmul_exact_fused,
                                            mgs_matmul_exact_partials)
from .calibrate import current_calib_state, current_recorder, observe
from .config import QuantConfig
from .prepared import PreparedWeight
from .quantize import TINY, quantize_fp8, quantize_int, recip

__all__ = ["qmatmul"]

#: the exact kernels take the flush period as a C int
_MAX_PERIOD = 2**31 - 1


def _exact_flush_period(cfg: QuantConfig, w_sigma, x_sigma, site):
    """Flush period for the exact kernels: runtime state, plan, or None.

    Resolution order (the reference's):
    1. the applied runtime state's flush entry for ``site``
       (``quant.calibrate.applied_calib_state``: the engines' hot-swap
       path);
    2. the Markov plan when ``cfg.flush_target`` is set, from the site's
       observed activation limb sigma ``x_sigma`` (calibration table, else
       the prepared weight's stamped ``act_sigma``; ``None`` = the
       planner's uniform-limb default) and the weight's ``w_sigma``;
    3. ``None``: the kernels' worst-case bound.
    Python periods are clamped to the C int range.
    """
    cs = current_calib_state()
    if cs is not None and site is not None:
        fp = cs.get("flush", {}).get(site)
        if fp is not None:
            return min(int(fp), _MAX_PERIOD)
    if cfg.flush_target is None:
        return None
    return min(_MAX_PERIOD, plan_flush_period(
        cfg.block_k, target_overflow=cfg.flush_target, sigma_limb_x=x_sigma,
        sigma_limb_w=w_sigma))


def _site_flush_period(cfg: QuantConfig, w, site):
    """The exact kernels' period for ``w`` at ``site`` (no explicit one):
    the site's calibrated act sigma, else a prepared weight's stamped one,
    into :func:`_exact_flush_period`."""
    prepared = isinstance(w, PreparedWeight)
    x_sigma = cfg.act_sigma(site)
    if x_sigma is None and prepared:
        x_sigma = w.act_sigma
    return _exact_flush_period(cfg, w.limb_sigma if prepared else None,
                               x_sigma, site)


def qmatmul(x, w, cfg: QuantConfig, out_dtype=None, *, bias=None,
            activation: str = "none", batched: bool = False,
            flush_period: Optional[int] = None, site: Optional[str] = None):
    """``(..., K) @ (K, N)`` (or per-slice ``(B, M, K) @ (B, K, N)`` with
    ``batched``) under the quantized numerics of ``cfg``; ``site`` tags the
    call for calibration (module docstring)."""
    if out_dtype is None:
        out_dtype = x.dtype
    prepared = isinstance(w, PreparedWeight)
    if cfg.dtype == "none":
        if prepared:
            raise ValueError("PreparedWeight requires an fp8 QuantConfig")
        out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
        out = kops.apply_epilogue(out, None, bias, activation)
        return out.to(out_dtype)
    if cfg.is_int:
        if prepared:
            raise ValueError("PreparedWeight requires an fp8 QuantConfig")
        return _int_qmatmul(x, w, cfg, out_dtype, bias, activation, batched)
    if cfg.accum not in ("mgs_exact", "mgs_dmac", "wide", "swamp"):
        raise NotImplementedError(
            f"accum={cfg.accum} for fp8 (use wide/mgs_*/swamp)")
    fmt = cfg.fmt
    if prepared and w.fmt_name != fmt.name:
        raise ValueError(f"PreparedWeight format {w.fmt_name!r} != "
                         f"config format {fmt.name!r}")
    margin = cfg.fp8_margin
    if cfg.per_row_act:
        x_axis = -1
    else:
        x_axis = tuple(range(1, x.dim())) if batched else None
    if prepared and w.layout is not None and w.layout.k_axes:
        return _sharded_exact(x, w, cfg, x_axis, out_dtype, bias,
                              activation, batched, flush_period, site)
    qx = quantize_fp8(x, fmt, axis=x_axis, margin=margin)
    if cfg.accum in ("mgs_exact", "mgs_dmac"):
        observe(site, qx.q, fmt, batched=batched)
    if prepared:
        w_scale = w.scale
        if batched and w_scale.dim() == 1:      # per-slice scalars
            w_scale = w_scale.reshape(-1, 1, 1)
    else:
        w_axis = (1 if batched else 0) if cfg.per_channel else (
            (1, 2) if batched else None)
        qw = quantize_fp8(w, fmt, axis=w_axis, margin=margin)
        w_scale = qw.scale
    scale = qx.scale * w_scale
    if cfg.accum != "mgs_exact":
        if cfg.accum == "wide":
            out = kref.wide_matmul_ref(qx.q, w.values() if prepared else qw.q)
        elif cfg.accum == "swamp":
            out = _swamp(qx.q, w.values() if prepared else qw.q, fmt,
                         cfg.narrow_bits - 1, batched)
        elif batched and cfg.use_kernel:
            # one launch over every slice: the B5 kernel's batch axis, over
            # packed codes (a prepared weight's own)
            out = mgs_matmul_dmac_codes(
                encode_bits(qx.q, fmt),
                w.codes if prepared else encode_bits(qw.q, fmt), fmt,
                cfg.gate_subnormal)
        elif batched:
            w_vals = w.values() if prepared else qw.q
            out = torch.stack([kops.mgs_matmul(
                qx.q[b], w_vals[b], fmt, "dmac", use_kernel=False,
                gate_subnormal=cfg.gate_subnormal)
                for b in range(x.shape[0])])
        else:
            out = kops.mgs_matmul(qx.q, w if prepared else qw.q, fmt, "dmac",
                                  use_kernel=cfg.use_kernel,
                                  gate_subnormal=cfg.gate_subnormal)
        out = kops.apply_epilogue(out * scale, None, bias, activation)
        return out.to(out_dtype)
    if flush_period is None:
        flush_period = _site_flush_period(cfg, w, site)
    in_kernel = not cfg.per_row_act
    if cfg.use_kernel and cfg.fused and batched:
        # one launch over every slice: the B1 kernel's batch axis
        xc = encode_bits(qx.q, fmt)
        wc = w.codes if prepared else encode_bits(qw.q, fmt)
        out = mgs_matmul_exact_fused(
            xc, wc, fmt, scale=scale if in_kernel else None,
            bias=bias if in_kernel else None,
            activation=activation if in_kernel else "none",
            block_k=cfg.block_k, flush_period=flush_period,
            schedule=kops._fused_schedule(cfg.schedule, xc.shape[1],
                                          xc.shape[2], cfg.block_k))
    elif cfg.use_kernel and batched:
        # one launch over every slice: the B4 kernel's batch axis
        out = mgs_matmul_exact(
            limb_decompose(qx.q, fmt).movedim(0, 1),
            kops.weight_limbs(w if prepared else qw.q, fmt), fmt,
            block_k=cfg.block_k, flush_period=flush_period)
        in_kernel = False
    elif batched:
        # plain path: slice by slice, as the reference's vmap
        outs = []
        for b in range(x.shape[0]):
            wb = w.slice(b) if prepared else qw.q[b]
            outs.append(kops.mgs_matmul(
                qx.q[b], wb, fmt, "exact", use_kernel=False,
                block_k=cfg.block_k, flush_period=flush_period))
        out = torch.stack(outs)
        in_kernel = False
    else:
        out = kops.mgs_matmul(
            qx.q, w if prepared else qw.q, fmt, "exact",
            use_kernel=cfg.use_kernel, fused=cfg.fused,
            block_k=cfg.block_k, flush_period=flush_period,
            schedule=cfg.schedule,
            scale=scale if in_kernel else None,
            bias=bias if in_kernel else None,
            activation=activation if in_kernel else "none")
    if not in_kernel:
        out = kops.apply_epilogue(out, scale, bias, activation)
    return out.to(out_dtype)


def _sharded_exact(x, w: PreparedWeight, cfg: QuantConfig, x_axis,
                   out_dtype, bias, activation: str, batched: bool,
                   flush_period: Optional[int], site: Optional[str]):
    """``x @ w`` for a plane cut along K over a mesh of ranks (module
    docstring, steps (i)-(v)); ``x`` holds the whole K or this rank's
    range of it. Returns this rank's columns."""
    lay = w.layout
    if not (cfg.accum == "mgs_exact" and cfg.use_kernel and cfg.fused):
        raise NotImplementedError(
            f"a K-sharded plane runs B1's or B3's partials (mgs_exact, "
            f"use_kernel, fused); accum={cfg.accum} "
            f"use_kernel={cfg.use_kernel} fused={cfg.fused} on a K-sharded "
            "plane is ROADMAP A12.2c")
    if current_recorder() is not None:
        raise NotImplementedError("calibration on a mesh is ROADMAP A12.2c")
    fmt = cfg.fmt
    K = lay.shape[-2]
    k0, k1 = lay.range(-2)
    xf = x.to(torch.float32)
    if xf.shape[-1] == K:                  # replicated: take this K range
        q = quantize_fp8(xf, fmt, axis=x_axis, margin=cfg.fp8_margin)
        xq, x_scale = q.q[..., k0:k1], q.scale
    elif xf.shape[-1] == k1 - k0:          # already this rank's K range
        # (i) the scale is a max over the whole K: the K group's
        amax = (xf.abs().amax() if x_axis is None
                else xf.abs().amax(dim=x_axis, keepdim=True))
        amax = torch.clamp_min(lay.mesh.all_reduce(amax, "max", lay.k_axes),
                               TINY)
        x_scale = amax * recip(fmt.max_finite * cfg.fp8_margin)
        xq = round_to_format(xf / x_scale, fmt)
    else:
        raise ValueError(f"x's K {xf.shape[-1]} is neither the plane's "
                         f"{K} nor this rank's {k1 - k0}")
    w_scale = w.scale
    if batched and w_scale.dim() == 1:     # per-slice scalars
        w_scale = w_scale.reshape(-1, 1, 1)
    scale = x_scale * w_scale
    if flush_period is None:
        flush_period = _site_flush_period(cfg, w, site)
    in_kernel = not cfg.per_row_act
    # (ii) encode this K range, (iii) B1's or B3's partials over it, (iv)
    # the exact int32 sum over the K group, (v) the flush and the epilogue
    xc = encode_bits(xq, fmt)
    lead = xc.shape[:-1]
    x3 = xc if batched else xc.reshape(-1, xc.shape[-1])
    part = mgs_matmul_exact_partials(
        x3, w.codes, fmt, block_k=cfg.block_k, flush_period=flush_period,
        k_offset=k0, k_total=K,
        schedule=kops._fused_schedule(cfg.schedule, x3.shape[-2],
                                      x3.shape[-1], cfg.block_k))
    part = lay.mesh.all_reduce(part, "sum", lay.k_axes)
    out = mgs_matmul_exact_flush(
        part, fmt, scale=scale if in_kernel else None,
        bias=bias if in_kernel else None,
        activation=activation if in_kernel else "none")
    if not batched:
        out = out[0].reshape(tuple(lead) + (out.shape[-1],))
    if not in_kernel:
        out = kops.apply_epilogue(out, scale, bias, activation)
    return out.to(out_dtype)


def _swamp(xq, w_vals, fmt, acc_mantissa_bits: int, batched: bool):
    """The swamp accumulation over ``(..., K)`` rows (every slice at once
    under ``batched``)."""
    if batched:
        return kref.swamp_matmul_ref(xq, w_vals, fmt,
                                     acc_mantissa_bits=acc_mantissa_bits)
    out = kref.swamp_matmul_ref(xq.reshape(-1, xq.shape[-1]), w_vals, fmt,
                                acc_mantissa_bits=acc_mantissa_bits)
    return out.reshape(xq.shape[:-1] + (w_vals.shape[-1],))


def _int_matmul(xq: torch.Tensor, wq: torch.Tensor, bx: int,
                     bw: int) -> torch.Tensor:
    """``xq @ wq`` of integer values as an exact int32 sum: a float64
    matmul (exact: every partial sum is an integer below ``2**53``), cast
    to int32. ``bx`` / ``bw`` bound the operands' magnitudes by
    ``2**(b-1)``; a depth at which the reference's int32 sum could wrap
    raises."""
    K = xq.shape[-1]
    if K * 2 ** (bx - 1) * 2 ** (bw - 1) >= 2**31:
        raise ValueError(
            f"integer matmul of depth K={K} with {bx}-bit x {bw}-bit "
            "operands may leave int32 (the reference's accumulator wraps "
            "there); split K")
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.int32)


def _int_qmatmul(x, w, cfg: QuantConfig, out_dtype, bias, activation: str,
                 batched: bool):
    """The integer configs: symmetric int quantization of both operands
    (per slice under ``batched``), one of the accumulations, then
    ``out * scale`` and the epilogue in float32."""
    bits = cfg.int_bits
    bx, bw = min(bits, cfg.act_bits), min(bits, cfg.weight_bits)
    if cfg.per_row_act:
        x_axis = -1
    else:
        x_axis = tuple(range(1, x.dim())) if batched else None
    w_axis = (1 if batched else 0) if cfg.per_channel else (
        (1, 2) if batched else None)
    qx = quantize_int(x, bx, axis=x_axis)
    qw = quantize_int(w, bw, axis=w_axis)
    scale = qx.scale * qw.scale
    if cfg.accum in ("wide", "mgs_exact", "mgs_dmac"):
        out = _int_matmul(qx.q, qw.q, bx, bw)
    elif cfg.accum in ("clip", "wrap"):
        # every output a sequential dot: rows against the columns of w,
        # products formed one K-step at a time
        xr = qx.q if batched else qx.q.reshape(-1, qx.q.shape[-1])
        wt = qw.q.transpose(-1, -2).unsqueeze(-3)
        if cfg.accum == "clip":
            out = int_dot_clip(xr.unsqueeze(-2), wt, cfg.narrow_bits,
                               count=False)[0]
        else:
            out = int_dot_wrap(xr.unsqueeze(-2), wt, cfg.narrow_bits)
        if not batched:
            out = out.reshape(qx.q.shape[:-1] + (w.shape[-1],))
    else:
        raise NotImplementedError(f"accum={cfg.accum} for int")
    out = kops.apply_epilogue(out.to(torch.float32) * scale, None, bias,
                              activation)
    return out.to(out_dtype)
