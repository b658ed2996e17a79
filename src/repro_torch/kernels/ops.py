"""Public dispatch around the MGS matmul kernel (``repro.kernels.ops``).

``mgs_matmul`` routes exact-mode products to the fused B1 kernel wrapper
(``use_kernel=True, fused=True``: packed codes in, the scale / bias /
activation epilogue inside the kernel) or to the plain oracle
(``use_kernel=False``: epilogue applied afterwards, the same float32
operations). Batched LHS ``(..., K)`` is flattened to ``(M, K)``.

``schedule`` picks the fused kernel's loop order: ``"output"`` (B1) or a
stationary one (B3, bit-identical). :func:`_fused_schedule` sends a shape
whose K-resident stripe does not fit the card's shared memory back to
``"output"`` with a warning, never silently (the reference's contract).

The other kernels of the reference are not ported yet and raise, naming
their ROADMAP items: the pre-decomposed limb kernel (``fused=False``, B4)
and the dmac numerics (B5).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core.formats import E4M3, FPFormat, encode_bits
from . import mgs_matmul as _mm
from . import ref as _ref
from .mgs_matmul import ACTIVATIONS, mgs_matmul_exact_fused

__all__ = ["mgs_matmul", "apply_epilogue"]


def apply_epilogue(out, scale, bias, activation: str):
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return ACTIVATIONS[activation](out)


def _fused_schedule(schedule: str, M: int, K: int, block_k: int) -> str:
    """Validate/downgrade the fused kernel's schedule for an ``M x K``
    operand (``repro.kernels.ops._fused_schedule``).

    A stationary schedule keeps a ``3 x Kp x block`` int8 limb stripe in
    shared memory, ``block`` being the card's tile edge for this ``M``
    (:func:`~repro_torch.kernels.mgs_matmul.stationary_block`, not
    ``cfg.block_m`` / ``block_n``). A stripe over the budget falls back to
    ``"output"`` with a warning (bit-identical, never an error).
    """
    if schedule not in _mm.SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {_mm.SCHEDULES}")
    if schedule == "output":
        return schedule
    block = _mm.stationary_block(schedule, M)
    stripe = _mm.ws_stripe_bytes(K, block, block_k)
    # read the budget off the kernel module (one binding) so the hard
    # check in mgs_matmul_exact_fused can never disagree
    budget = _mm.WS_STRIPE_BUDGET_BYTES
    if stripe > budget:
        other = ("grid_m x more in-kernel weight decode"
                 if schedule == "weight"
                 else "grid_n x more in-kernel activation decode")
        warnings.warn(
            f"{schedule}-stationary schedule: M={M}, K={K}, block={block} "
            f"needs a {stripe} B K-resident limb stripe (> {budget} B "
            "shared-memory budget); falling back to the output-stationary "
            f"schedule (bit-identical, {other}).", stacklevel=3)
        return "output"
    return schedule


def mgs_matmul(x, w, fmt: FPFormat = E4M3, mode: str = "exact", *,
               use_kernel: bool = True, fused: bool = False,
               block_k: int = 128, flush_period: Optional[int] = None,
               schedule: str = "output", scale=None, bias=None,
               activation: str = "none"):
    """MGS quantized matmul: ``(..., K) @ (K, N)`` with exact numerics.

    ``x`` holds format-exact FP8 values (or uint8 codes); ``w`` is a
    ``(K, N)`` tensor of format-exact values or a
    :class:`repro_torch.quant.prepared.PreparedWeight` (anything with
    ``codes`` / ``values()``). The CUDA kernel picks its own M/N tiles;
    ``schedule`` selects B1 or B3 (see :func:`_fused_schedule`).
    """
    if mode != "exact":
        raise NotImplementedError(
            f"mode {mode!r}: the dmac kernel is ROADMAP item B5")
    ix_bits = fmt.mbits + 1 + fmt.emax
    if ix_bits > 21:
        raise ValueError(
            f"exact mode supports narrow-exponent formats only (E4M3/"
            f"E3M4); {fmt.name} (ix={ix_bits}b) needs dmac mode")
    prepared = hasattr(w, "codes") and hasattr(w, "values")
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    n_out = w.codes.shape[-1] if prepared else w.shape[-1]
    if not use_kernel:
        if x2.dtype == torch.uint8:
            raise ValueError("the plain path takes values, not codes")
        out = _ref.mgs_matmul_ref(x2, w.values() if prepared else w, fmt,
                                  mode)
        out = apply_epilogue(out, scale, bias, activation)
    elif not fused:
        raise NotImplementedError(
            "the pre-decomposed limb kernel (fused=False) is ROADMAP item "
            "B4; use the fused kernel or use_kernel=False")
    else:
        xc = x2 if x2.dtype == torch.uint8 else encode_bits(x2, fmt)
        wc = w.codes if prepared else encode_bits(w, fmt)
        out = mgs_matmul_exact_fused(
            xc, wc, fmt, scale=scale, bias=bias, activation=activation,
            block_k=block_k, flush_period=flush_period,
            schedule=_fused_schedule(schedule, xc.shape[0], K, block_k))
    return out.reshape(tuple(lead) + (n_out,))
