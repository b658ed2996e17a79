"""Public dispatch around the MGS matmul kernels (``repro.kernels.ops``).

``mgs_matmul`` routes a product by ``mode`` and the kernel tier:

* ``use_kernel=False``: the plain oracle (``kernels.ref``), epilogue
  applied afterwards;
* ``mode="exact", fused=True``: B1 (or B3 under a stationary
  ``schedule``) over packed codes, the scale / bias / activation epilogue
  inside the kernel;
* ``mode="exact", fused=False``: B4 over pre-decomposed limb planes — a
  prepared weight's ``limbs`` when it keeps them, else limbs decomposed
  from the weight's values (the reference's rule); the activation is
  always decomposed here, outside the kernel. The epilogue follows as
  separate float32 operations;
* ``mode="dmac"``: B5, the paper's per-product-rounded numerics, over
  packed codes (the activation encoded here, a prepared weight's
  ``codes``). It takes no epilogue: the caller rescales.

Batched LHS ``(..., K)`` is flattened to ``(M, K)``.

``schedule`` picks the fused kernel's loop order: ``"output"`` (B1) or a
stationary one (B3, bit-identical). :func:`_fused_schedule` sends a shape
whose K-resident stripe does not fit the card's shared memory back to
``"output"`` with a warning, never silently (the reference's contract).

The reference also clamps the dmac kernel's block shapes to a 2 MB VMEM
product tile and warns. Nothing of that carries over: B5's tiles are the
card's own (``csrc/mgs_dmac.cu``), it never materializes a product tile,
and dmac results do not depend on tiling (integer bin sums), so
``block_m`` / ``block_n`` are not arguments here.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core.formats import E4M3, FPFormat, encode_bits
from . import mgs_matmul as _mm
from . import ref as _ref
from .mgs_matmul import (ACTIVATIONS, limb_decompose,
                         mgs_matmul_dmac_codes, mgs_matmul_exact,
                         mgs_matmul_exact_fused)

__all__ = ["mgs_matmul", "apply_epilogue", "weight_limbs"]


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
               gate_subnormal: bool = True, block_k: int = 128,
               flush_period: Optional[int] = None, schedule: str = "output",
               scale=None, bias=None, activation: str = "none"):
    """MGS quantized matmul: ``(..., K) @ (K, N)`` with MGS numerics.

    ``x`` holds format-exact FP8 values (or uint8 codes, fused path only);
    ``w`` is a ``(K, N)`` tensor of format-exact values or a
    :class:`repro_torch.quant.prepared.PreparedWeight` (anything with
    ``codes`` / ``values()``, and ``limbs`` when kept). ``scale`` /
    ``bias`` / ``activation`` are exact-mode only. The CUDA kernels pick
    their own M/N tiles; ``schedule`` selects B1 or B3 (see
    :func:`_fused_schedule`).
    """
    if mode not in ("exact", "dmac"):
        raise ValueError(f"unknown mode {mode!r}")
    ix_bits = fmt.mbits + 1 + fmt.emax
    if mode == "exact" and ix_bits > 21:
        raise ValueError(
            f"exact mode supports narrow-exponent formats only (E4M3/"
            f"E3M4); {fmt.name} (ix={ix_bits}b) needs dmac mode")
    if mode != "exact" and (scale is not None or bias is not None
                            or activation != "none"):
        raise ValueError("epilogue (scale/bias/activation) is exact-mode "
                         "only; rescale dmac outputs in the caller")
    prepared = hasattr(w, "codes") and hasattr(w, "values")
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    n_out = w.codes.shape[-1] if prepared else w.shape[-1]
    if x2.dtype == torch.uint8 and not (use_kernel and fused
                                        and mode == "exact"):
        raise ValueError("only the fused exact kernel takes codes; pass "
                         "format-exact values")
    if not use_kernel:
        out = _ref.mgs_matmul_ref(x2, w.values() if prepared else w, fmt,
                                  mode, gate_subnormal)
        out = apply_epilogue(out, scale, bias, activation)
    elif mode == "dmac":
        # B5 over packed codes: a prepared weight's own, never its values
        out = mgs_matmul_dmac_codes(
            encode_bits(x2, fmt), w.codes if prepared else encode_bits(w, fmt),
            fmt, gate_subnormal)
    elif fused:
        xc = x2 if x2.dtype == torch.uint8 else encode_bits(x2, fmt)
        wc = w.codes if prepared else encode_bits(w, fmt)
        out = mgs_matmul_exact_fused(
            xc, wc, fmt, scale=scale, bias=bias, activation=activation,
            block_k=block_k, flush_period=flush_period,
            schedule=_fused_schedule(schedule, xc.shape[0], K, block_k))
    else:
        out = mgs_matmul_exact(
            limb_decompose(x2, fmt), weight_limbs(w, fmt), fmt,
            block_k=block_k, flush_period=flush_period)
        out = apply_epilogue(out, scale, bias, activation)
    return out.reshape(tuple(lead) + (n_out,))


def weight_limbs(w, fmt: FPFormat) -> torch.Tensor:
    """B4's weight operand: a prepared weight's resident ``limbs`` or,
    for a raw weight or a prepared one built without them, limbs
    decomposed from its values (``(*stack, 3, K, N)`` int8)."""
    prepared = hasattr(w, "codes") and hasattr(w, "values")
    limbs = getattr(w, "limbs", None) if prepared else None
    if limbs is not None:
        return limbs
    planes = limb_decompose(w.values() if prepared else w, fmt)
    return planes.movedim(0, -3)
