"""Integer dual-accumulator MAC (dMAC) emulation (paper §5.1, Fig. 6),
the port of ``repro.core.int_dmac``.

A narrow ``narrow_bits`` accumulator takes every partial product; on
overflow it is drained into a wide accumulator and restarted with the
product, so the value is exact. Beside it, the overflow baselines the
paper compares against: clipping (saturation) and wraparound (modular).

Operands are integer tensors with the reduction on the last axis; the
leading dims broadcast and are independent dots, with the state
vectorised over them and a plain loop over K in the reference's order.
Registers are int32, as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["IntDmacStats", "int_dot_dmac", "int_dot_clip", "int_dot_wrap",
           "int_dot_exact", "average_accumulator_bits"]


class IntDmacStats(NamedTuple):
    total_macs: torch.Tensor
    narrow_adds: torch.Tensor
    wide_flushes: torch.Tensor

    @property
    def overflow_rate(self) -> torch.Tensor:
        return self.wide_flushes / torch.clamp_min(self.narrow_adds, 1)


def _products(xq: torch.Tensor, wq: torch.Tensor):
    """``(lead, K, k -> int32 product k)``: products formed one K-step at
    a time, never the whole ``lead x K`` tensor."""
    xk, wk = xq.movedim(-1, 0), wq.movedim(-1, 0)
    lead = torch.broadcast_shapes(xk.shape[1:], wk.shape[1:])
    return lead, xk.shape[0], lambda k: (xk[k].to(torch.int32)
                                         * wk[k].to(torch.int32))


def _range(narrow_bits: int):
    return -(1 << (narrow_bits - 1)), (1 << (narrow_bits - 1)) - 1


def int_dot_dmac(xq: torch.Tensor, wq: torch.Tensor, narrow_bits: int = 8):
    """Exact integer dot products by the Fig. 6 dual-accumulator scheme.

    Products must each fit the narrow register (``2 * b <= narrow_bits``
    for b-bit operands). Returns ``(value int32, IntDmacStats)``.
    """
    lo, hi = _range(narrow_bits)
    lead, K, prod = _products(xq, wq)
    dev = xq.device
    acc = torch.zeros(lead, dtype=torch.int32, device=dev)
    wide = torch.zeros_like(acc)
    n_ovf = torch.zeros_like(acc)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(K):
        p = prod(k)
        t = acc + p
        ovf = (t > hi) | (t < lo)
        wide = wide + torch.where(ovf, acc, zero)
        acc = torch.where(ovf, p, t)
        n_ovf += ovf
    n = torch.full(lead, K, dtype=torch.int32, device=dev)
    return wide + acc, IntDmacStats(total_macs=n, narrow_adds=n.clone(),
                                    wide_flushes=n_ovf)


def int_dot_clip(xq: torch.Tensor, wq: torch.Tensor, narrow_bits: int = 8,
                 *, count: bool = True):
    """Saturation arithmetic: every partial sum clips into the narrow
    range (§2.1). Returns ``(value, n_clips)``; ``count=False`` skips the
    clip count (``None``), the loop's bits unchanged."""
    lo, hi = _range(narrow_bits)
    lead, K, prod = _products(xq, wq)
    acc = torch.zeros(lead, dtype=torch.int32, device=xq.device)
    n_clip = torch.zeros_like(acc) if count else None
    for k in range(K):
        t = acc + prod(k)
        if count:
            n_clip += (t > hi) | (t < lo)
        acc = t.clamp(lo, hi)
    return acc, n_clip


def int_dot_wrap(xq: torch.Tensor, wq: torch.Tensor, narrow_bits: int = 8):
    """Wraparound (two's complement modular) narrow accumulation: each
    step ``((t + half) mod span) - half`` with a floor modulo
    (``torch.remainder``, as jnp's ``%``). The loop carries ``acc + half``,
    which is the floor modulo of the shifted sum itself, and subtracts
    ``half`` once at the end: the same integers in fewer ops a step."""
    span, half = 1 << narrow_bits, 1 << (narrow_bits - 1)
    lead, K, prod = _products(xq, wq)
    shifted = torch.full(lead, half, dtype=torch.int32, device=xq.device)
    for k in range(K):
        shifted = torch.remainder(shifted + prod(k), span)
    return shifted - half


def int_dot_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Wide (int32) reference: the exact sum, wrapped to int32."""
    p = xq.to(torch.int64) * wq.to(torch.int64)
    return p.sum(dim=-1).to(torch.int32)


def average_accumulator_bits(narrow_adds, wide_events, narrow_bits: int,
                             wide_bits: int = 32) -> torch.Tensor:
    """Average accumulator bitwidth over all adder activations (Fig. 4b /
    Fig. 9): every MAC activates the narrow adder, each overflow (and each
    final drain) also the wide one; in float32 as the reference."""
    narrow_adds = torch.as_tensor(narrow_adds, dtype=torch.float32)
    wide_events = torch.as_tensor(wide_events, dtype=torch.float32)
    total = narrow_adds + wide_events
    return (narrow_adds * narrow_bits + wide_events * wide_bits) / (
        torch.clamp_min(total, 1.0))
