"""Plain oracle of the exact MGS matmul (``repro.kernels.ref``, exact mode).

``out[i, j] = sum_k x[i, k] * w[k, j]`` exactly, through 20-bit fixed-point
limbs, then one float32 combine in ascending class order — bit-identical
to the kernel in the single-flush regime (the default worst-case period
never flushes mid-K at practical depths).
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import E4M3, FPFormat, decompose
from .mgs_matmul import _limb_split, _fixed_point, _class_int32

__all__ = ["mgs_matmul_ref"]


def mgs_matmul_ref(x, w, fmt: FPFormat = E4M3, mode: str = "exact"):
    """Oracle matmul with MGS numerics. x: (M, K), w: (K, N) format-exact."""
    if mode != "exact":
        raise NotImplementedError(
            f"mode {mode!r}: the paper-faithful dmac numerics are ROADMAP "
            "item A11 (kernel B5)")
    base, nlimb = 7, 3
    k_limit = (2**31 - 1) // (nlimb * (1 << (base - 1)) ** 2)
    if x.shape[-1] > k_limit:
        raise ValueError(
            f"exact-mode reference supports contraction depth K <= "
            f"{k_limit} (unflushed int32 class sums); got {x.shape[-1]} — "
            "use the kernel path")
    sx, ex = decompose(x, fmt)
    sw, ew = decompose(w, fmt)
    lx = [l.to(torch.float64) for l in _limb_split(_fixed_point(sx, ex))]
    lw = [l.to(torch.float64) for l in _limb_split(_fixed_point(sw, ew))]
    accs = [None] * (2 * nlimb - 1)
    for a in range(nlimb):
        for b in range(nlimb):
            part = torch.matmul(lx[a], lw[b])
            c = a + b
            accs[c] = part if accs[c] is None else accs[c] + part
    out = _class_int32(accs[0]).to(torch.float32)
    for c in range(1, 2 * nlimb - 1):
        out = out + _class_int32(accs[c]).to(torch.float32) * float(
            2 ** (base * c))
    return out * 2.0 ** (-2 * (fmt.bias + fmt.mbits))
