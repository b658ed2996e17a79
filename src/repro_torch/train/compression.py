"""Int8 gradient compression with error feedback: the local half of
``repro.train.compression``.

Each data-parallel shard would quantize its gradient (plus the residual
the last step's quantization left) to int8 under one absmax scale,
all-reduce the int8 payload and keep the new residual, which re-enters on
the next step. This module holds the per-shard pieces: the residual state
and the quantizer. The collective itself (``compress_leaf_psum``,
``make_compressed_reduce``: a reduce over a device mesh) belongs to the
sharded runtime, a later slice of the port (ROADMAP A12.2).
"""

from __future__ import annotations

import torch

from repro_torch.quant.quantize import recip
from repro_torch.tree import tree_map

__all__ = ["init_error_state"]


def init_error_state(grads):
    """Error-feedback residuals, one float32 zero tensor per gradient
    leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quantize_int8(x: torch.Tensor):
    """(int8 codes, scale): ``x ~ q * scale`` with ``scale = absmax / 127``
    (a multiply by the float32 reciprocal, as the reference's compiled
    divide by a constant), codes rounded half to even and clipped to
    [-127, 127]."""
    amax = torch.clamp_min(x.abs().amax(), 1e-12)
    scale = amax * recip(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale
