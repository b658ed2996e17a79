"""Int8 gradient compression with error feedback (the port of
``repro.train.compression``).

For data-parallel configurations the gradient all-reduce dominates the
collective term at scale; compressing its payload to int8 cuts those bytes
4x against float32 at the cost of quantization noise, which an
error-feedback residual re-injects on the next step (1-bit-Adam lineage).
Each data shard quantizes its gradient plus last step's residual to int8
under one absmax scale; the int8 codes are summed exactly as int32 over the
data axes; the result is ``total * mean_scale / nrep``.

The reference writes the collective with ``shard_map`` (``psum`` of the
int32 codes, ``pmean`` of the scales); the port runs it on a
:class:`~repro_torch.parallel.comm.RankMesh`: an int32 sum all-reduce
(exact in any order) and the per-rank scales all-gathered and added in
rank order (a float ``all_reduce``'s order is the backend's). Every rank
returns the same mean. Used where the data axes replicate the parameters
(pure data parallelism), as in the reference; the reference's CLI names no
flag for it and neither does the port's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.quant.quantize import recip
from repro_torch.tree import tree_map

__all__ = ["init_error_state", "compress_leaf_psum", "make_compressed_reduce"]


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


def _compressed_parts(g, err, axes: Tuple[str, ...], mesh):
    """(the int32 sum of the ranks' codes, the mean of their scales, the
    rank count, this rank's new residual) of one leaf along ``axes``."""
    x = g.to(torch.float32) + err
    q, scale = _quantize_int8(x)
    new_err = x - q.to(torch.float32) * scale
    total = mesh.all_reduce(q.to(torch.int32), "sum", axes)
    scales = mesh.all_gather_parts(scale, axes)
    nrep = float(len(scales))
    scale_sum = torch.zeros((), dtype=torch.float32, device=scale.device)
    for s in scales:
        scale_sum = scale_sum + s
    return total, scale_sum / nrep, nrep, new_err


def compress_leaf_psum(g, err, axes: Tuple[str, ...], mesh):
    """Error-feedback int8 mean-reduce of one leaf over ``axes`` of
    ``mesh``: (the mean gradient, float32; this rank's new residual,
    float32)."""
    total, mean_scale, nrep, new_err = _compressed_parts(g, err, axes, mesh)
    return total.to(torch.float32) * mean_scale / nrep, new_err


def make_compressed_reduce(mesh, data_axes: Tuple[str, ...]):
    """``(local_grads, err) -> (mean_grads, err)`` with an int8 payload:
    ``local_grads`` are this data shard's gradients at their whole shape;
    the result is their compressed mean over ``data_axes``, leaf by leaf
    in tree order."""
    def apply(grads, err):
        out = tree_map(lambda g, e: compress_leaf_psum(g, e, data_axes,
                                                       mesh), grads, err)
        return (tree_map(lambda o: o[0], out),
                tree_map(lambda o: o[1], out))
    return apply
