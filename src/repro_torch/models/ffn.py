"""Dense feed-forward blocks: SwiGLU (llama family) or GELU MLP. The gate
nonlinearity rides ``proj``'s epilogue (in-kernel on the fused path).

On a mesh the hidden stays this rank's columns (``gather=False``): the
up projections shard ``ffn`` over their output and ``wd`` over its K, so
``wd`` takes them as its K range (tensor parallelism with the K sum reduced
as integers, ``quant.qmatmul``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .linear import proj

__all__ = ["ffn_apply"]


def ffn_apply(p, x, cfg: ModelConfig):
    if cfg.act == "silu":
        h = (proj(x, p["wg"], cfg.quant, activation="silu", site="ffn.wg",
                  gather=False)
             * proj(x, p["wu"], cfg.quant, site="ffn.wu", gather=False))
    else:
        h = proj(x, p["wi"], cfg.quant, activation="gelu", site="ffn.wi",
                 gather=False)
    return proj(h, p["wd"], cfg.quant, site="ffn.wd")
