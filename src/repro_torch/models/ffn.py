"""Dense feed-forward blocks: SwiGLU (llama family) or GELU MLP. The gate
nonlinearity rides ``proj``'s epilogue (in-kernel on the fused path)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .linear import proj

__all__ = ["ffn_apply"]


def ffn_apply(p, x, cfg: ModelConfig):
    if cfg.act == "silu":
        h = (proj(x, p["wg"], cfg.quant, activation="silu", site="ffn.wg")
             * proj(x, p["wu"], cfg.quant, site="ffn.wu"))
    else:
        h = proj(x, p["wi"], cfg.quant, activation="gelu", site="ffn.wi")
    return proj(h, p["wd"], cfg.quant, site="ffn.wd")
