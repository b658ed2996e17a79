"""Model stack of the port (dense decoder family)."""

from .transformer import (cast_params, decode_step, init_cache, init_params,
                          layer_params, prefill)

__all__ = ["init_params", "init_cache", "prefill", "decode_step",
           "layer_params", "cast_params"]
