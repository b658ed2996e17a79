"""Model stack of the port (dense decoder family)."""

from .transformer import (adopt_slot, cast_params, decode_step,
                          decode_step_paged, draft_step_paged, init_cache,
                          init_paged_cache, init_params, layer_params,
                          prefill, release_slot, rewind_slots,
                          verify_step_paged)

__all__ = ["init_params", "init_cache", "prefill", "decode_step",
           "layer_params", "cast_params", "init_paged_cache", "adopt_slot",
           "release_slot", "decode_step_paged", "verify_step_paged",
           "draft_step_paged", "rewind_slots"]
