"""Model stack of the port: the dense, MoE, pure-SSM, hybrid,
encoder-decoder and vision-prefix families; serving and the teacher-forced
forward / loss of training."""

from .mamba import SSMCache, mamba_apply, mamba_decode_step
from .moe import moe_apply
from .transformer import (adopt_slot, cast_params, decode_step,
                          decode_step_paged, draft_step_paged, forward,
                          init_cache, init_paged_cache, init_params,
                          layer_params, loss_fn, prefill, release_slot,
                          rewind_slots, verify_step_paged)

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step",
           "layer_params", "cast_params", "init_paged_cache", "adopt_slot",
           "release_slot", "decode_step_paged", "verify_step_paged",
           "draft_step_paged", "rewind_slots", "moe_apply", "mamba_apply",
           "mamba_decode_step", "SSMCache"]
