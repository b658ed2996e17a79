"""Training of the port: AdamW and its schedules, the train step, and the
local half of int8 gradient compression."""

from . import compression
from .optimizer import (OptConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt_state, schedule_lr)
from .train_step import init_train_state, make_eval_step, make_train_step

__all__ = ["OptConfig", "adamw_update", "clip_by_global_norm", "global_norm",
           "init_opt_state", "schedule_lr", "init_train_state",
           "make_eval_step", "make_train_step", "compression"]
