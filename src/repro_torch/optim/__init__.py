"""Optimizer substrate of the port: SGD / AdamW, schedules and global-norm
clipping over trees of tensors."""

from . import optimizer
from .optimizer import (adamw, apply_updates, clip_by_global_norm,
                        constant_schedule, cosine_schedule, global_norm,
                        linear_warmup_cosine, sgd)

__all__ = ["optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "constant_schedule", "cosine_schedule", "global_norm",
           "linear_warmup_cosine", "sgd"]
