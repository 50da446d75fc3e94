"""Optimizer substrate of the port: SGD / AdamW / Adafactor, schedules,
global-norm clipping over trees of tensors, and int8 error-feedback
gradient compression for the cross-pod reduction."""

from . import compression, optimizer
from .optimizer import (adafactor, adamw, apply_updates, clip_by_global_norm,
                        constant_schedule, cosine_schedule, global_norm,
                        linear_warmup_cosine, sgd)

__all__ = ["compression", "optimizer", "adafactor", "adamw", "apply_updates",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "global_norm", "linear_warmup_cosine", "sgd"]
