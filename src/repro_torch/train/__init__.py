"""Training substrate of the port: the train step (grad-accum, clipping,
compression, streamed update) and the host-side loop (checkpointing,
straggler detection, failure hooks)."""

from .step import (TrainSettings, TrainState, cross_entropy, init_state,
                   make_loss_fn, make_optimizer, make_train_step)
from .loop import StragglerDetector, TrainLoop

__all__ = ["TrainSettings", "TrainState", "cross_entropy", "init_state",
           "make_loss_fn", "make_optimizer", "make_train_step",
           "StragglerDetector", "TrainLoop"]
