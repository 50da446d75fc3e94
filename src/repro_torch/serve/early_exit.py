"""Early exit: a request whose prediction has been stable for ``patience``
consecutive steps, or that emitted EOS, retires (the serving-layer analogue
of active pruning).

Port of ``repro.serve.early_exit``: the pure stability gate, and the
``early_exit_fn(last_token, logits) -> done`` gates of ``serve.generate``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..device import resolve_device

__all__ = ["eos_gate", "stability_gate", "StabilityGateState",
           "stability_init", "stability_step", "StabilityState"]


def eos_gate(eos_id: int) -> Callable:
    def gate(last_token: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        return last_token == eos_id
    return gate


class StabilityGateState(NamedTuple):
    """Per-lane gate state: previous prediction and its run length."""

    prev: torch.Tensor     # int32 (B,): last prediction (-1 = none yet)
    streak: torch.Tensor   # int32 (B,): consecutive identical predictions


def stability_init(batch: int, *,
                   device: str | torch.device | None = None
                   ) -> StabilityGateState:
    """Fresh gate state for ``batch`` lanes: no prediction yet (-1), no
    streak."""
    dev = resolve_device(device)
    return StabilityGateState(
        prev=torch.full((batch,), -1, dtype=torch.int32, device=dev),
        streak=torch.zeros((batch,), dtype=torch.int32, device=dev))


def stability_step(state: StabilityGateState, pred: torch.Tensor,
                   patience: int) -> tuple[StabilityGateState, torch.Tensor]:
    """One gate update; ``done`` is True once the prediction has repeated
    ``patience`` times."""
    pred = pred.to(torch.int32)
    streak = torch.where(pred == state.prev, state.streak + 1, 0)
    return StabilityGateState(prev=pred, streak=streak), streak >= patience


class StabilityState:
    """Stateful wrapper over the pure gate, matching the
    ``early_exit_fn(last_token, logits) -> done`` callable contract of
    ``serve.engine.generate``.  Its prediction is the argmax over all of
    ``logits``, the padded vocabulary included, as in the JAX package."""

    def __init__(self, batch: int, patience: int = 3, *,
                 device: str | torch.device | None = None):
        self.patience = patience
        self.state = stability_init(batch, device=device)

    @property
    def prev(self) -> torch.Tensor:
        return self.state.prev

    @property
    def streak(self) -> torch.Tensor:
        return self.state.streak

    def __call__(self, last_token: torch.Tensor,
                 logits: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(logits, dim=-1)
        self.state, done = stability_step(self.state, pred, self.patience)
        return done


def stability_gate(batch: int, patience: int = 3, *,
                   device: str | torch.device | None = None
                   ) -> StabilityState:
    """A :class:`StabilityState` for ``batch`` lanes on ``device`` (None =
    the CUDA card)."""
    return StabilityState(batch, patience, device=device)
