"""Early exit: a request whose prediction has been stable for ``patience``
consecutive steps retires (the serving-layer analogue of active pruning).

Port of ``repro.serve.early_exit``'s pure stability gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["StabilityGateState", "stability_init", "stability_step"]


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
