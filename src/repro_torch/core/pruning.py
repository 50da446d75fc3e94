"""Active pruning controller (paper §III-D, Fig. 3; port of
``repro.core.pruning``).

The RTL layer controller aggregates output spikes in a Spike Register and
feeds them back as enable gates: once a neuron has fired (cast its
classification vote), its datapath is clock-gated for the rest of the
inference window.  The integer LIF carries that gate as a boolean mask
(``run_lif_int``'s ``active_pruning``); this module adds the layer-level
controller on top:

* :class:`PruningState` / :func:`controller_step` — spike register, first
  spike time and enable feedback.
* the readouts: :func:`first_spike_readout` (earliest-firing neuron wins,
  membrane potential breaks ties: what the pruned RTL supports),
  :func:`count_readout`, :func:`membrane_readout`,
  :func:`peak_membrane_readout`.
* :func:`stability_early_exit` — when each input's prediction became
  final, the latency the serving stack's early exit saves.

All integer; equal to the JAX module's results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["PruningState", "init_pruning_state", "controller_step",
           "first_spike_readout", "count_readout", "membrane_readout",
           "peak_membrane_readout", "stability_early_exit"]


class PruningState(NamedTuple):
    enable: torch.Tensor         # bool (..., N): per-neuron clock gates
    spike_reg: torch.Tensor      # int32 (..., N): aggregated spike counts
    first_spike_t: torch.Tensor  # int32 (..., N): first spike step (T_max
                                 # if never)


def init_pruning_state(shape: tuple[int, ...], horizon: int, *,
                       device: str | torch.device | None = None
                       ) -> PruningState:
    dev = resolve_device(device)
    return PruningState(
        enable=torch.ones(shape, dtype=torch.bool, device=dev),
        spike_reg=torch.zeros(shape, dtype=torch.int32, device=dev),
        first_spike_t=torch.full(shape, horizon, dtype=torch.int32,
                                 device=dev))


def controller_step(state: PruningState, fired: torch.Tensor, t,
                    *, prune: bool = True) -> PruningState:
    """One controller cycle: latch spikes, record first-spike time, gate."""
    fired = fired.to(torch.bool)
    spike_reg = state.spike_reg + fired.to(torch.int32)
    first_t = torch.where(fired & (state.spike_reg == 0),
                          torch.as_tensor(t, dtype=torch.int32,
                                          device=fired.device),
                          state.first_spike_t)
    enable = state.enable & ~fired if prune else state.enable
    return PruningState(enable=enable, spike_reg=spike_reg,
                        first_spike_t=first_t)


def first_spike_readout(state: PruningState, v_final: torch.Tensor,
                        horizon: int) -> torch.Tensor:
    """Earliest-firing neuron wins; membrane potential breaks never-fired
    ties.  Fired neurons score ``(horizon - first_t) · 2^24`` (int32),
    never-fired ones their membrane clipped below that tier."""
    large = 1 << 24
    score = torch.where(
        state.spike_reg > 0,
        (horizon - state.first_spike_t) * large,
        torch.clamp(v_final, -large + 1, large - 1).to(torch.int32))
    return torch.argmax(score, dim=-1)


def count_readout(out_spikes_t: torch.Tensor) -> torch.Tensor:
    """Rate readout: argmax of spike counts over the window."""
    return torch.argmax(out_spikes_t.to(torch.int32).sum(0), dim=-1)


def membrane_readout(v_trace_t: torch.Tensor) -> torch.Tensor:
    """Argmax of the time-integrated membrane potential (ANN-conversion
    readout), summed in int64."""
    return torch.argmax(v_trace_t.to(torch.int64).sum(0), dim=-1)


def peak_membrane_readout(v_trace_t: torch.Tensor) -> torch.Tensor:
    """Argmax of the peak membrane potential over the window: the
    integer engine's ``membrane`` readout, which a running per-layer peak
    carried across chunks reproduces exactly."""
    return torch.argmax(v_trace_t.amax(dim=0), dim=-1)


def stability_early_exit(pred_t: torch.Tensor, patience: int) -> torch.Tensor:
    """Earliest timestep at which the running prediction became final.

    ``pred_t``: int (T, batch) per-step predictions.  Returns (batch,) int32:
    the first t such that pred is constant from t-patience+1..t and never
    changes after t, plus one; T if never stable.
    """
    T = pred_t.shape[0]
    agrees = (pred_t == pred_t[-1][None]).to(torch.int32)
    # suffix_all[t]: every step from t to T-1 agrees with the final one
    suffix_all = torch.flip(torch.cumprod(torch.flip(agrees, (0,)), dim=0),
                            (0,)).to(torch.bool)
    first_stable = torch.argmax(suffix_all.to(torch.int32), dim=0)
    never = ~suffix_all.any(dim=0)
    t_exit = torch.clamp(first_stable + patience - 1, max=T - 1)
    return torch.where(never, T, t_exit + 1).to(torch.int32)
