"""Integer Leaky Integrate-and-Fire dynamics (paper §III-A/B, Fig. 1/4).

The bit-exact model of the RTL datapath, ported from the integer half of
``repro.core.lif``.  Timestep ordering (Integrate → Leak → Fire/Reset):

    I[t]   = Σ_i W_i · S_i[t]                 (Adder, spike-gated)
    V'     = clip(V[t-1] + I[t], v_min, v_max) (saturating Accumulator)
    V''    = V' - (V' >> n)                   (arithmetic shift leak)
    fire   = V'' ≥ V_th                       (Comparator)
    V[t]   = fire ? V_rest : V''              (hard reset)

Active pruning (§III-D) enters as an ``enable`` mask: a disabled neuron's
accumulator is frozen and it cannot fire.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["LIFConfig", "LIFStateInt", "init_state_int",
           "synaptic_current_int", "lif_step_int", "run_lif_int"]


@dataclass(frozen=True)
class LIFConfig:
    """Static LIF hyper-parameters (synthesis-time constants in the RTL)."""

    decay_shift: int = 4          # n in β = 2⁻ⁿ  (Decay-Reg)
    v_threshold: int = 128        # Threshold-Reg
    v_rest: int = 0               # restart potential
    v_min: int = -(1 << 20)       # accumulator saturation floor
    v_max: int = (1 << 20) - 1    # accumulator saturation ceiling


class LIFStateInt(NamedTuple):
    v: torch.Tensor        # int32 membrane accumulator, shape (..., N)
    enable: torch.Tensor   # bool per-neuron clock gate (True = active)


def init_state_int(shape: tuple[int, ...], cfg: LIFConfig, *,
                   device: str | torch.device | None = None) -> LIFStateInt:
    dev = resolve_device(device)
    return LIFStateInt(
        v=torch.full(shape, cfg.v_rest, dtype=torch.int32, device=dev),
        enable=torch.ones(shape, dtype=torch.bool, device=dev),
    )


def synaptic_current_int(spikes: torch.Tensor, w_q: torch.Tensor,
                         dot_impl: str = "int32") -> torch.Tensor:
    """I = Σ_i W_i · S_i with S ∈ {0,1}, as an exact int32 result.

    ``spikes``: bool/int ``(..., n_in)``; ``w_q``: int ``(n_in, n_out)``.
    CUDA has no integer matrix product, so ``"int32"`` contracts in
    float64, exact while |Σ| < 2^53 (here |Σ| ≤ n_in·256).  ``"f32"``
    contracts in float32, exact while |Σ| < 2^24 — and only in full
    float32, so it refuses to run on the card while TF32 is allowed.
    """
    if dot_impl == "int32":
        dt = torch.float64
    elif dot_impl == "f32":
        if w_q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("dot_impl='f32' is exact only in full float32;"
                               " set torch.backends.cuda.matmul.allow_tf32 ="
                               " False")
        dt = torch.float32
    else:
        raise ValueError(f"unknown dot_impl {dot_impl!r}")
    return torch.matmul(spikes.to(dt), w_q.to(dt)).to(torch.int32)


def lif_step_int(state: LIFStateInt, current: torch.Tensor, cfg: LIFConfig):
    """One RTL timestep; returns ``(new_state, fired)`` (fired is bool)."""
    v_prev = state.v
    v_int = torch.clamp(v_prev + current, cfg.v_min, cfg.v_max)
    v_leak = v_int - (v_int >> cfg.decay_shift)
    fired = v_leak >= cfg.v_threshold
    v_new = torch.where(fired, torch.full_like(v_leak, cfg.v_rest), v_leak)
    v_out = torch.where(state.enable, v_new, v_prev)
    fired = fired & state.enable
    return LIFStateInt(v=v_out, enable=state.enable), fired


def run_lif_int(spikes_t: torch.Tensor, w_q: torch.Tensor, cfg: LIFConfig, *,
                active_pruning: bool = False,
                init: LIFStateInt | None = None, dot_impl: str = "int32"):
    """Run T timesteps of one integer LIF layer.

    ``spikes_t``: bool ``(T, ..., n_in)``.  Returns a dict with ``spikes``
    (T, ..., n_out) bool, ``v_trace`` (T, ..., n_out) int32, the final
    ``state`` and ``active_adds`` (T, ...) — executed synaptic additions per
    step (input spikes × enabled outputs).
    """
    batch_shape = tuple(spikes_t.shape[1:-1])
    n_out = w_q.shape[-1]
    state = init if init is not None else init_state_int(
        batch_shape + (n_out,), cfg, device=spikes_t.device)
    spk, vtr, adds = [], [], []
    for s_t in spikes_t:
        current = synaptic_current_int(s_t, w_q, dot_impl)
        current = torch.where(state.enable, current, 0)
        n_spk = s_t.to(torch.int32).sum(-1, dtype=torch.int32)
        n_en = state.enable.sum(-1, dtype=torch.int32)
        state, fired = lif_step_int(state, current, cfg)
        if active_pruning:
            state = state._replace(enable=state.enable & ~fired)
        spk.append(fired)
        vtr.append(state.v)
        adds.append(n_spk * n_en)
    return {"spikes": torch.stack(spk), "v_trace": torch.stack(vtr),
            "state": state, "active_adds": torch.stack(adds)}
