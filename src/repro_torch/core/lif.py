"""Leaky Integrate-and-Fire dynamics (paper §III-A/B, Fig. 1/4; port of
``repro.core.lif``).

Two datapaths share one timestep semantics: the integer one, the bit-exact
model of the RTL, and the float one (:func:`lif_step_float`,
:func:`run_lif_float`) with a surrogate-gradient spike, used to train
weights with BPTT before they are quantised onto the integer one.
Timestep ordering (Integrate → Leak → Fire/Reset):

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

__all__ = ["LIFConfig", "LIFStateInt", "LIFStateFloat", "init_state_int",
           "init_state_float", "synaptic_current_int", "lif_step_int",
           "run_lif_int", "spike_surrogate", "lif_step_float",
           "run_lif_float"]


@dataclass(frozen=True)
class LIFConfig:
    """Static LIF hyper-parameters (synthesis-time constants in the RTL)."""

    decay_shift: int = 4          # n in β = 2⁻ⁿ  (Decay-Reg)
    v_threshold: int = 128        # Threshold-Reg
    v_rest: int = 0               # restart potential
    v_min: int = -(1 << 20)       # accumulator saturation floor
    v_max: int = (1 << 20) - 1    # accumulator saturation ceiling

    @property
    def beta(self) -> float:
        return 2.0 ** (-self.decay_shift)


class LIFStateInt(NamedTuple):
    v: torch.Tensor        # int32 membrane accumulator, shape (..., N)
    enable: torch.Tensor   # bool per-neuron clock gate (True = active)


class LIFStateFloat(NamedTuple):
    v: torch.Tensor        # float32 membrane potential


def init_state_int(shape: tuple[int, ...], cfg: LIFConfig, *,
                   device: str | torch.device | None = None) -> LIFStateInt:
    dev = resolve_device(device)
    return LIFStateInt(
        v=torch.full(shape, cfg.v_rest, dtype=torch.int32, device=dev),
        enable=torch.ones(shape, dtype=torch.bool, device=dev),
    )


def init_state_float(shape: tuple[int, ...], cfg: LIFConfig, *,
                     device: str | torch.device | None = None
                     ) -> LIFStateFloat:
    return LIFStateFloat(v=torch.full(shape, float(cfg.v_rest),
                                      dtype=torch.float32,
                                      device=resolve_device(device)))


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


# ---------------------------------------------------------------------------
# Float (training) datapath with surrogate gradient
# ---------------------------------------------------------------------------

class _SpikeSurrogate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        slope = ctx.slope
        return g * (slope / (1.0 + slope * torch.abs(x)) ** 2), None


def spike_surrogate(v_minus_th: torch.Tensor,
                    slope: float = 4.0) -> torch.Tensor:
    """Heaviside spike with a fast-sigmoid surrogate derivative.

    Forward: 1[v ≥ v_th].  Backward: slope / (1 + slope·|x|)² (Zenke &
    Ganguli 2018); ``slope`` is a plain float and gets no gradient.
    """
    return _SpikeSurrogate.apply(v_minus_th, float(slope))


def lif_step_float(state: LIFStateFloat, current: torch.Tensor,
                   cfg: LIFConfig, slope: float = 4.0):
    """Float twin of :func:`lif_step_int` (same op ordering, soft
    gradients).  The hard reset is a multiply by the spike, so the
    surrogate gradient flows through the reset as well as the no-reset
    path; detaching the spike there would change the gradients."""
    v_int = state.v + current
    v_leak = v_int - v_int * cfg.beta        # == v_int * (1 - 2^-n)
    spike = spike_surrogate(v_leak - float(cfg.v_threshold), slope)
    v_new = v_leak * (1.0 - spike) + float(cfg.v_rest) * spike
    return LIFStateFloat(v=v_new), spike


def run_lif_float(spikes_t: torch.Tensor, w: torch.Tensor, cfg: LIFConfig,
                  slope: float = 4.0):
    """Run T float LIF steps over ``spikes_t`` (T, ..., n_in).  Returns
    ``(out_spikes (T, ..., N), v_trace (T, ..., N), final_state)``."""
    batch_shape = tuple(spikes_t.shape[1:-1])
    state = init_state_float(batch_shape + (int(w.shape[-1]),), cfg,
                             device=spikes_t.device)
    spk, vtr = [], []
    for s_t in spikes_t:
        state, spike = lif_step_float(state, s_t @ w, cfg, slope)
        spk.append(spike)
        vtr.append(state.v)
    return torch.stack(spk), torch.stack(vtr), state
