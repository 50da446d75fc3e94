"""Adaptive dispatch control from live telemetry (port of
``repro.serve.telemetry``).

:class:`TelemetryController` folds per-chunk :class:`ChunkSummary`
observations into an EWMA of the observed input density and retunes two
performance-facing knobs between chunk dispatches: the masked-vs-dense
dispatch threshold and the next chunk's length.  Both are value-neutral —
chunked execution equals one-shot under any split — so adaptivity never
changes results.  Frozen mode (the default) returns the static choices and
never reads telemetry back from the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.telemetry import ChunkTelemetry, resolve_density_threshold

__all__ = ["AdaptiveDispatchConfig", "ChunkSummary", "TelemetryController",
           "adaptive_config_from_env", "make_controller", "summarize_chunk"]


@dataclass(frozen=True)
class AdaptiveDispatchConfig:
    """Knobs of the serving telemetry controller (``adaptive=False`` is
    frozen mode)."""

    adaptive: bool = False
    ewma_alpha: float = 0.25
    threshold_gain: float = 1.5
    threshold_min: float = 0.05
    threshold_max: float = 0.5
    min_chunk_steps: int = 2
    max_chunk_steps: int = 16
    shrink_retire_frac: float = 0.25
    grow_patience: int = 2


def adaptive_config_from_env() -> AdaptiveDispatchConfig:
    """Default controller config: frozen unless REPRO_ADAPTIVE_DISPATCH=1."""
    on = os.environ.get("REPRO_ADAPTIVE_DISPATCH", "0") == "1"
    return AdaptiveDispatchConfig(adaptive=on)


@dataclass(frozen=True)
class ChunkSummary:
    """Host-side reduction of one chunk's telemetry."""

    density_in: float
    layer_densities: tuple
    executed_adds: int
    tiles_skipped: int
    lanes_retired: int
    lanes_active: int
    active_lane_steps: int


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize_chunk(tel: ChunkTelemetry, layer_sizes, *, steps_before,
                    steps_after, active_before,
                    active_after) -> ChunkSummary:
    """Reduce a chunk's telemetry to controller observations (forces a
    device→host transfer; frozen callers skip it)."""
    n_spk = _np(tel.n_spk).astype(np.int64)           # (chunk, L, B)
    steps_b, steps_a = _np(steps_before), _np(steps_after)
    act_b, act_a = _np(active_before), _np(active_after)
    lane_steps = int((steps_a.astype(np.int64) - steps_b).sum())
    fan_in = np.asarray(layer_sizes[:-1], np.float64)
    spk_per_layer = n_spk.sum(axis=(0, 2)).astype(np.float64)
    denom = max(1, lane_steps)
    layer_densities = tuple(spk_per_layer / (denom * fan_in))
    tel_adds = n_spk * _np(tel.n_en)
    return ChunkSummary(
        density_in=float(layer_densities[0]),
        layer_densities=layer_densities,
        executed_adds=int(tel_adds.sum()),
        tiles_skipped=int(_np(tel.tiles_skipped).sum()),
        lanes_retired=int(np.logical_and(act_b, ~act_a).sum()),
        lanes_active=int(act_b.sum()),
        active_lane_steps=lane_steps,
    )


@dataclass
class TelemetryController:
    """EWMA density estimator + the two dispatch decisions it drives.

    Deterministic: the decision trajectory is a pure function of the
    observation sequence.
    """

    cfg: AdaptiveDispatchConfig
    static_threshold: float
    static_chunk_steps: int
    num_steps: int
    density_ewma: float | None = None
    history: list = field(default_factory=list)
    _chunk: int = 0
    _quiet: int = 0

    def __post_init__(self):
        self._chunk = self.static_chunk_steps

    @property
    def frozen(self) -> bool:
        return not self.cfg.adaptive

    @property
    def dispatch_threshold(self) -> float:
        if self.frozen or self.density_ewma is None:
            return self.static_threshold
        lo, hi = self.cfg.threshold_min, self.cfg.threshold_max
        return float(np.clip(self.cfg.threshold_gain * self.density_ewma,
                             lo, hi))

    @property
    def chunk_steps(self) -> int:
        if self.frozen:
            return self.static_chunk_steps
        return max(1, min(self._chunk, self.num_steps))

    @property
    def min_chunk_steps(self) -> int:
        if self.frozen:
            return self.static_chunk_steps
        return max(1, min(self.cfg.min_chunk_steps, self.num_steps))

    @classmethod
    def from_cache(cls, tuned, *,
                   cfg_adaptive: AdaptiveDispatchConfig | None = None,
                   num_steps: int) -> "TelemetryController":
        """Start at cache-tuned values instead of the static defaults.

        ``tuned`` is a :class:`repro_torch.tune.cache.TunedShapes` (or
        anything with ``chunk_steps`` / ``spike_density_threshold``): the
        measured winner becomes the controller's *static* choice, so
        frozen mode serves the tuned shapes with no readbacks and
        adaptive mode walks its law from them.  Duck-typed, so that
        ``serve`` does not import ``tune`` at module scope.
        """
        return cls(
            cfg=(adaptive_config_from_env() if cfg_adaptive is None
                 else cfg_adaptive),
            static_threshold=float(tuned.spike_density_threshold),
            static_chunk_steps=int(tuned.chunk_steps),
            num_steps=num_steps)

    def observe(self, summary: ChunkSummary) -> None:
        """Fold one chunk's summary into the estimator and retune (no-op
        when frozen)."""
        if self.frozen:
            return
        c = self.cfg
        if summary.active_lane_steps > 0:
            d = summary.density_in
            self.density_ewma = (d if self.density_ewma is None else
                                 (1 - c.ewma_alpha) * self.density_ewma
                                 + c.ewma_alpha * d)
        if summary.lanes_active > 0:
            frac = summary.lanes_retired / summary.lanes_active
            if frac >= c.shrink_retire_frac:
                # one step at the trigger fraction, one more per further
                # trigger-width of overshoot
                step = 1 + int((frac - c.shrink_retire_frac)
                               / c.shrink_retire_frac)
                self._chunk = max(c.min_chunk_steps, self._chunk - step)
                self._quiet = 0
            elif summary.lanes_retired == 0:
                self._quiet += 1
                if self._quiet >= c.grow_patience:
                    self._chunk = min(c.max_chunk_steps, self._chunk + 1)
                    self._quiet = 0
            else:
                self._quiet = 0
        self.history.append({
            "density_in": summary.density_in,
            "density_ewma": self.density_ewma,
            "dispatch_threshold": self.dispatch_threshold,
            "chunk_steps": self.chunk_steps,
            "lanes_retired": summary.lanes_retired,
            "executed_adds": summary.executed_adds,
            "tiles_skipped": summary.tiles_skipped,
        })


def make_controller(cfg_adaptive: AdaptiveDispatchConfig | None, *,
                    spike_density_threshold: float | None, chunk_steps: int,
                    num_steps: int) -> TelemetryController:
    """Engine-side constructor: None → the env-resolved default config."""
    return TelemetryController(
        cfg=(adaptive_config_from_env() if cfg_adaptive is None
             else cfg_adaptive),
        static_threshold=resolve_density_threshold(spike_density_threshold),
        static_chunk_steps=chunk_steps, num_steps=num_steps)
