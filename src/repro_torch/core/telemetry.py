"""Kernel↔host activity telemetry (port of ``repro.core.telemetry``).

:class:`ChunkTelemetry` is the per-chunk activity record every backend of
the integer engine emits — per-step, per-layer input-spike counts and
prune-enable occupancy per lane, plus the 128×128 tile pairs the
event-driven contraction skipped per 8-lane batch block.  The record is
bit-checkable across backends: the CUDA stack kernel emits it as kernel
outputs, the plain paths re-derive it.  The tile leaf is defined by the
reference launch geometry (128-wide neuron tiles, ``block_b_for`` batch
blocks), whatever tiling a kernel uses internally.

On a (data × model) mesh (port of ``telemetry_partition_specs``' layout)
the per-lane leaves concatenate the data shards' lanes, each derived from
the full gathered arrays, and the tile leaf concatenates per-shard skip
counts on the block axis, data-outer and model-inner: every model peer
counts the tile pairs of its own weight shard, and a replicated layer is
listed once per peer (:func:`model_tile_skips`,
:func:`concat_shard_telemetry`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

__all__ = ["ChunkTelemetry", "EngineLoad", "MatmulTelemetry",
           "engine_load_to_wire", "engine_load_from_wire", "load_score",
           "estimate_eta_steps",
           "DEFAULT_SPIKE_DENSITY_THRESHOLD",
           "resolve_density_threshold", "resolve_sparse_skip", "tiles_total",
           "tile_any", "layer_tile_skips", "concat_telemetry",
           "model_tile_skips",
           "concat_shard_telemetry"]

DEFAULT_SPIKE_DENSITY_THRESHOLD = 0.25


def resolve_density_threshold(threshold: float | None = None) -> float:
    """Explicit value → env ``REPRO_SPIKE_DENSITY_THRESHOLD`` → default."""
    if threshold is not None:
        return float(threshold)
    env = os.environ.get("REPRO_SPIKE_DENSITY_THRESHOLD")
    if env:
        return float(env)
    return DEFAULT_SPIKE_DENSITY_THRESHOLD


def resolve_sparse_skip(sparse_skip: bool | None) -> bool:
    """None → the ``REPRO_SPARSE_SKIP`` env default (on unless set to "0")."""
    if sparse_skip is None:
        return os.environ.get("REPRO_SPARSE_SKIP", "1") != "0"
    return bool(sparse_skip)


class ChunkTelemetry(NamedTuple):
    """Per-chunk activity record.

      n_spk          (chunk, L, B) int32 — input spikes layer ``l``
                     consumed at step ``t`` per lane (zero for lanes the
                     stability gate had frozen)
      n_en           (chunk, L, B) int32 — enabled neurons of layer ``l``
                     (zero for frozen lanes)
      tiles_skipped  (chunk, L, n_blocks) int32 — 128×128 tile pairs with
                     no spike in their K-slice or no enabled neuron in
                     their output slice, per 8-lane block (0 when
                     ``sparse_skip`` is off)
    """

    n_spk: torch.Tensor
    n_en: torch.Tensor
    tiles_skipped: torch.Tensor

    @property
    def adds(self) -> torch.Tensor:
        """Executed synaptic adds per (step, layer, lane) — n_spk · n_en."""
        return self.n_spk * self.n_en

    def densities(self, layer_sizes) -> torch.Tensor:
        """Observed input-spike density per (step, layer, lane) in [0, 1]
        (float32): layer ``l``'s spikes over its fan-in
        ``layer_sizes[l]``, the quantity the masked-vs-dot dispatch
        threshold is compared against."""
        fan_in = torch.tensor([float(n) for n in layer_sizes[:-1]],
                              dtype=torch.float32, device=self.n_spk.device)
        return self.n_spk.to(torch.float32) / fan_in[None, :, None]


class EngineLoad(NamedTuple):
    """Host-side load summary of one serving engine (router currency).

    Every field is free host bookkeeping or an estimate the telemetry loop
    keeps without device syncs: ``mean_service_steps`` is the EWMA of the
    window steps retired requests consumed, ``density_ewma`` the adaptive
    controller's estimate (``None`` when frozen or unobserved).  The
    health fields (``serve.faults``) default to a healthy engine.  The
    serving tier routes by :func:`load_score` and gates admission with
    :func:`estimate_eta_steps`, both pure functions of this record.
    """

    lanes_total: int               # batch-tile slots the engine owns
    lanes_busy: int                # slots currently bound to a request
    queue_depth: int               # host-queue requests not yet admitted
    mean_service_steps: float      # EWMA of consumed steps per request
    retired_total: int             # requests completed since construction
    density_ewma: float | None     # controller estimate (None if frozen)
    consecutive_faults: int = 0    # dispatch faults since the last clean chunk
    demotion_level: int = 0        # rungs down the backend degradation ladder
    watchdog_margin: int | None = None  # chunks left before the hang deadline
    alive: bool = True             # False once the engine declared failure

    @property
    def occupancy(self) -> float:
        """Fraction of lane slots currently serving a request."""
        return self.lanes_busy / max(1, self.lanes_total)


def engine_load_to_wire(load: EngineLoad) -> dict:
    """JSON-safe dict of one load record: every field is already a JSON
    scalar, and :func:`engine_load_from_wire` restores it exactly."""
    return dict(load._asdict())


def engine_load_from_wire(d: dict) -> EngineLoad:
    """Inverse of :func:`engine_load_to_wire` (exact roundtrip)."""
    return EngineLoad(**d)


def _effective_service_steps(load: EngineLoad) -> float:
    """Sanitized mean service window for the routing estimators.

    A cold engine's record (or one assembled elsewhere) may carry a zero,
    negative or non-finite ``mean_service_steps``; any value that cannot
    be a measured window falls back to one step, the smallest window a
    request can consume, so a cold engine's outstanding work still counts.
    Every measured mean passes through untouched.
    """
    mean = float(load.mean_service_steps)
    if not (0.0 < mean < float("inf")):   # ≤0, NaN and ±inf all fail this
        return 1.0
    return mean


def load_score(load: EngineLoad) -> float:
    """Expected outstanding work per lane slot, in window steps.

    Busy lanes owe on average half a service window, queued requests a
    full one, scaled by the measured mean service steps and normalized by
    the slot count.  Each rung down the degradation ladder counts like
    half the tile being busy and each consecutive unresolved fault like a
    quarter, so a degraded engine keeps serving but stops being anyone's
    first choice; a dead engine scores infinite.
    """
    if not load.alive:
        return float("inf")
    owed = 0.5 * load.lanes_busy + load.queue_depth
    degraded = (0.5 * load.demotion_level
                + 0.25 * load.consecutive_faults) * load.lanes_total
    return ((owed + degraded) * _effective_service_steps(load)
            / max(1, load.lanes_total))


def estimate_eta_steps(load: EngineLoad) -> float:
    """Expected window steps until a NEW admission would complete.

    Queue-wave model: zero waves if a lane slot is free, else one wave per
    ``lanes_total`` requests already ahead, each wave lasting the measured
    mean service window; its own service appends one more.  Always finite
    and ≥ 1 (see :func:`_effective_service_steps`).
    """
    free = load.lanes_total - load.lanes_busy
    if load.queue_depth < free:
        waves = 0
    else:
        waves = 1 + (load.queue_depth - free) // max(1, load.lanes_total)
    return (waves + 1) * _effective_service_steps(load)


class MatmulTelemetry(NamedTuple):
    """Side channel of one ``spike_matmul_op`` call (0-dim tensors on the
    operands' device)."""

    density: torch.Tensor      # float32: observed batch spike density
    used_masked: torch.Tensor  # bool: the masked realisation ran


def _pad128(n: int) -> int:
    from ..kernels.fused_snn import LANE
    return n + (-n) % LANE


def tiles_total(layer_sizes) -> tuple[int, ...]:
    """Total 128×128 tile pairs per layer, per batch block, per step."""
    from ..kernels.fused_snn import LANE
    sizes = [_pad128(int(n)) for n in layer_sizes]
    return tuple((k // LANE) * (n // LANE)
                 for k, n in zip(sizes[:-1], sizes[1:]))


def tile_any(a: torch.Tensor, block_b: int) -> torch.Tensor:
    """(..., B, n) → (..., ceil(B / block_b), ceil(n / 128)) bool: whether
    each tile of ``block_b`` lanes by 128 columns holds a non-zero (lanes
    and columns padded with zeros)."""
    from ..kernels.fused_snn import LANE
    B, n = a.shape[-2:]
    Bp, n_pad = B + (-B) % block_b, _pad128(n)
    a = torch.nn.functional.pad((a != 0).to(torch.uint8),
                                (0, n_pad - n, 0, Bp - B))
    a = a.reshape(tuple(a.shape[:-2])
                  + (Bp // block_b, block_b, n_pad // LANE, LANE))
    return a.amax(dim=(-3, -1)) != 0


def layer_tile_skips(x: torch.Tensor, en: torch.Tensor, *,
                     sparse_skip: bool) -> torch.Tensor:
    """Skipped tile pairs per batch block, for one layer.

    ``x``: (..., B, n_in) bool input spikes; ``en``: (..., B, n_out) bool
    enables.  Returns (..., n_blocks) int32 with the launch geometry the
    stack op pads to: neuron axes to 128 (padded pixels never spike, padded
    neurons are disabled), lanes to the ``block_b_for`` block.  A pair is
    skipped when its K-tile carries no spike in any lane of the block OR its
    output tile has no enabled neuron in the block.
    """
    from ..kernels.fused_snn import block_b_for
    lead = tuple(x.shape[:-2])
    B = x.shape[-2]
    bB = block_b_for(B)
    nb = -(-B // bB)
    if not sparse_skip:
        return torch.zeros(lead + (nb,), dtype=torch.int32, device=x.device)
    any_x, any_e = tile_any(x, bB), tile_any(en, bB)
    live = any_x[..., :, None] & any_e[..., None, :]
    return (~live).sum(dim=(-2, -1), dtype=torch.int32)


def concat_telemetry(chunks) -> ChunkTelemetry:
    """Concatenate per-chunk records along the step axis."""
    chunks = list(chunks)
    return ChunkTelemetry(*[torch.cat([getattr(c, f) for c in chunks])
                            for f in ChunkTelemetry._fields])


def model_tile_skips(per_peer, model_shards: int) -> torch.Tensor:
    """One layer's tile row on a ``model_shards``-way model axis.

    ``per_peer`` holds each model peer's skipped-tile counts per batch
    block, (n_blocks,) each, in peer order; concatenated model-inner.  A
    replicated layer gives one count, which every peer would have counted
    alike, so it is listed ``model_shards`` times.
    """
    if len(per_peer) == 1:
        return per_peer[0].repeat(model_shards)
    return torch.cat(list(per_peer))


def concat_shard_telemetry(parts) -> ChunkTelemetry:
    """The mesh's record from its data shards' records, in data order:
    lanes and batch blocks concatenate data-outer."""
    parts = list(parts)
    return ChunkTelemetry(*[torch.cat([getattr(p, f) for p in parts], dim=-1)
                            for f in ChunkTelemetry._fields])
