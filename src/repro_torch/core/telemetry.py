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
           "DEFAULT_SPIKE_DENSITY_THRESHOLD",
           "resolve_density_threshold", "resolve_sparse_skip", "tiles_total",
           "layer_tile_skips", "concat_telemetry", "model_tile_skips",
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
    """Host-side load summary of one serving engine (router currency)."""

    lanes_total: int
    lanes_busy: int
    queue_depth: int
    mean_service_steps: float
    retired_total: int
    density_ewma: float | None
    consecutive_faults: int = 0
    demotion_level: int = 0
    watchdog_margin: int | None = None
    alive: bool = True

    @property
    def occupancy(self) -> float:
        return self.lanes_busy / max(1, self.lanes_total)


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
    from ..kernels.fused_snn import LANE, block_b_for
    lead = tuple(x.shape[:-2])
    B = x.shape[-2]
    bB = block_b_for(B)
    Bp = B + (-B) % bB
    nb = Bp // bB
    if not sparse_skip:
        return torch.zeros(lead + (nb,), dtype=torch.int32, device=x.device)

    def tile_any(a: torch.Tensor) -> torch.Tensor:
        n = a.shape[-1]
        n_pad = _pad128(n)
        a = torch.nn.functional.pad(a.to(torch.uint8),
                                    (0, n_pad - n, 0, Bp - B))
        a = a.reshape(lead + (nb, bB, n_pad // LANE, LANE))
        return a.amax(dim=(-3, -1)) != 0             # (..., nb, n_tiles)

    any_x, any_e = tile_any(x), tile_any(en)
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
