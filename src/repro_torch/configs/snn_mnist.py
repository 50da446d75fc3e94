"""snn-mnist — the paper's model and its stack variants, as data.

784→10 fully connected LIF layer, 20-timestep window, signed 9-bit weight
codes, shift-4 decay (β = 1/16), threshold 128.  ``backend="auto"``
resolves on a card through the CUDA kernels (resident stack kernel →
weight-streaming stack kernel → staged kernels) and to the reference path
on the CPU.  Field for field the same configurations as
``repro.configs.snn_mnist``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.lif import LIFConfig
from ..core.snn import SNNConfig
from ..serve.telemetry import AdaptiveDispatchConfig

__all__ = ["SNN_CONFIG", "SNN_CONFIG_PRUNED", "SNN_CONFIG_DEEP",
           "SNN_CONFIG_WIDE", "SNNStreamMeshConfig", "SNN_STREAM_MESH",
           "make_stream_mesh", "make_stream_engine"]

_LIF = LIFConfig(decay_shift=4, v_threshold=128, v_rest=0)

SNN_CONFIG = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                       readout="count", active_pruning=False, backend="auto")

# Active pruning with the first-spike readout (paper §III-D).
SNN_CONFIG_PRUNED = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                              readout="first_spike", active_pruning=True,
                              backend="auto")

# Hidden-layer stack: inter-layer spikes stay on chip in the stack kernel.
SNN_CONFIG_DEEP = SNNConfig(layer_sizes=(784, 128, 64, 10), num_steps=20,
                            lif=_LIF, readout="count",
                            active_pruning=False, backend="auto")

# Widened stack whose per-lane state exceeds the resident stack kernel's
# shared memory: on a card ``auto`` runs it on the weight-streaming kernel.
SNN_CONFIG_WIDE = SNNConfig(layer_sizes=(784, 2048, 2048, 10), num_steps=20,
                            lif=_LIF, readout="count",
                            active_pruning=False, backend="auto")


# Streaming-serving mesh knobs (serve.ShardedSNNStreamEngine).  The lane
# tile is data-parallel over ``axis_name``; ``model_devices > 1`` adds a
# ``model_axis_name`` axis that shards each layer's output-neuron weight
# columns over the model peers, with a spike exchange at layer boundaries.
# ``num_devices=None`` lets the data axis absorb every device the model
# axis leaves over.
@dataclass(frozen=True)
class SNNStreamMeshConfig:
    axis_name: str = "data"
    num_devices: int | None = None     # data-axis width (None = the rest)
    model_axis_name: str = "model"
    model_devices: int = 1             # model-axis width (1 = pure data)
    lanes_per_device: int | None = None  # slots per data shard (None = 8)
    chunk_steps: int = 4               # window steps per chunk
    overlap: bool = False              # speculative chunk k+1 dispatch
    # telemetry controller (serve.telemetry): None reads the
    # REPRO_ADAPTIVE_DISPATCH env default, frozen unless it is set
    adaptive: AdaptiveDispatchConfig | None = None


SNN_STREAM_MESH = SNNStreamMeshConfig()


def make_stream_mesh(knobs: SNNStreamMeshConfig = SNN_STREAM_MESH, *,
                     devices=None):
    """The serving lane mesh the knobs describe: a validated (data × model)
    mesh over ``devices`` (None = every visible card; an explicit list may
    name one card more than once, e.g. ``["cuda:0"] * 4`` for a 1×4 mesh
    on one card)."""
    from ..distributed.sharding import make_2d_device_mesh
    return make_2d_device_mesh(
        data_devices=knobs.num_devices, model_devices=knobs.model_devices,
        axis_names=(knobs.axis_name, knobs.model_axis_name), devices=devices)


def make_stream_engine(params_q: dict, snn_cfg: SNNConfig = SNN_CONFIG,
                       knobs: SNNStreamMeshConfig = SNN_STREAM_MESH, *,
                       devices=None, **engine_kw):
    """A ``serve.ShardedSNNStreamEngine`` built from the mesh knobs on
    ``devices`` (as :func:`make_stream_mesh`)."""
    from ..serve import ShardedSNNStreamEngine
    return ShardedSNNStreamEngine(
        params_q, snn_cfg, mesh=make_stream_mesh(knobs, devices=devices),
        axis_name=knobs.axis_name, model_axis_name=knobs.model_axis_name,
        lanes_per_device=knobs.lanes_per_device,
        chunk_steps=knobs.chunk_steps, overlap=knobs.overlap,
        adaptive=knobs.adaptive, **engine_kw)
