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
           "make_stream_mesh", "make_stream_engine", "TIER_PRIORITY_CLASSES",
           "SNNServingTierConfig", "SNN_SERVING_TIER", "make_serving_tier"]

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


# Priority classes of the serving tier, ordered lowest → highest: under
# overload the router sheds from the left; deadline admission applies to
# every class alike.  Deployments replace the tuple wholesale.
TIER_PRIORITY_CLASSES = ("batch", "standard", "interactive")


# Serving-tier knobs (serve.SNNServingTier): ``num_engines`` engines behind
# least-loaded routing, SLO admission and zero-drain rollout.  Deadlines
# are in window steps; ``queue_limit`` caps each engine's host queue (the
# overload boundary), ``None`` queues without bound.
@dataclass(frozen=True)
class SNNServingTierConfig:
    num_engines: int = 2
    lanes_per_engine: int | None = None  # None: the engine's 8 lanes
    chunk_steps: int | None = None       # None: the engine's 4 steps
    priority_classes: tuple = TIER_PRIORITY_CLASSES
    default_priority: str = "standard"
    default_deadline_steps: int | None = None
    queue_limit: int | None = 64
    shedding: bool = True
    # sharded=True carves the devices into num_engines contiguous slices,
    # each engine a ShardedSNNStreamEngine over its own data mesh
    sharded: bool = False
    devices_per_engine: int | None = None
    adaptive: AdaptiveDispatchConfig | None = None
    # Fault tolerance (serve.faults): ``fault_plan`` arms a deterministic
    # injection schedule (a FaultPlan or its spec string, e.g.
    # "seed=11,dispatch=0.03"); None leaves the engines to arm from the
    # REPRO_FAULT_PLAN env.  ``fault_cfg`` is the recovery policy (None:
    # the FaultToleranceConfig defaults).
    fault_plan: "FaultPlan | str | None" = None
    fault_cfg: "FaultToleranceConfig | None" = None
    # The recovery knobs one by one: a non-None value is folded into the
    # config :meth:`resolve_fault_cfg` builds (and validates); setting
    # any of them beside an explicit ``fault_cfg`` raises.
    watchdog_chunks: int | None = None
    max_retries: int | None = None
    backoff_base: int | None = None
    backoff_max: int | None = None
    demote_after: int | None = None
    promote_after: int | None = None
    fail_after: int | None = None
    quarantine_after: int | None = None
    heartbeat_interval_s: float | None = None
    heartbeat_deadline_s: float | None = None
    max_respawns: int | None = None

    _KNOB_FIELDS = ("watchdog_chunks", "max_retries", "backoff_base",
                    "backoff_max", "demote_after", "promote_after",
                    "fail_after", "quarantine_after",
                    "heartbeat_interval_s", "heartbeat_deadline_s",
                    "max_respawns")

    def resolve_fault_cfg(self):
        """The effective FaultToleranceConfig: ``fault_cfg`` verbatim, or
        one built from the individual knob overrides (validated by the
        FaultToleranceConfig constructor)."""
        overrides = {k: getattr(self, k) for k in self._KNOB_FIELDS
                     if getattr(self, k) is not None}
        if self.fault_cfg is not None:
            if overrides:
                raise ValueError(
                    f"SNNServingTierConfig sets both fault_cfg and the "
                    f"individual recovery knobs {sorted(overrides)} — "
                    f"pick one source of truth (put the values in the "
                    f"fault_cfg, or drop it and use the knobs)")
            return self.fault_cfg
        if not overrides:
            return None
        from ..serve.faults import FaultToleranceConfig
        return FaultToleranceConfig(**overrides)

    def __post_init__(self):
        # a bad knob combination fails here, not at the first tier build
        self.resolve_fault_cfg()


SNN_SERVING_TIER = SNNServingTierConfig()


def make_serving_tier(params_q: dict, snn_cfg: SNNConfig = SNN_CONFIG,
                      knobs: SNNServingTierConfig = SNN_SERVING_TIER,
                      **tier_kw):
    """A ``serve.SNNServingTier`` built from the knobs (``tier_kw`` adds
    the rest: ``device``, ``devices``, ``patience``, ``seed``,
    ``backend``, ``ledger``)."""
    from ..serve import SNNServingTier
    return SNNServingTier(
        params_q, snn_cfg, num_engines=knobs.num_engines,
        lanes_per_engine=knobs.lanes_per_engine,
        chunk_steps=knobs.chunk_steps,
        priority_classes=knobs.priority_classes,
        default_priority=knobs.default_priority,
        default_deadline_steps=knobs.default_deadline_steps,
        queue_limit=knobs.queue_limit, shedding=knobs.shedding,
        sharded=knobs.sharded,
        devices_per_engine=knobs.devices_per_engine,
        adaptive=knobs.adaptive, fault_plan=knobs.fault_plan,
        fault_cfg=knobs.resolve_fault_cfg(), **tier_kw)
