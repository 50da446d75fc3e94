"""snn-mnist — the paper's model and its stack variants, as data.

784→10 fully connected LIF layer, 20-timestep window, signed 9-bit weight
codes, shift-4 decay (β = 1/16), threshold 128.  ``backend="auto"``
resolves on a card through the CUDA kernels (resident stack kernel →
weight-streaming stack kernel → staged kernels) and to the reference path
on the CPU.  Field for field the same configurations as
``repro.configs.snn_mnist``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.lif import LIFConfig
from ..core.snn import SNNConfig
from ..serve.telemetry import AdaptiveDispatchConfig
from .base import ArchConfig
from .registry import register

__all__ = ["CONFIG", "SNN_CONFIG", "SNN_CONFIG_PRUNED", "SNN_CONFIG_DEEP",
           "SNN_CONFIG_WIDE", "SNNStreamMeshConfig", "SNN_STREAM_MESH",
           "make_stream_mesh", "make_stream_engine", "TIER_PRIORITY_CLASSES",
           "SNNServingTierConfig", "SNN_SERVING_TIER", "make_serving_tier",
           "SNNClusterConfig", "SNN_CLUSTER", "make_cluster"]

# LM-shaped registry entry (family "snn") so arch listings include it.
CONFIG = register(ArchConfig(
    name="snn-mnist", family="snn",
    num_layers=1, d_model=784, num_heads=1, num_kv_heads=1,
    head_dim=1, d_ff=0, vocab_size=10,
    optimizer="adamw", remat=False, scan_layers=False,
))

_LIF = LIFConfig(decay_shift=4, v_threshold=128, v_rest=0)

SNN_CONFIG = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                       qat=True, readout="count", active_pruning=False,
                       backend="auto")

# Active pruning with the first-spike readout (paper §III-D).
SNN_CONFIG_PRUNED = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                              qat=True, readout="first_spike",
                              active_pruning=True, backend="auto")

# Hidden-layer stack: inter-layer spikes stay on chip in the stack kernel.
SNN_CONFIG_DEEP = SNNConfig(layer_sizes=(784, 128, 64, 10), num_steps=20,
                            lif=_LIF, qat=True, readout="count",
                            active_pruning=False, backend="auto")

# Widened stack whose per-lane state exceeds the resident stack kernel's
# shared memory: on a card ``auto`` runs it on the weight-streaming kernel.
SNN_CONFIG_WIDE = SNNConfig(layer_sizes=(784, 2048, 2048, 10), num_steps=20,
                            lif=_LIF, qat=True, readout="count",
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
    # None defers to the engine: a dispatch-cache hit supplies the tuned
    # value, otherwise 8 lanes and 4-step chunks
    lanes_per_device: int | None = None  # slots per data shard
    chunk_steps: int | None = None     # window steps per chunk
    overlap: bool = True               # speculative chunk k+1 dispatch
    # telemetry controller (serve.telemetry): None reads the
    # REPRO_ADAPTIVE_DISPATCH env default, frozen unless it is set
    adaptive: AdaptiveDispatchConfig | None = None
    # tuned shapes (repro_torch.tune): a DispatchCache, a path to its JSON
    # file, None for the REPRO_DISPATCH_CACHE env, or False for none; they
    # fill the None knobs above, explicit values win
    dispatch_cache: "object | None" = None


SNN_STREAM_MESH = SNNStreamMeshConfig()


def make_stream_mesh(knobs: SNNStreamMeshConfig = SNN_STREAM_MESH, *,
                     devices=None):
    """The serving lane mesh the knobs describe: a validated (data × model)
    mesh over ``devices`` (None = every visible card; an explicit list may
    name one card more than once, e.g. ``["cuda:0"] * 4`` for a 1×4 mesh
    on one card).

    Under a ``torch.distributed`` group whose world size is ``num_devices
    × model_devices`` (under ``torchrun`` the group is started as
    ``launch.mesh.start_rank_group`` starts it) the mesh is a process
    mesh: one rank per cell, data-outer and model-inner, the engine one
    rank of an SPMD program.  A rank's device is card ``LOCAL_RANK``
    with ``devices=None``, else ``devices[rank]``: ``["cpu"] * 4`` runs
    four ``gloo`` ranks on the CPU, ``["cuda:0"] * 4`` four ``gloo``
    ranks on one card.  ``nccl`` needs a card of its own for every rank
    and raises, before any collective, where two would share one."""
    from ..distributed.sharding import make_2d_device_mesh
    from ..launch.mesh import start_rank_group
    rank = int(os.environ.get("RANK", -1))
    start_rank_group(list(devices)[rank] if devices is not None
                     and 0 <= rank < len(devices) else None)
    if dist.is_available() and dist.is_initialized():
        world, md = dist.get_world_size(), knobs.model_devices
        nd = knobs.num_devices or world // md
        if nd * md == world:
            devices = _rank_devices(devices, world)
    return make_2d_device_mesh(
        data_devices=knobs.num_devices, model_devices=knobs.model_devices,
        axis_names=(knobs.axis_name, knobs.model_axis_name), devices=devices)


def _rank_devices(devices, world: int) -> list:
    """The device list of a process mesh, as this rank sees it: its own
    device at its cell (every cell with ``devices=None``, as
    ``launch.mesh.make_local_mesh`` lists it), checked against the
    group's backend, and made the current card."""
    rank = dist.get_rank()
    nccl = dist.get_backend() == "nccl"
    if devices is None:
        card = int(os.environ.get("LOCAL_RANK", rank))
        n = torch.cuda.device_count()
        if card >= n:
            raise RuntimeError(
                f"rank {rank} wants card {card} of {n}: nccl needs a card "
                f"per rank; to run several ranks on one card, start a "
                f"gloo group and pass devices=['cuda:0'] * {world}")
        devices = [torch.device("cuda", card)] * world
    else:
        devices = [torch.device(d) for d in devices][:world]
        if len(devices) < world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        if nccl and len(set(devices)) < world:
            raise ValueError(
                f"nccl refuses two ranks on one card, and {devices} names "
                f"one more than once: start a gloo group for that (the "
                f"exchange then stages through host memory)")
    own = devices[rank]
    if nccl and own.type != "cuda":
        raise ValueError(f"an nccl rank needs a card, not {own}")
    if own.type == "cuda":
        torch.cuda.set_device(own)
    return devices


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
        adaptive=knobs.adaptive, dispatch_cache=knobs.dispatch_cache,
        **engine_kw)


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
    # None defers to each engine's dispatch-cache decision (tuned shapes
    # on a hit, else 8 lanes and 4-step chunks)
    lanes_per_engine: int | None = None
    chunk_steps: int | None = None
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
    # Tuned shapes (repro_torch.tune) for every engine of the tier, as
    # SNNStreamMeshConfig.dispatch_cache; each engine's hit or miss is on
    # SNNServingTier.cache_decisions.
    dispatch_cache: "object | None" = None
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
        fault_cfg=knobs.resolve_fault_cfg(),
        dispatch_cache=knobs.dispatch_cache, **tier_kw)


# Process-level cluster knobs (serve.ClusterCoordinator): ``num_workers``
# engine processes supervised over heartbeat RPC, lane checkpoints shipped
# every round, accounting written ahead to ``ledger_dir``.  The recovery
# policy (heartbeat interval and deadline, respawn budget) comes from the
# tier knobs' resolve_fault_cfg() through make_cluster.
@dataclass(frozen=True)
class SNNClusterConfig:
    num_workers: int = 2
    lanes_per_worker: int = 4
    chunk_steps: int = 4
    backend: str | None = None
    fault_plan: "FaultPlan | str | None" = None
    ledger_dir: str | None = None      # required at build time

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {self.num_workers}")
        if self.lanes_per_worker < 1:
            raise ValueError(
                f"lanes_per_worker must be >= 1, got "
                f"{self.lanes_per_worker}")


SNN_CLUSTER = SNNClusterConfig()


def make_cluster(params_q: dict, snn_cfg: SNNConfig = SNN_CONFIG,
                 knobs: SNNClusterConfig = SNN_CLUSTER,
                 tier_knobs: SNNServingTierConfig = SNN_SERVING_TIER,
                 **cluster_kw):
    """A ``serve.ClusterCoordinator`` built from the knobs
    (``cluster_kw`` adds the rest: ``device``, ``patience``, ``seed``,
    ``ledger_dir``).  The recovery policy is
    ``tier_knobs.resolve_fault_cfg()``, the source the in-process tier
    uses, so heartbeat, respawn and watchdog settings are set once for
    both."""
    from ..serve import ClusterCoordinator
    cluster_kw.setdefault("ledger_dir", knobs.ledger_dir)
    return ClusterCoordinator(
        params_q, snn_cfg, num_workers=knobs.num_workers,
        lanes_per_worker=knobs.lanes_per_worker,
        chunk_steps=knobs.chunk_steps, backend=knobs.backend,
        fault_plan=knobs.fault_plan,
        fault_cfg=tier_knobs.resolve_fault_cfg(),
        **cluster_kw)
