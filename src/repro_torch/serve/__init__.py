"""Serving layer of the port: the streaming engines, their fault harness,
the serving tier above them, and the tier's wire codec and ledger."""

from .early_exit import StabilityGateState, stability_init, stability_step
from .faults import (DeviceLostFault, DispatchFault, EngineFailure,
                     EngineHealthState, FaultEvent, FaultInjector, FaultPlan,
                     FaultPlanSpecError, FaultRecord, FaultToleranceConfig,
                     PoisonDispatchError)
from .ledger import Ledger, LedgerCorruptError, read_ledger, recover_accounting
from .rollout import RolloutEvent, RolloutInProgressError, WeightBank, \
    merge_version_chunks
from .router import ShedRecord, SNNServingTier
from .snn_engine import LaneState, RequestResult, ShardedSNNStreamEngine, \
    SNNStreamEngine, shard_weights, sharded_stream_chunk, split_lanes, \
    stream_chunk
from .telemetry import AdaptiveDispatchConfig, ChunkSummary, \
    TelemetryController, make_controller, summarize_chunk
from .wire import WIRE_CODEC_VERSION, WireError, lane_from_wire, lane_to_wire

__all__ = ["SNNStreamEngine", "ShardedSNNStreamEngine", "LaneState",
           "RequestResult", "stream_chunk", "split_lanes", "shard_weights",
           "sharded_stream_chunk", "StabilityGateState", "stability_init",
           "stability_step", "WeightBank", "RolloutEvent",
           "RolloutInProgressError", "merge_version_chunks",
           "AdaptiveDispatchConfig", "ChunkSummary",
           "TelemetryController", "make_controller", "summarize_chunk",
           "SNNServingTier", "ShedRecord",
           "FaultPlan", "FaultEvent", "FaultInjector", "FaultRecord",
           "FaultToleranceConfig", "EngineHealthState", "EngineFailure",
           "DispatchFault", "DeviceLostFault", "PoisonDispatchError",
           "FaultPlanSpecError", "Ledger", "LedgerCorruptError",
           "read_ledger", "recover_accounting", "WIRE_CODEC_VERSION",
           "WireError", "lane_to_wire", "lane_from_wire"]
