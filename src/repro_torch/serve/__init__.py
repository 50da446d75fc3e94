"""Serving layer of the port: the streaming engine and its helpers."""

from .early_exit import StabilityGateState, stability_init, stability_step
from .rollout import WeightBank, merge_version_chunks
from .snn_engine import LaneState, RequestResult, ShardedSNNStreamEngine, \
    SNNStreamEngine, shard_weights, sharded_stream_chunk, split_lanes, \
    stream_chunk
from .telemetry import AdaptiveDispatchConfig, TelemetryController, \
    make_controller, summarize_chunk

__all__ = ["SNNStreamEngine", "ShardedSNNStreamEngine", "LaneState",
           "RequestResult", "stream_chunk", "split_lanes", "shard_weights",
           "sharded_stream_chunk", "StabilityGateState", "stability_init",
           "stability_step", "WeightBank", "merge_version_chunks",
           "AdaptiveDispatchConfig",
           "TelemetryController", "make_controller", "summarize_chunk"]
