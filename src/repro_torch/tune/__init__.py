"""Measured autotuning: wall-clock search over the dispatch space and the
persisted dispatch cache the engines load at startup (port of
``repro.tune``).

Three layers, importable independently:

* :mod:`repro_torch.tune.timing` — the timing harness (warmup +
  median-of-k on the host clock after a device synchronise,
  device-kind/interpret provenance tags);
* :mod:`repro_torch.tune.cache` / :mod:`repro_torch.tune.fingerprint` —
  the versioned dispatch-cache codec (the JAX package's, so one file
  reads in both) and the config fingerprint it is keyed by;
* :mod:`repro_torch.tune.search` — the telemetry-seeded
  seconds-per-retired-request search over
  ``(chunk_steps, block_b, lanes_per_device, spike_density_threshold)``
  (imports the serving stack lazily).
"""

from .cache import (CACHE_CODEC_VERSION, ENV_DISPATCH_CACHE, CacheDecision,
                    DispatchCache, DispatchCacheError, TunedShapes,
                    cache_key, decide_dispatch, resolve_dispatch_cache)
from .fingerprint import config_fingerprint, fingerprint_payload
from .search import (ArrivalSchedule, AutotuneConfig, AutotuneResult,
                     Candidate, autotune_engine, prune_grids,
                     serve_schedule, write_cache)
from .timing import TimingRecord, device_kind_now, measure

__all__ = [
    "CACHE_CODEC_VERSION", "ENV_DISPATCH_CACHE",
    "ArrivalSchedule", "AutotuneConfig", "AutotuneResult",
    "CacheDecision", "Candidate", "DispatchCache", "DispatchCacheError",
    "TimingRecord", "TunedShapes",
    "autotune_engine", "cache_key", "config_fingerprint",
    "decide_dispatch", "device_kind_now", "fingerprint_payload",
    "measure", "prune_grids", "resolve_dispatch_cache", "serve_schedule",
    "write_cache",
]
