"""Telemetry-seeded wall-clock search over the dispatch space.

The engine exposes every knob this module tunes — ``chunk_steps`` (the
host-sync granularity of the streaming window), the batch block
``block_b`` (fixed at ``kernels.fused_snn.BLOCK_B`` in the port, so its
grid is that one value), ``lanes_per_device`` (the continuous-batching
tile width) and ``spike_density_threshold`` (the controller's dispatch
boundary) — and every one is value-neutral.  The search times **real
engine runs** against a deterministic open-loop arrival schedule and
picks the shapes that minimise **seconds per retired request**.

A short probe run with the adaptive
:class:`~repro_torch.serve.telemetry.TelemetryController` seeds the
search: its density EWMA prunes the threshold grid to the two values
bracketing the observed density, and its mean retirement steps drop
chunk lengths far past the retirement horizon.  The **default shapes are
always a candidate** and measured first: they are the bit-identity
baseline every candidate must reproduce exactly and the floor the winner
is compared against.

Determinism: the schedule's pixels come from a seeded generator, engines
are seeded, and the candidate order is sorted, so a rerun walks the same
candidates in the same order (only the clock samples differ).

The serving stack is imported lazily: ``tune.cache`` stays importable
from ``core.snn`` without pulling ``serve`` in at module scope.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np

from .cache import DispatchCache, DispatchCacheError, TunedShapes, \
    cache_key
from .fingerprint import config_fingerprint
from .timing import device_kind_now, measure

__all__ = [
    "ArrivalSchedule", "AutotuneConfig", "AutotuneResult", "Candidate",
    "autotune_engine", "prune_grids", "serve_schedule", "write_cache",
]


@dataclass(frozen=True)
class ArrivalSchedule:
    """Deterministic open-loop arrival process for candidate timing.

    ``per_round`` requests are submitted at every scheduling round
    whatever completes (open loop: faster shapes retire the backlog
    sooner instead of being handed less work).  Pixels are drawn once
    from ``numpy.random.default_rng(seed)``, so every candidate and every
    repeat serves byte-identical traffic.
    """

    n_requests: int = 32
    per_round: int = 2
    seed: int = 1234

    def pixels(self, n_in: int) -> list:
        rng = np.random.default_rng(self.seed)
        return [rng.integers(0, 256, size=n_in, dtype=np.uint8)
                for _ in range(self.n_requests)]


def serve_schedule(engine, schedule: ArrivalSchedule, pixels: list) -> dict:
    """Drive one engine through the schedule; returns its results dict."""
    i = 0
    while i < schedule.n_requests:
        for _ in range(schedule.per_round):
            if i < schedule.n_requests:
                engine.submit(pixels[i], request_id=i)
                i += 1
        engine.step()
    return engine.run()


@dataclass(frozen=True)
class Candidate:
    """One point of the dispatch space under test."""

    chunk_steps: int
    block_b: int
    lanes_per_device: int
    threshold: float

    def to_json(self) -> dict:
        return {"chunk_steps": self.chunk_steps, "block_b": self.block_b,
                "lanes_per_device": self.lanes_per_device,
                "threshold": self.threshold}


@dataclass(frozen=True)
class AutotuneConfig:
    """Search-space grids + measurement knobs.  ``block_b_grid`` holds
    the one block the port's kernels run."""

    chunk_steps_grid: tuple = (2, 3, 4, 6, 8)
    block_b_grid: tuple = (8,)
    lanes_grid: tuple = (4, 8, 16)
    threshold_grid: tuple = (0.1, 0.25, 0.4)
    schedule: ArrivalSchedule = field(default_factory=ArrivalSchedule)
    repeats: int = 3
    warmup: int = 1
    # telemetry seeding: prune the grids from a probe run's observed
    # density / retirement EWMAs before measuring anything
    telemetry_prune: bool = True
    # hard cap on measured candidates (default shapes always included)
    max_candidates: int = 12


@dataclass(frozen=True)
class AutotuneResult:
    """Everything one tuning run learned (records are provenance)."""

    tuned: TunedShapes
    default: Candidate
    baseline_spr: float              # default shapes, s/retired-request
    records: list                    # per-candidate measurement dicts
    probe: dict                      # telemetry-seeding observations
    pruned: dict                     # per-axis grid sizes before/after
    bit_identical: bool              # every candidate == default bits
    fingerprint: str
    device_kind: str


def _default_candidate(cfg) -> Candidate:
    """Today's static shapes: what an engine runs with no cache."""
    from ..core.telemetry import resolve_density_threshold
    from ..kernels.fused_snn import block_b_for
    lanes = 8                            # SNNStreamEngine's default tile
    return Candidate(
        chunk_steps=min(4, cfg.num_steps),
        block_b=block_b_for(lanes),
        lanes_per_device=lanes,
        threshold=float(resolve_density_threshold(
            cfg.spike_density_threshold)))


def prune_grids(tune_cfg: AutotuneConfig, cfg, *,
                density_ewma: float | None,
                service_steps: float | None) -> tuple[dict, dict]:
    """Telemetry-seeded grid pruning.  Returns (grids, prune_report).

    * thresholds: every value on the same side of the observed density
      EWMA dispatches every chunk alike, so only the two values
      bracketing the EWMA survive;
    * chunk lengths: lanes retire after ~``service_steps`` on average,
      so lengths past ``2 × service_steps`` are dropped (never below the
      shortest grid entry, never above the window);
    * lanes: a tile wider than the whole offered schedule can never
      fill; such widths are dropped.
    """
    sched = tune_cfg.schedule
    thr = sorted(set(float(t) for t in tune_cfg.threshold_grid))
    chunks = sorted(set(int(c) for c in tune_cfg.chunk_steps_grid
                        if 1 <= c <= cfg.num_steps))
    lanes = sorted(set(int(b) for b in tune_cfg.lanes_grid))
    blocks = sorted(set(int(b) for b in tune_cfg.block_b_grid))
    report = {"threshold": [len(thr)], "chunk_steps": [len(chunks)],
              "lanes_per_device": [len(lanes)], "block_b": [len(blocks)]}
    if tune_cfg.telemetry_prune and density_ewma is not None:
        below = [t for t in thr if t <= density_ewma]
        above = [t for t in thr if t > density_ewma]
        thr = ([max(below)] if below else []) + \
              ([min(above)] if above else [])
    if tune_cfg.telemetry_prune and service_steps is not None and chunks:
        horizon = max(min(chunks), int(math.ceil(2.0 * service_steps)))
        chunks = [c for c in chunks if c <= horizon] or [min(chunks)]
    lanes = [b for b in lanes if b <= sched.n_requests] or \
        ([min(lanes)] if lanes else [])
    report["threshold"].append(len(thr))
    report["chunk_steps"].append(len(chunks))
    report["lanes_per_device"].append(len(lanes))
    report["block_b"].append(len(blocks))
    return ({"threshold": thr, "chunk_steps": chunks, "lanes": lanes,
             "blocks": blocks}, report)


def _result_bits(results: dict) -> dict:
    """The bit-identity projection of an engine's results dict."""
    return {int(rid): (int(r.pred), int(r.steps))
            for rid, r in results.items()}


def autotune_engine(params_q: dict, cfg, *,
                    tune_cfg: AutotuneConfig | None = None,
                    backend: str | None = None,
                    patience: int = 2, seed: int = 0,
                    make_engine=None, device=None) -> AutotuneResult:
    """Measure the dispatch space on real engine runs; return the winner.

    Engines run on ``device`` (None = the CUDA card; raises without one).
    ``make_engine(candidate, adaptive_cfg)`` may be supplied to tune a
    different engine construction; the default builds a single-device
    :class:`~repro_torch.serve.SNNStreamEngine` with the candidate's
    shapes.  The returned :class:`~repro_torch.tune.cache.TunedShapes`
    carries the backend the winning engine resolved.
    """
    from ..device import resolve_device
    from ..distributed.sharding import refuse_process_mesh
    from ..serve.snn_engine import SNNStreamEngine
    from ..serve.telemetry import AdaptiveDispatchConfig
    tc = tune_cfg or AutotuneConfig()
    sched = tc.schedule
    pixels = sched.pixels(cfg.layer_sizes[0])
    frozen = AdaptiveDispatchConfig(adaptive=False)
    dev = resolve_device(device)

    if make_engine is None:
        def make_engine(cand: Candidate, adaptive):
            c = (cfg if cand.threshold is None else
                 dc_replace(cfg, spike_density_threshold=cand.threshold))
            return SNNStreamEngine(
                params_q, c, batch_size=cand.lanes_per_device,
                chunk_steps=cand.chunk_steps, block_b=cand.block_b,
                patience=patience, seed=seed, backend=backend,
                adaptive=adaptive, dispatch_cache=False, device=dev)

    default = _default_candidate(cfg)

    # ---- probe: one adaptive run seeds the grid pruning -------------------
    probe_eng = make_engine(default, AdaptiveDispatchConfig(adaptive=True))
    refuse_process_mesh(getattr(probe_eng, "mesh", None), "the tuner")
    serve_schedule(probe_eng, sched, pixels)
    probe = {
        "density_ewma": probe_eng.controller.density_ewma,
        "service_steps_ewma": probe_eng._service_ewma,
        "chunk_steps_final": probe_eng.controller.chunk_steps,
        "backend": probe_eng.backend,
    }

    grids, prune_report = prune_grids(
        tc, cfg, density_ewma=probe["density_ewma"],
        service_steps=probe["service_steps_ewma"])

    cands = [Candidate(chunk_steps=c, block_b=b, lanes_per_device=l,
                       threshold=t)
             for c, b, l, t in itertools.product(
                 grids["chunk_steps"], grids["blocks"], grids["lanes"],
                 grids["threshold"])]
    cands = [c for c in cands if c != default]
    cands.sort(key=lambda c: (c.chunk_steps, c.block_b,
                              c.lanes_per_device, c.threshold))
    cands = [default] + cands[:max(0, tc.max_candidates - 1)]

    # ---- measure: default first (it is the bit-identity baseline) ---------
    device_kind = device_kind_now(dev)
    records: list[dict] = []
    baseline_bits: dict | None = None
    baseline_spr: float | None = None
    all_identical = True
    for cand in cands:
        holder: dict = {}

        def run_once(cand=cand, holder=holder):
            eng = make_engine(cand, frozen)
            holder["results"] = serve_schedule(eng, sched, pixels)
            holder["backend"] = eng.backend

        run_once()                       # resolve backend, load kernels
        resolved = holder["backend"]
        interpret = (resolved in ("fused", "fused_streamed")
                     and dev.type != "cuda")
        rec = measure(run_once, repeats=tc.repeats, warmup=tc.warmup,
                      interpret=interpret, device_kind=device_kind)
        bits = _result_bits(holder["results"])
        if baseline_bits is None:
            baseline_bits = bits
        identical = bits == baseline_bits
        all_identical = all_identical and identical
        spr = rec.median_s / max(1, sched.n_requests)
        if cand == default:
            baseline_spr = spr
        records.append({"candidate": cand.to_json(), "backend": resolved,
                        "seconds_per_retired_request": spr,
                        "matches_baseline": identical,
                        "timing": rec.to_json()})

    # ---- pick: fastest candidate that reproduced the baseline bits --------
    # (ties prefer the default — no churn for noise)
    eligible = [(r, c) for r, c in zip(records, cands)
                if r["matches_baseline"]]
    winner_rec, winner = min(
        eligible, key=lambda rc: (rc[0]["seconds_per_retired_request"],
                                  rc[1] != default, repr(rc[1])))
    tuned = TunedShapes(
        chunk_steps=winner.chunk_steps, block_b=winner.block_b,
        lanes_per_device=winner.lanes_per_device,
        spike_density_threshold=float(winner.threshold),
        backend=winner_rec["backend"],
        seconds_per_retired_request=winner_rec[
            "seconds_per_retired_request"],
        baseline_seconds_per_retired_request=baseline_spr,
        timing=winner_rec["timing"])
    return AutotuneResult(
        tuned=tuned, default=default, baseline_spr=baseline_spr,
        records=records, probe=probe, pruned=prune_report,
        bit_identical=all_identical,
        fingerprint=config_fingerprint(cfg), device_kind=device_kind)


def write_cache(result: AutotuneResult, path: str, *,
                backend_request: str | None = "auto",
                mesh_shapes=((1,),)) -> DispatchCache:
    """Persist a tuning run's winner under every requested mesh key.

    The tuner measures on a single-device engine; callers that verified
    the shapes on a sharded topology pass its mesh shape too, so fleet
    engines hit the same entry (lane counts are per device).  Merges into
    an existing cache file when one is present and valid.
    """
    try:
        cache = DispatchCache.load(path)
    except DispatchCacheError:
        cache = DispatchCache()
    for mesh_shape in mesh_shapes:
        cache.put(cache_key(result.fingerprint, result.device_kind,
                            mesh_shape, backend_request), result.tuned)
    cache.save(path)
    return cache
