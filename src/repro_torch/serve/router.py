"""Multi-host serving tier: telemetry-routed spraying + SLO admission
(port of ``repro.serve.router``).

The per-device datapath (stack kernels, lane mesh, adaptive telemetry)
serves one engine's worth of traffic; this module is the tier above it —
the front end a fleet deployment actually exposes.  An
:class:`SNNServingTier` owns N per-host engines (plain or sharded — in
one process here, but nothing below the ``submit``/``step`` surface knows
that) and makes the three decisions a fleet front end must make:

**Routing** — requests spray **least-loaded** across engines, scored by
the load signals the serving telemetry loop already maintains for free
(:meth:`SNNStreamEngine.load_summary` → ``core.telemetry.EngineLoad``):
lane occupancy, host-queue depth, the measured mean service window
(early-exit traffic drains faster — the retirement-rate signal), and the
controller's density EWMA when adaptive.  Scoring is a pure function
(``core.telemetry.load_score``) with a deterministic lowest-index
tie-break, so a replayed submission stream routes identically — CI
reproducibility is a feature of the router, not an accident.

**SLO-aware admission** — the paper's active-pruning/early-exit design
makes per-request latency *structurally* variable, which is exactly the
regime where deadline-aware shedding beats FIFO queueing.  Each request
carries a deadline in **window steps** (the currency of
``RequestResult.steps``) and a **priority class**; a request whose
completion estimate (``core.telemetry.estimate_eta_steps``, fed by the
measured retirement rate) exceeds its deadline is **shed at admission** —
recorded in :attr:`SNNServingTier.shed` with the estimate that rejected
it, never silently dropped.  Under overload (every engine's host queue at
``queue_limit``) the tier sheds **lowest-priority-first**: a higher-class
arrival displaces the newest lowest-class queued request instead of
queueing forever behind it.

**Zero-drain weight rollout** — :meth:`begin_rollout` broadcasts
version-tagged weights to every engine (``serve.rollout``):
in-flight windows finish on their admission-time weights, new admissions
bind the new version, and the rollout completes when the last old-version
lane retires fleet-wide.  No admission pause, no drained windows.

**Failover** — engines fail (``serve.faults``: injected deterministically,
or for real once the runtime meets real hardware).  The tier catches the
typed escalations its engines raise mid-step: a *poison request* is
evicted from its lane and retried on another engine (quarantined with its
replay seed after ``quarantine_after`` faults across engines); a *failed
engine* (dispatch faults past the retry/demotion budget, the
chunk-deadline watchdog, device loss) is marked dead, its host queue
re-routed, and its surviving lanes **evacuated**: each in-flight
``LaneState`` row is snapshotted at the last committed chunk boundary and
re-admitted mid-window onto a healthy engine, where it resumes
bit-identically (the chunked==one-shot property — the row IS the
checkpoint).  Old weight versions an adopting engine already dropped are
restored from the tier's host copies (``WeightBank.ensure``), so a
rollout can never complete while an evacuated old-version lane is still
draining.  Windows that cannot be recovered (state lost with the device,
no healthy engine left) are recorded in :attr:`faulted` as
:class:`~.faults.FaultRecord`\\ s — never silently dropped:
``results ∪ shed ∪ faulted`` exactly partitions the submitted ids.

The whole tier rides the existing bit-identity contract: routing,
shedding and failover change *which* engine serves a request (or whether
it is served) — never its prediction.  Every engine is constructed with
the tier's seed, and requests carry their tier-global id into
``engine.submit(request_id=...)``, so a request's window is a pure
function of ``(seed, id, pixels)`` regardless of placement — the
property test replays random schedules against single-engine serving.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import torch

from ..core.snn import SNNConfig
from ..core.telemetry import estimate_eta_steps, load_score
from .faults import (EngineFailure, FaultInjector, FaultPlan, FaultRecord,
                     FaultToleranceConfig, PoisonDispatchError)
from .snn_engine import RequestResult, SNNStreamEngine

__all__ = ["DEFAULT_PRIORITY_CLASSES", "ShedRecord", "SNNServingTier"]

# Priority classes, ordered lowest → highest.  Overload shedding walks
# this order from the left; deployments override the tuple wholesale
# (configs.snn_mnist.SNNServingTierConfig threads it through).
DEFAULT_PRIORITY_CLASSES = ("batch", "standard", "interactive")


@dataclass(frozen=True)
class ShedRecord:
    """Why a request was not served (the recorded, auditable drop).

    ``reason`` is ``"deadline"`` (the admission-time completion estimate
    exceeded the request's deadline) or ``"overload"`` (every engine
    queue was full and the request was — or was displaced by — a
    higher-priority arrival).
    """

    request_id: int
    reason: str                    # "deadline" | "overload"
    priority: str
    priority_level: int
    deadline_steps: int | None
    eta_steps: float | None = None  # the estimate that rejected it
    displaced_by: int | None = None  # overload: the admitted higher-prio rid


class SNNServingTier:
    """Front-end router over N same-seed streaming engines (class doc
    above; construction knobs mirror ``SNNServingTierConfig``).

    Engines are built on ``device`` (None = the CUDA card; raises without
    one).  ``sharded=True`` instead carves ``devices`` (None = every
    visible card; the list may name one device several times, as the
    port's meshes do) into ``num_engines`` contiguous slices of
    ``devices_per_engine`` — each engine becomes a
    ``ShardedSNNStreamEngine`` over its own slice's data mesh, a
    simulated per-host lane mesh.  ``shedding=False`` disables both shed
    paths (every request is eventually served — the bit-identity
    property's configuration).  ``dispatch_cache`` goes to every engine;
    their startup decisions are :attr:`cache_decisions`.
    """

    def __init__(self, params_q: dict, cfg: SNNConfig, *,
                 num_engines: int = 2, lanes_per_engine: int | None = None,
                 chunk_steps: int | None = None, patience: int = 2,
                 seed: int = 0,
                 backend: str | None = None,
                 priority_classes: tuple = DEFAULT_PRIORITY_CLASSES,
                 default_priority: str = "standard",
                 default_deadline_steps: int | None = None,
                 queue_limit: int | None = None, shedding: bool = True,
                 sharded: bool = False,
                 devices_per_engine: int | None = None,
                 adaptive=None,
                 fault_plan: FaultPlan | str | None = None,
                 fault_cfg: FaultToleranceConfig | None = None,
                 ledger=None,
                 device: str | torch.device | None = None,
                 devices=None,
                 dispatch_cache=None):
        if num_engines < 1:
            raise ValueError(f"num_engines must be >= 1, got {num_engines}")
        if default_priority not in priority_classes:
            raise ValueError(f"default priority {default_priority!r} not in "
                             f"{priority_classes}")
        self.priority_classes = tuple(priority_classes)
        self.default_priority = default_priority
        self.default_deadline_steps = default_deadline_steps
        self.queue_limit = queue_limit
        self.shedding = shedding
        self.seed = seed
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.from_spec(fault_plan)
        self.fault_plan = fault_plan
        self.fault_cfg = fault_cfg or FaultToleranceConfig()

        def _inj(i: int) -> FaultInjector | None:
            # engines built without one still arm from REPRO_FAULT_PLAN
            return (FaultInjector(fault_plan, i)
                    if fault_plan is not None else None)

        self.engines: list[SNNStreamEngine] = []
        if sharded:
            from ..distributed.sharding import (_visible_cards,
                                                make_device_mesh,
                                                refuse_process_mesh)
            from .snn_engine import ShardedSNNStreamEngine
            devs = (_visible_cards() if devices is None
                    else [torch.device(d) for d in devices])
            per = (devices_per_engine if devices_per_engine is not None
                   else len(devs) // num_engines)
            if per < 1 or per * num_engines > len(devs):
                raise ValueError(
                    f"cannot carve {num_engines} × {per}-device hosts out "
                    f"of {len(devs)} visible devices")
            for i in range(num_engines):
                mesh = make_device_mesh(
                    (per,), ("data",), devices=devs[i * per:(i + 1) * per])
                refuse_process_mesh(mesh, "the serving tier")
                self.engines.append(ShardedSNNStreamEngine(
                    params_q, cfg, mesh=mesh,
                    batch_size=lanes_per_engine, chunk_steps=chunk_steps,
                    patience=patience, seed=seed, backend=backend,
                    adaptive=adaptive, engine_id=i, injector=_inj(i),
                    fault_cfg=self.fault_cfg, dispatch_cache=dispatch_cache))
        else:
            for i in range(num_engines):
                self.engines.append(SNNStreamEngine(
                    params_q, cfg, batch_size=lanes_per_engine,
                    chunk_steps=chunk_steps, patience=patience, seed=seed,
                    backend=backend, adaptive=adaptive, engine_id=i,
                    injector=_inj(i), fault_cfg=self.fault_cfg,
                    device=device, dispatch_cache=dispatch_cache))
        # Optional write-ahead accounting ledger (serve.ledger.Ledger):
        # every terminal record — shed, fault, result — is appended as a
        # JSON line the moment the tier commits to it, so a crash of the
        # hosting process never loses the partition proof.  The cluster
        # coordinator passes one per host; standalone tiers run without.
        self.ledger = ledger
        self._ledgered: set[int] = set()   # rids with a result line on disk
        self.shed: dict[int, ShedRecord] = {}
        self.faulted: dict[int, FaultRecord] = {}
        self._dead: set[int] = set()             # failed engine indices
        self._rid_faults: dict[int, int] = {}    # rid -> faults across engines
        # Copies of every published weight-code set, by version — the
        # failover path re-places a gc'd version on an adopting engine
        # from here (WeightBank.ensure), in every form its ladder reads,
        # so an evacuated lane always finishes on its admission-time
        # weights.
        self._version_planes: dict[int, tuple] = {
            0: tuple(layer["w_q"] for layer in params_q["layers"])}
        self._assignment: dict[int, int] = {}    # rid -> engine index
        self._meta: dict[int, tuple] = {}        # rid -> (level, prio, ddl)
        self._next_id = 0
        self.stats = {"routed_per_engine": [0] * num_engines,
                      "shed_deadline": 0, "shed_overload": 0,
                      "displaced": 0, "engines_failed": 0, "evacuated": 0,
                      "requeued": 0, "poison_retries": 0, "quarantined": 0}

    @property
    def cache_decisions(self) -> list:
        """Per-engine dispatch-cache startup decisions (hit/miss, key,
        reason): whether the fleet serves tuned shapes."""
        return [e.cache_decision for e in self.engines]

    # ---- routing --------------------------------------------------------
    def _alive(self) -> list[int]:
        return [i for i in range(len(self.engines)) if i not in self._dead]

    def _route_index(self, exclude: int | None = None) -> int:
        """Least-loaded healthy engine; ties break on the lowest index
        (the deterministic spray order the reproducibility tests replay).
        The health surface rides the same score — a degraded engine bids
        high, a dead one infinite.  ``exclude`` steers a poison-request
        retry away from the engine it just faulted on (when another
        healthy engine exists)."""
        idxs = self._alive()
        if exclude is not None and len(idxs) > 1:
            idxs = [i for i in idxs if i != exclude]
        scores = [(load_score(self.engines[i].load_summary()), i)
                  for i in idxs]
        return min(scores)[1]

    def _level(self, priority: str) -> int:
        try:
            return self.priority_classes.index(priority)
        except ValueError:
            raise ValueError(f"unknown priority class {priority!r}: tier "
                             f"serves {self.priority_classes}") from None

    def _shed(self, rid: int, reason: str, priority: str, level: int,
              deadline: int | None, *, eta: float | None = None,
              displaced_by: int | None = None) -> None:
        self.shed[rid] = ShedRecord(
            request_id=rid, reason=reason, priority=priority,
            priority_level=level, deadline_steps=deadline, eta_steps=eta,
            displaced_by=displaced_by)
        self.stats[f"shed_{reason}"] += 1
        if self.ledger is not None:
            self.ledger.append({"kind": "shed", "rid": rid,
                                **asdict(self.shed[rid])})

    def _overload_victim(self) -> int | None:
        """The queued request overload shedding would displace: lowest
        priority class first, newest arrival within the class (its wait
        so far is the smallest sunk cost).  None if any queue has room."""
        if self.queue_limit is None:
            return None
        alive = [self.engines[i] for i in self._alive()]
        if any(len(e.queue) < self.queue_limit for e in alive):
            return None
        queued = [rid for e in alive for rid, _ in e.queue]
        if not queued:
            return None
        return max(queued, key=lambda r: (-self._meta[r][0], r))

    def _evict(self, victim: int) -> int:
        """Remove a queued request from its engine; returns the engine."""
        idx = self._assignment.pop(victim)
        eng = self.engines[idx]
        eng.queue = [q for q in eng.queue if q[0] != victim]
        self.stats["routed_per_engine"][idx] -= 1
        return idx

    # ---- intake ---------------------------------------------------------
    def submit(self, pixels_u8, *, priority: str | None = None,
               deadline_steps: int | None = None,
               request_id: int | None = None) -> int:
        """Admit (or shed) one request; returns its tier-global id.

        Admission runs entirely at submit time — shed decisions are never
        deferred to a queue scan, so a caller learns a request's fate
        (``rid in tier.shed``) as soon as the tier does.

        All validation (priority class, ``request_id`` collision) runs
        BEFORE any tier state is touched: a rejected submit leaves the
        tier exactly as it found it — no id consumed, no bookkeeping
        entry, no queue mutation (regression-tested; the id counter used
        to advance before the priority check could throw).
        """
        priority = self.default_priority if priority is None else priority
        level = self._level(priority)
        if request_id is None:
            rid = self._next_id
        else:
            rid = int(request_id)
            if rid in self._meta:
                raise ValueError(f"request id {rid} already in use")
        deadline = (self.default_deadline_steps if deadline_steps is None
                    else deadline_steps)
        self._next_id = max(self._next_id, rid + 1)
        self._meta[rid] = (level, priority, deadline)
        if not self._alive():
            # every engine is dead: recorded, never silent
            self._drop(rid, "no_capacity", None)
            return rid
        if not self.shedding:
            self._admit(rid, pixels_u8, self._route_index())
            return rid
        # overload first: a doomed-by-deadline request must not displace a
        # queued one
        victim = self._overload_victim()
        if victim is not None:
            if level <= self._meta[victim][0]:
                # nothing queued is lower-priority than the arrival
                self._shed(rid, "overload", priority, level, deadline)
                return rid
        idx = (self._route_index() if victim is None else None)
        eta = estimate_eta_steps(
            self.engines[idx if idx is not None
                         else self._assignment[victim]].load_summary())
        if deadline is not None and eta > deadline:
            self._shed(rid, "deadline", priority, level, deadline, eta=eta)
            return rid
        if victim is not None:
            vl, vp, vd = self._meta[victim]
            self._shed(victim, "overload", vp, vl, vd, displaced_by=rid)
            idx = self._evict(victim)
            self.stats["displaced"] += 1
        self._admit(rid, pixels_u8, idx)
        return rid

    def _admit(self, rid: int, pixels_u8, idx: int) -> None:
        self.engines[idx].submit(pixels_u8, request_id=rid)
        self._assignment[rid] = idx
        self.stats["routed_per_engine"][idx] += 1

    # ---- failover (serve.faults) ----------------------------------------
    def _drop(self, rid: int, reason: str, engine: int | None,
              detail: str = "") -> None:
        """Record an unrecoverable request — the never-silent fault drop."""
        self._assignment.pop(rid, None)
        self.faulted[rid] = FaultRecord(
            request_id=rid, reason=reason, engine=engine,
            faults=self._rid_faults.get(rid, 0),
            replay_seed=self.seed + rid, detail=detail)
        if reason == "quarantined":
            self.stats["quarantined"] += 1
        if self.ledger is not None:
            self.ledger.append({"kind": "fault", "rid": rid,
                                **asdict(self.faulted[rid])})

    def _adopt_row(self, tgt: int, rid: int, row) -> None:
        """Re-admit one evacuated lane row onto engine ``tgt``, restoring
        its (possibly garbage-collected) weight version first."""
        eng = self.engines[tgt]
        v = int(row.weight_version)
        if v not in eng.bank.versions:
            eng.bank.ensure(v, eng._place_weights(self._version_planes[v]))
        eng.adopt(rid, row)
        self._assignment[rid] = tgt

    def _handle_poison(self, idx: int, fault: PoisonDispatchError) -> None:
        """Evict the poison request's lane; retry elsewhere or quarantine.

        The lane row is evacuated bit-exactly, so if the fault was
        engine-local (or transient) the retried window still resumes
        bit-identically.  After ``fault_cfg.quarantine_after`` faults
        across engines the request is quarantined with its replay seed
        (``FaultRecord``) instead of being retried forever.
        """
        rid = fault.request_id
        row = self.engines[idx].evict_lane(rid)
        self._rid_faults[rid] = self._rid_faults.get(rid, 0) + 1
        if self._rid_faults[rid] >= self.fault_cfg.quarantine_after:
            self._drop(rid, "quarantined", idx, detail=str(fault))
            return
        self._adopt_row(self._route_index(exclude=idx), rid, row)
        self.stats["poison_retries"] += 1

    def _handle_engine_failure(self, idx: int, fault: EngineFailure) -> None:
        """Failover: mark the engine dead, evacuate its lanes, re-route
        its queue, and record what could not be recovered.

        The failed engine's in-flight lanes are snapshotted at their last
        committed chunk boundary (the injector faults *before* a launch,
        and a hung launch makes no progress, so the device tile is always
        valid pre-fault state) and re-admitted least-loaded onto healthy
        engines — resuming bit-identically mid-window.  ``state_lost``
        failures (device gone with its memory) shed every in-flight lane
        as a ``FaultRecord`` instead; the host queue and pending
        adoptions are host-side and always recoverable.  The dead
        engine's draining weight versions are freed (``bank.abort``) —
        its lanes now live elsewhere, restored via the tier's host
        copies.
        """
        eng = self.engines[idx]
        self._dead.add(idx)
        self.stats["engines_failed"] += 1
        queued = list(eng.queue)
        eng.queue.clear()
        adoptions = list(eng._adoptions)
        eng._adoptions.clear()
        if fault.state_lost:
            rows = []
            lost = [r for r in eng.lane_req if r is not None]
            eng.lane_req = [None] * eng.batch_size
        else:
            rows = eng.snapshot_lanes()
            lost = []
        eng.bank.abort()
        for rid in lost:
            self._drop(rid, "state_lost", idx, detail=str(fault))
        for rid, row in rows + adoptions:
            if not self._alive():
                self._drop(rid, "engine_lost", idx, detail=str(fault))
                continue
            self._adopt_row(self._route_index(), rid, row)
            self.stats["evacuated"] += 1
        for rid, px in queued:
            if not self._alive():
                self._drop(rid, "engine_lost", idx, detail=str(fault))
                continue
            tgt = self._route_index()
            self.engines[tgt].submit(px, request_id=rid)
            self._assignment[rid] = tgt
            self.stats["requeued"] += 1

    def _ledger_results(self, rids) -> None:
        """Replicate finished results to the host ledger (exactly once).

        A result computed but not yet acknowledged upstream must survive
        the hosting process dying: the line lands on disk the round the
        lane retires, before anything else consumes it.  No-op without a
        ledger; ``_ledgered`` makes re-harvests idempotent.
        """
        if self.ledger is None:
            return
        from .wire import result_to_wire
        for rid in rids:
            if rid in self._ledgered:
                continue
            for e in self.engines:
                if rid in e.results:
                    self.ledger.append({"kind": "result", "rid": rid,
                                        **result_to_wire(e.results[rid])})
                    self._ledgered.add(rid)
                    break

    # ---- drive ----------------------------------------------------------
    @property
    def pending(self) -> int:
        return sum(self.engines[i].pending for i in self._alive())

    def step(self) -> list[int]:
        """One chunk on every healthy engine with work; returns finished
        rids.  Engine faults surface here as typed exceptions and are
        handled inline — an engine failing mid-round hands its work to
        the engines after it in the same round."""
        done = []
        for idx, e in enumerate(self.engines):
            if idx in self._dead or not e.pending:
                continue
            try:
                done.extend(e.step())
            except PoisonDispatchError as f:
                self._handle_poison(idx, f)
            except EngineFailure as f:
                self._handle_engine_failure(idx, f)
        self._ledger_results(done)
        return done

    def run(self, max_chunks: int | None = None) -> dict[int, RequestResult]:
        """Drive all engines until every admitted request has a result.

        Engines advance in lockstep rounds (one chunk each per round) —
        the in-process stand-in for N hosts running concurrently.  Shed
        requests are *not* in the returned dict; they are in
        :attr:`shed`, and fault casualties in :attr:`faulted` — the three
        together partition every submitted id.
        """
        limit = max_chunks if max_chunks is not None else sum(
            (e.pending + e.batch_size)
            * (e.cfg.num_steps // max(1, e.controller.min_chunk_steps) + 2)
            for e in self.engines) + (
                64 * len(self.engines)
                if any(e.injector is not None for e in self.engines) else 0)
        for _ in range(limit):
            if self.pending == 0:
                break
            self.step()
        for i in self._alive():
            self.engines[i].run(max_chunks=0)  # final harvest
        self._ledger_results(list(self.results))
        return self.results

    @property
    def results(self) -> dict[int, RequestResult]:
        out: dict[int, RequestResult] = {}
        for e in self.engines:
            out.update(e.results)
        return out

    def load_report(self) -> list:
        """Per-engine ``EngineLoad`` snapshot (ordered by engine index)."""
        return [e.load_summary() for e in self.engines]

    # ---- weight rollout -------------------------------------------------
    def begin_rollout(self, params_q: dict) -> int:
        """Broadcast new weights to every engine, zero-drain.

        Returns the fleet-wide new version (healthy engines move in
        lockstep — they were constructed together and roll together;
        dead engines are skipped, their drained versions already
        aborted).  Completion is per-engine as its last old-version lane
        retires; :attr:`rollout_active` goes False when the whole healthy
        fleet finished — including lanes evacuated onto engines that had
        already dropped the old version (restored via ``bank.ensure``),
        which is why a rollout can never complete while an old-version
        lane sits anywhere alive.
        """
        versions = {self.engines[i].begin_rollout(params_q)
                    for i in self._alive()}
        assert len(versions) == 1, f"engines out of lockstep: {versions}"
        v = versions.pop()
        self._version_planes[v] = tuple(
            layer["w_q"] for layer in params_q["layers"])
        return v

    @property
    def rollout_active(self) -> bool:
        return any(self.engines[i].bank.rolling for i in self._alive())

    def rollout_history(self) -> list:
        """Per-engine rollout event logs (ordered by engine index)."""
        return [list(e.bank.history) for e in self.engines]
