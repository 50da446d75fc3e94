"""Deterministic fault injection + the serving fault-tolerance vocabulary
(port of ``repro.serve.faults``).

An engine that assumed every dispatch succeeds would lose every in-flight
window on one failed launch and wedge the router.  The paper's
active-pruning mechanism *disables* neurons rather than failing hard, so
the serving tier survives faults the way the datapath survives pruning.
This module provides the two halves of that layer:

**Deterministic fault injection** — :class:`FaultPlan` is a seeded,
replayable schedule of injected failures (transient dispatch exceptions,
engine hangs past a chunk deadline, device loss with or without lane
state, corrupted telemetry chunks, poison requests that fault wherever
they are dispatched).  A :class:`FaultInjector` binds one engine to the
plan and is consulted by ``SNNStreamEngine._dispatch_chunk`` before and
after every launch — single-device and sharded paths alike.  Fault
decisions are pure functions of ``(plan seed, engine id, consult index,
attempt)`` drawn exactly as the reference package draws them, so one plan
injects the same faults in both packages, and a replayed run injects the
identical fault sequence (``REPRO_FAULT_PLAN=seed=11,dispatch=0.03``)
with bit-identical results, because every recovery path is value-neutral
by construction.

**Recovery vocabulary** — the typed exceptions the engines raise
(:class:`DispatchFault` transient, :class:`DeviceLostFault` permanent,
:class:`PoisonDispatchError` request-attributed, :class:`EngineFailure`
the escalation the tier's failover consumes), the per-engine
:class:`EngineHealthState` the health surface is built from, the
:class:`FaultToleranceConfig` policy knobs (retry budget, deterministic
backoff, demotion/promotion thresholds, watchdog deadline, quarantine
count), and :class:`FaultRecord` — the never-silent accounting entry for
a window that could not be served (mirroring ``router.ShedRecord``:
``results ∪ shed ∪ faulted`` exactly partitions the submitted ids).

Only the telemetry check touches the device: it reads a chunk's record
back to the host, which the engines do only while an injector is armed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "DispatchFault", "DeviceLostFault", "PoisonDispatchError",
    "EngineFailure", "FaultEvent", "FaultPlan", "FaultPlanSpecError",
    "FaultInjector", "FaultToleranceConfig", "EngineHealthState",
    "FaultRecord", "telemetry_ok", "injector_from_env",
    "REPRO_FAULT_PLAN_ENV", "FAULT_PLAN_GRAMMAR",
]

REPRO_FAULT_PLAN_ENV = "REPRO_FAULT_PLAN"

# The accepted REPRO_FAULT_PLAN grammar — quoted verbatim by every spec
# rejection so a typo'd key fails with the fix in the message.
FAULT_PLAN_GRAMMAR = (
    "seed=<int> | dispatch=<rate in [0,1]> | telemetry=<rate in [0,1]> | "
    "worker_kill=<worker>@<round> | worker_hang=<worker>@<round> | "
    "coordinator_kill=<round>   (comma-separated; worker_kill/worker_hang/"
    "coordinator_kill may repeat)")


# ---- typed faults ---------------------------------------------------------

class FaultError(RuntimeError):
    """Base of every injected/declared serving fault."""


class DispatchFault(FaultError):
    """Transient chunk-dispatch failure (retryable; the backoff path)."""

    def __init__(self, msg: str, *, engine: int, seq: int, attempt: int):
        super().__init__(msg)
        self.engine, self.seq, self.attempt = engine, seq, attempt


class DeviceLostFault(FaultError):
    """Permanent device loss.  ``state_lost=True`` additionally marks the
    lane state unrecoverable — the in-flight windows cannot be evacuated
    and must be shed with :class:`FaultRecord`\\ s."""

    def __init__(self, msg: str, *, engine: int, state_lost: bool = False):
        super().__init__(msg)
        self.engine, self.state_lost = engine, state_lost


class PoisonDispatchError(FaultError):
    """A specific request faults every launch that includes it.  Raised
    before the launch (the lane state is intact), carrying the request id
    so the tier can evict the lane, retry it elsewhere, and quarantine it
    after ``FaultToleranceConfig.quarantine_after`` faults."""

    def __init__(self, msg: str, *, request_id: int, engine: int):
        super().__init__(msg)
        self.request_id, self.engine = request_id, engine


class EngineFailure(FaultError):
    """An engine declared itself failed — the tier's failover trigger.

    ``reason`` is ``"device_lost"``, ``"hang"`` (chunk-deadline watchdog
    tripped) or ``"dispatch_exhausted"`` (transient faults persisted past
    the retry/demotion budget).  ``state_lost`` says whether the lane
    snapshot survives for evacuation.
    """

    def __init__(self, msg: str, *, engine: int, reason: str,
                 state_lost: bool = False):
        super().__init__(msg)
        self.engine, self.reason, self.state_lost = engine, reason, state_lost


# ---- the plan -------------------------------------------------------------

class FaultPlanSpecError(ValueError):
    """A malformed ``REPRO_FAULT_PLAN``-style spec, rejected loudly.

    Names the offending key/value and quotes the accepted grammar — a
    typo (``dipsatch=0.03``) must fail the run, never silently arm
    nothing while CI believes chaos is on.
    """

    def __init__(self, key: str, detail: str):
        self.key = key
        super().__init__(
            f"bad {REPRO_FAULT_PLAN_ENV} entry {key!r}: {detail} — "
            f"accepted grammar: {FAULT_PLAN_GRAMMAR}")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``chunk`` coordinates are engine-local
    dispatch-consult indices (the injector counts every ``before``
    consultation, retries included — deterministic because the serving
    loops are single-threaded); ``last_chunk=None`` means the fault
    persists forever (a "kill"), a bounded range models a transient
    brown-out the retry/backoff/ladder machinery should ride through.

    kinds: ``dispatch`` (transient launch exception), ``hang`` (the
    device stalls — dispatches make no progress until the watchdog
    trips), ``device_loss`` (permanent; ``state_lost`` optionally
    destroys the lane snapshot), ``telemetry`` (the side-channel record
    of this chunk comes back corrupted), ``poison`` (every launch
    containing ``request_id`` faults, on any engine).
    ``backends`` restricts a ``dispatch`` fault to specific chunk
    backends — the degradation-ladder tests use it to fail the fused
    launch persistently while the demoted rungs stay clean.

    Process-level kinds (serve.cluster — coordinates are the
    coordinator's **global scheduling round**, which never resets across
    worker respawns, so a windowed kill fires in exactly one
    incarnation): ``worker_kill`` (the worker process exits hard before
    running the round's chunk; ``engine`` is the worker slot and
    ``state_lost`` additionally discards the coordinator's shipped
    checkpoint — simulating correlated loss of host and replica),
    ``worker_hang`` (the worker stops responding — the heartbeat-drop
    fault; the coordinator's deadline detects it), ``coordinator_kill``
    (the coordinator itself dies at the top of the round — recovery must
    come from the write-ahead ledger).
    """

    kind: str                        # dispatch|hang|device_loss|telemetry|poison
    engine: int | None = None        # None = any engine
    first_chunk: int = 0
    last_chunk: int | None = None    # inclusive; None = forever
    request_id: int | None = None    # poison target
    backends: tuple | None = None    # dispatch: only these backends fault
    state_lost: bool = False         # device_loss: snapshot unrecoverable

    def _active(self, engine: int, seq: int) -> bool:
        if self.engine is not None and engine != self.engine:
            return False
        if seq < self.first_chunk:
            return False
        return self.last_chunk is None or seq <= self.last_chunk


class FaultPlan:
    """Seeded, replayable schedule of injected failures.

    Two layers compose: explicit :class:`FaultEvent`\\ s (targeted kills
    and brown-outs — what the failover contract tests drive) and seeded
    *rates* (``dispatch_rate``/``telemetry_rate`` — background chaos for
    whole-suite CI runs).  Rate decisions hash ``(seed, engine, consult
    index, attempt)`` through an independent PRNG stream per coordinate,
    so the same plan replayed injects the identical faults, and a retry
    (new attempt) re-rolls rather than deterministically re-faulting.

    ``REPRO_FAULT_PLAN`` activates a plan for every engine constructed
    without an explicit injector, spec ``seed=11,dispatch=0.03,
    telemetry=0.02`` — rates only, because transient faults are the one
    class a *standalone* engine fully absorbs (hangs/device loss need a
    tier to evacuate to).
    """

    def __init__(self, events: tuple = (), *, seed: int = 0,
                 dispatch_rate: float = 0.0, telemetry_rate: float = 0.0):
        self.events = tuple(events)
        self.seed = int(seed)
        self.dispatch_rate = float(dispatch_rate)
        self.telemetry_rate = float(telemetry_rate)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the compact ``k=v[,k=v...]`` env spec.

        Strict: unknown keys, malformed values and out-of-range rates
        all raise :class:`FaultPlanSpecError` quoting the accepted
        grammar (:data:`FAULT_PLAN_GRAMMAR`).  Beyond the seeded rates,
        the spec can schedule the process-level faults the cluster
        chaos lane drives: ``worker_kill=1@3`` kills worker 1 at global
        round 3, ``worker_hang=0@2`` drops worker 0's heartbeat from
        round 2, ``coordinator_kill=5`` crashes the coordinator at the
        top of round 5.
        """
        rates = {"seed": "seed", "dispatch": "dispatch_rate",
                 "telemetry": "telemetry_rate"}
        kw: dict = {"seed": 0, "dispatch_rate": 0.0, "telemetry_rate": 0.0}
        events: list[FaultEvent] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            if not eq:
                raise FaultPlanSpecError(part, "missing '=<value>'")
            if k in rates:
                try:
                    val = int(v) if k == "seed" else float(v)
                except ValueError:
                    raise FaultPlanSpecError(
                        part, f"value {v!r} is not "
                        f"{'an integer' if k == 'seed' else 'a number'}"
                    ) from None
                if k != "seed" and not 0.0 <= val <= 1.0:
                    raise FaultPlanSpecError(
                        part, f"rate {val} outside [0, 1]")
                kw[rates[k]] = val
            elif k in ("worker_kill", "worker_hang"):
                w, at, r = v.partition("@")
                try:
                    if not at:
                        raise ValueError
                    worker, rnd = int(w), int(r)
                except ValueError:
                    raise FaultPlanSpecError(
                        part, f"value {v!r} is not '<worker>@<round>' "
                        f"(two integers)") from None
                if worker < 0 or rnd < 0:
                    raise FaultPlanSpecError(
                        part, "worker and round must be >= 0")
                events.append(FaultEvent(
                    kind=k, engine=worker, first_chunk=rnd,
                    last_chunk=rnd))
            elif k == "coordinator_kill":
                try:
                    rnd = int(v)
                except ValueError:
                    raise FaultPlanSpecError(
                        part, f"value {v!r} is not an integer round"
                    ) from None
                if rnd < 0:
                    raise FaultPlanSpecError(part, "round must be >= 0")
                events.append(FaultEvent(
                    kind=k, first_chunk=rnd, last_chunk=rnd))
            else:
                known = sorted(rates) + ["worker_kill", "worker_hang",
                                         "coordinator_kill"]
                raise FaultPlanSpecError(
                    part, f"unknown key {k!r} (known keys: {known})")
        return cls(tuple(events), seed=kw.pop("seed"), **kw)

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        spec = os.environ.get(REPRO_FAULT_PLAN_ENV)
        return cls.from_spec(spec) if spec else None

    # -- queries (pure in (engine, seq, attempt)) --------------------------
    def _roll(self, *coords: int) -> float:
        return float(np.random.default_rng(
            (self.seed,) + tuple(int(c) for c in coords)).random())

    def poison_rid(self, engine: int, seq: int, rids) -> int | None:
        for ev in self.events:
            if (ev.kind == "poison" and ev._active(engine, seq)
                    and ev.request_id in rids):
                return ev.request_id
        return None

    def device_loss(self, engine: int, seq: int) -> FaultEvent | None:
        for ev in self.events:
            if ev.kind == "device_loss" and ev._active(engine, seq):
                return ev
        return None

    def hang(self, engine: int, seq: int) -> bool:
        return any(ev.kind == "hang" and ev._active(engine, seq)
                   for ev in self.events)

    def dispatch_fault(self, engine: int, seq: int, attempt: int,
                       backend: str) -> bool:
        for ev in self.events:
            if (ev.kind == "dispatch" and ev._active(engine, seq)
                    and (ev.backends is None or backend in ev.backends)):
                return True
        if self.dispatch_rate > 0.0:
            return self._roll(engine, seq, attempt, 0) < self.dispatch_rate
        return False

    def corrupt_telemetry(self, engine: int, seq: int) -> bool:
        if any(ev.kind == "telemetry" and ev._active(engine, seq)
               for ev in self.events):
            return True
        if self.telemetry_rate > 0.0:
            return self._roll(engine, seq, 1) < self.telemetry_rate
        return False

    # -- process-level queries (serve.cluster; coords = global round) ------
    def worker_kill(self, worker: int, rnd: int) -> "FaultEvent | None":
        for ev in self.events:
            if ev.kind == "worker_kill" and ev._active(worker, rnd):
                return ev
        return None

    def worker_hang(self, worker: int, rnd: int) -> bool:
        return any(ev.kind == "worker_hang" and ev._active(worker, rnd)
                   for ev in self.events)

    def coordinator_kill(self, rnd: int) -> bool:
        # engine is irrelevant for the coordinator's own death; _active's
        # engine filter is bypassed by matching the event's own slot
        return any(ev.kind == "coordinator_kill"
                   and ev._active(ev.engine if ev.engine is not None
                                  else 0, rnd)
                   for ev in self.events)

    def engine_relevant(self, engine: int) -> bool:
        """Whether a *worker-local* engine injector would ever fire —
        rates, or any non-process event that can reach ``engine``."""
        if self.dispatch_rate > 0.0 or self.telemetry_rate > 0.0:
            return True
        return any(
            ev.kind in ("dispatch", "hang", "device_loss", "telemetry",
                        "poison")
            and (ev.engine is None or ev.engine == engine)
            for ev in self.events)


class FaultInjector:
    """One engine's binding to a :class:`FaultPlan`.

    The engine consults :meth:`before_dispatch` ahead of every launch
    attempt (it raises the scheduled typed fault, or returns ``"hang"``
    when the device should stall this chunk) and passes each launch's
    telemetry through :meth:`filter_telemetry` (which corrupts the record
    when the plan says so — the engine's own validation must catch it).
    The injector owns the monotone consult counter, so the fault
    coordinates are a pure function of the (single-threaded) call
    sequence.
    """

    def __init__(self, plan: FaultPlan, engine_id: int = 0):
        self.plan = plan
        self.engine_id = int(engine_id)
        self.consults = 0               # dispatch-consult index ("chunk")

    def before_dispatch(self, attempt: int, *, backend: str, rids) -> str:
        e, seq = self.engine_id, self.consults
        self.consults += 1
        loss = self.plan.device_loss(e, seq)
        if loss is not None:
            raise DeviceLostFault(
                f"injected device loss on engine {e} at consult {seq}",
                engine=e, state_lost=loss.state_lost)
        rid = self.plan.poison_rid(e, seq, rids)
        if rid is not None:
            raise PoisonDispatchError(
                f"injected poison fault for request {rid} on engine {e}",
                request_id=rid, engine=e)
        if self.plan.dispatch_fault(e, seq, attempt, backend):
            raise DispatchFault(
                f"injected dispatch fault on engine {e} at consult {seq} "
                f"(attempt {attempt}, backend {backend!r})",
                engine=e, seq=seq, attempt=attempt)
        return "hang" if self.plan.hang(e, seq) else "ok"

    def filter_telemetry(self, tel):
        """Possibly corrupt one chunk's telemetry record (plan-driven)."""
        if tel is None or not self.plan.corrupt_telemetry(
                self.engine_id, self.consults - 1):
            return tel
        # flip the spike-count leaf negative (on its own device):
        # impossible under the telemetry contract, so host validation must
        # reject the record
        return tel._replace(n_spk=-(torch.abs(tel.n_spk) + 1))


def injector_from_env(engine_id: int) -> FaultInjector | None:
    """The env-armed injector for engines built without an explicit one."""
    plan = FaultPlan.from_env()
    return None if plan is None else FaultInjector(plan, engine_id)


def telemetry_ok(tel) -> bool:
    """Host-side validity check of a chunk's telemetry record.

    The side channel's contract makes corruption cheap to detect: every
    leaf is an integer count, so a float, bool or complex leaf, or any
    negative entry, falsifies the record.  The leaves stay on their
    device; the check reads one flag back, which the engines do only when
    a fault harness is armed.
    """
    if tel is None:
        return False
    leaves = [torch.as_tensor(leaf) for leaf in
              (tel.n_spk, tel.n_en, tel.tiles_skipped)]
    if any(a.dtype.is_floating_point or a.dtype.is_complex
           or a.dtype == torch.bool for a in leaves):
        return False
    signed = [a for a in leaves if torch.iinfo(a.dtype).min < 0]
    return not (signed and bool(torch.stack(
        [(a < 0).any() for a in signed]).any()))


# ---- policy + health ------------------------------------------------------

@dataclass(frozen=True)
class FaultToleranceConfig:
    """Recovery-policy knobs shared by the engines and the tier.

    Backoff is deterministic and counted in *scheduling rounds* (the
    tier's lockstep step currency), not wall-clock: after a round whose
    immediate retries all faulted, the engine sits out
    ``min(backoff_base << burst, backoff_max)`` rounds before retrying —
    replayable, and bounded so a recovering engine rejoins quickly.

    The heartbeat knobs drive the *process-level* watchdog
    (serve.cluster): the coordinator pings idle workers every
    ``heartbeat_interval_s`` and declares a worker hung when any RPC
    frame takes longer than ``heartbeat_deadline_s`` — wall-clock, not
    rounds, because a hung process produces no rounds to count.  These
    are deliberately generous defaults (detection latency only — which
    round a hang is *declared* in stays deterministic, because a hung
    worker stops responding at a plan-scheduled round and never
    responds again).  ``max_respawns`` bounds restart-and-readopt per
    worker slot.

    Every knob is validated at construction (the config travels over
    RPC and through ``SNNServingTierConfig`` — a bad value must fail
    where it was written, not rounds later inside a recovery path).
    """

    max_retries: int = 2        # immediate same-round retries per dispatch
    fail_after: int = 6         # consecutive faults ⇒ EngineFailure
    backoff_base: int = 1       # rounds; doubles per faulting round
    backoff_max: int = 4        # rounds; the bound on the backoff
    demote_after: int = 2       # consecutive faults ⇒ step down the ladder
    promote_after: int = 4      # clean chunks ⇒ probe one rung back up
    watchdog_chunks: int = 4    # stalled chunks ⇒ declare the engine hung
    quarantine_after: int = 3   # per-request faults ⇒ quarantine (tier)
    heartbeat_interval_s: float = 0.05  # coordinator→worker idle ping period
    heartbeat_deadline_s: float = 10.0  # RPC deadline ⇒ worker declared hung
    max_respawns: int = 1       # restart-and-readopt budget per worker slot

    def __post_init__(self):
        for name in ("fail_after", "backoff_base", "backoff_max",
                     "demote_after", "promote_after", "watchdog_chunks",
                     "quarantine_after"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"FaultToleranceConfig.{name} must be >= 1, got "
                    f"{getattr(self, name)}")
        for name in ("max_retries", "max_respawns"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"FaultToleranceConfig.{name} must be >= 0, got "
                    f"{getattr(self, name)}")
        if not self.heartbeat_interval_s > 0:
            raise ValueError(
                f"FaultToleranceConfig.heartbeat_interval_s must be > 0, "
                f"got {self.heartbeat_interval_s}")
        if not self.heartbeat_deadline_s > self.heartbeat_interval_s:
            raise ValueError(
                f"FaultToleranceConfig.heartbeat_deadline_s "
                f"({self.heartbeat_deadline_s}) must exceed "
                f"heartbeat_interval_s ({self.heartbeat_interval_s}) — a "
                f"deadline shorter than the ping period declares every "
                f"healthy worker hung")


@dataclass
class EngineHealthState:
    """Mutable per-engine fault/demotion bookkeeping (host-only).

    The load-visible slice of this state rides on
    ``core.telemetry.EngineLoad`` (consecutive faults, demotion level,
    watchdog margin, liveness) so ``load_score`` steers traffic away from
    degraded engines; ``events`` is the auditable transition log
    (demotions, promotions, failures), mirrored into the telemetry
    controller's history where the dispatch decisions already live.
    """

    alive: bool = True
    demotion_level: int = 0        # index into the engine's backend ladder
    consecutive_faults: int = 0
    total_faults: int = 0
    telemetry_faults: int = 0      # corrupted side-channel records dropped
    clean_chunks: int = 0          # consecutive clean chunks at this level
    stalled_chunks: int = 0        # consecutive no-progress chunks (hang)
    events: list = field(default_factory=list)

    def record_fault(self, kind: str, detail: str = "") -> None:
        self.total_faults += 1
        self.consecutive_faults += 1
        self.clean_chunks = 0
        self.events.append({"event": "fault", "kind": kind,
                            "detail": detail})

    def record_clean(self) -> None:
        self.consecutive_faults = 0
        self.clean_chunks += 1


@dataclass(frozen=True)
class FaultRecord:
    """Why a request was lost to a fault (the recorded, auditable drop —
    the fault-path sibling of ``router.ShedRecord``; ``results ∪ shed ∪
    faulted`` exactly partitions a tier's submitted ids).

    ``reason``: ``"state_lost"`` (its engine died with the lane snapshot
    unrecoverable), ``"engine_lost"`` (its engine died and no healthy
    engine remained to evacuate to), ``"no_capacity"`` (submitted while
    every engine was dead), or ``"quarantined"`` (faulted
    ``quarantine_after`` times across engines — a poison request).
    ``replay_seed`` is the PRNG seed its window runs under
    (``tier.seed + request_id``), so a quarantined request is exactly
    reproducible offline.
    """

    request_id: int
    reason: str
    engine: int | None = None       # the engine whose fault dropped it
    faults: int = 0                 # faults attributed to this request
    replay_seed: int | None = None
    detail: str = ""
