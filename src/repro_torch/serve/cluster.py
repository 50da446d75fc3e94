"""Process-level failover tier: heartbeat coordinator over worker processes
(port of ``repro.serve.cluster``).

The serving tier (``serve.router``) survives *engine* failures inside one
Python process; this module covers the failure domain above it — a whole
engine process dying, or the coordinator process itself.  A
:class:`ClusterCoordinator` supervises ``num_workers`` subprocess workers,
each owning one :class:`~.snn_engine.SNNStreamEngine` on ``device``, over
length-prefixed JSON-frame pipes (``serve.wire``), and keeps the tier's
contract one level up: **any schedule of worker kills plus one
coordinator kill matches the no-fault run prediction for prediction**,
with every lost-state window accounted in a :class:`~.faults.FaultRecord`.

Four mechanisms compose:

**Heartbeat + deadline detection** — every RPC read runs under
``fault_cfg.heartbeat_deadline_s``, on the host's clock: a worker that
cannot produce its frame in time — a hung kernel included — is declared
hung and killed; a closed pipe is a crash.  Idle workers are pinged every
``heartbeat_interval_s`` so a crash never hides behind an empty queue.

**Checkpoint shipping + evacuation** — every ``step`` reply carries the
worker's active lanes as wire-serialized chunk-boundary checkpoints
(``engine.checkpoint_lanes`` → :func:`~.wire.lane_to_wire`); the
coordinator's shadow copy is therefore always the current state.  When a
worker dies, its shadow rows are adopted — least-loaded, with
garbage-collected weight versions replayed via ``WeightBank.ensure`` —
onto survivors, where they resume **bit-identically**.  Requests queued
but never checkpointed restart from their write-ahead pixels: a window is
a pure function of ``(seed, request_id, pixels)``.

**Restart-and-readopt** — a dead worker is respawned (budget
``fault_cfg.max_respawns`` per slot), its ``WeightBank`` seeded at the
fleet's current version, the promotion probe run (one chunk dispatch must
succeed before the slot re-enters routing), and the fresh process
re-admitted into ``load_score`` routing.

**Write-ahead replicated ledger** — the coordinator appends one JSONL
line per accounting event (``serve.ledger``), with the ``submit`` line
(pixels included) written *before* routing; every worker replicates its
``result`` lines to its own file before shipping them.  :meth:`recover`
folds all ledger files back into ``results ∪ shed ∪ faulted`` (results
win over shed and fault records), replays ledgered weight rollouts, and
re-runs the outstanding ids from their write-ahead pixels with their
original SLO deadlines.

Faults are injected deterministically (``serve.faults.FaultPlan``):
``worker_kill`` / ``worker_hang`` / ``coordinator_kill`` events fire on
coordinator **global rounds**, windowed ``[r, r]`` so an event fires in
exactly one worker incarnation, and a *recovered* coordinator suppresses
``coordinator_kill``.

Workers are spawned with ``subprocess.Popen`` (fork and exec, never a
fork of a process that holds a CUDA context) as ``python -c '... from
repro_torch.serve.cluster import _worker_main ...' <read_fd> <write_fd>``
with both pipe ends inherited via ``pass_fds`` — dedicated fds, so stray
``print``\\ s to stdout never corrupt a frame.  Each worker is its own
process with its own CUDA context; several may share one card.  The RPC
grammar, reply fields, error texts, stats keys and ledger lines are the
JAX module's, so either package recovers the other's ledger; on the wire
every array is numpy, in the worker the engine's tensors sit on its
device.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from glob import glob

import numpy as np
import torch

from ..core.snn import SNNConfig
from ..core.telemetry import (EngineLoad, engine_load_from_wire,
                              engine_load_to_wire, estimate_eta_steps,
                              load_score)
from .faults import (REPRO_FAULT_PLAN_ENV, FaultInjector, FaultPlan,
                     FaultRecord, FaultToleranceConfig)
from .ledger import Ledger, recover_accounting
from .router import ShedRecord
from .snn_engine import SNNStreamEngine
from .wire import (array_from_wire, array_to_wire, fault_cfg_from_wire,
                   fault_cfg_to_wire, lane_from_wire, lane_to_wire,
                   params_from_wire, params_to_wire, planes_from_wire,
                   planes_to_wire, plan_from_wire, plan_to_wire, read_frame,
                   read_msg, result_from_wire, result_to_wire,
                   snn_cfg_from_wire, snn_cfg_to_wire, write_msg)

__all__ = ["ClusterCoordinator", "CoordinatorCrash", "WorkerDied"]

# init / probe / rollout: a cold worker imports torch, places its weights
# and loads the built kernels; a module constant, so tests can lower it
_RPC_LONG_TIMEOUT_S = 300.0


class CoordinatorCrash(RuntimeError):
    """The coordinator's own injected death (``coordinator_kill``).

    Raised out of :meth:`ClusterCoordinator.step`/``run`` after every
    worker is killed — the caller recovers with
    :meth:`ClusterCoordinator.recover` against the same ``ledger_dir``.
    """


class WorkerDied(Exception):
    """Internal signal: an RPC to a worker failed (crash/hang/error)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason      # "crash" | "hang" | "error"
        self.detail = detail


@dataclass
class WorkerHandle:
    """Coordinator-side state of one worker process slot."""

    proc: subprocess.Popen
    rfd: int                      # read end (worker → coordinator)
    wfd: int                      # write end (coordinator → worker)
    alive: bool = True
    incarnation: int = 0          # respawn count of this slot
    pending: int = 0              # engine-reported outstanding work
    shadow: dict = field(default_factory=dict)   # rid -> wire lane row
    versions: set = field(default_factory=set)   # bank versions on worker
    load: EngineLoad | None = None
    last_contact: float = 0.0     # monotonic instant of the last reply
    backend: str | None = None    # the promotion probe's backend_effective
    error: str = ""               # why the slot died at spawn, if it did


def _record_fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


class ClusterCoordinator:
    """Tier coordinator over N per-host engine processes (module doc).

    The accounting surface mirrors :class:`~.router.SNNServingTier`:
    :attr:`results`, :attr:`shed`, :attr:`faulted` — together they
    exactly partition every submitted id, and now survive any process in
    the cluster dying.  Use as a context manager (or call
    :meth:`close`): worker processes are real and must be reaped.

    Workers build their engines on ``device`` (None = the CUDA card); a
    worker never picks the CPU by itself: without a card its ``init``
    fails and the slot stays dead.  :attr:`telemetry` counts the rounds'
    host seconds and the step replies' bytes and RPC seconds.
    """

    def __init__(self, params_q: dict, cfg: SNNConfig, *,
                 num_workers: int = 2, lanes_per_worker: int = 4,
                 chunk_steps: int = 4, patience: int = 2, seed: int = 0,
                 backend: str | None = None,
                 fault_plan: FaultPlan | str | None = None,
                 fault_cfg: FaultToleranceConfig | None = None,
                 ledger_dir: str | None = None,
                 device: str | torch.device | None = None,
                 _recovered: bool = False):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if ledger_dir is None:
            raise ValueError(
                "ClusterCoordinator requires ledger_dir: the write-ahead "
                "accounting ledger is the crash-recovery contract, not an "
                "option")
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.from_spec(fault_plan)
        self.fault_plan = fault_plan
        self.fault_cfg = fault_cfg or FaultToleranceConfig()
        self.cfg = cfg
        self.seed = int(seed)
        self.backend = backend
        self.device = None if device is None else str(torch.device(device))
        self.num_workers = int(num_workers)
        self.lanes_per_worker = int(lanes_per_worker)
        self.chunk_steps = int(chunk_steps)
        self.patience = int(patience)
        self.n_in = int(cfg.layer_sizes[0])
        self.ledger_dir = ledger_dir
        self._ledger = Ledger(os.path.join(ledger_dir, "coordinator.jsonl"))
        # recovered coordinators never replay their own death — the
        # ledger already recorded the first one (see module doc)
        self._suppress_coordinator_kill = bool(_recovered)
        self._crash_after_evacuations: int | None = None  # test hook

        self._version_planes: dict[int, tuple] = {
            0: tuple(layer["w_q"] for layer in params_q["layers"])}
        self._version_params: dict[int, dict] = {0: params_q}
        self._current_version = 0

        self.results: dict[int, object] = {}
        self.shed: dict[int, ShedRecord] = {}
        self.faulted: dict[int, FaultRecord] = {}
        self._pixels: dict[int, np.ndarray] = {}   # rid -> px until terminal
        self._assignment: dict[int, int] = {}      # rid -> worker slot
        self._submitted: set[int] = set()
        self._order: list[int] = []
        self._next_id = 0
        self.round = 0                             # global lockstep round
        self._respawns = [0] * self.num_workers
        self.stats = {"routed_per_worker": [0] * self.num_workers,
                      "workers_failed": 0, "respawned": 0, "evacuated": 0,
                      "requeued": 0, "shed_deadline": 0}
        # host-side counters of the lockstep rounds: rounds run and their
        # host seconds, the step replies' frame bytes and RPC seconds
        # (request written to reply decoded), and each live worker's
        # active lanes at the start of the latest rounds
        self.telemetry = {"rounds": 0, "host_s": 0.0, "step_replies": 0,
                          "step_reply_bytes": 0, "step_reply_max_bytes": 0,
                          "step_rpc_s": 0.0, "step_rpc_max_s": 0.0,
                          "active_lanes": collections.deque(maxlen=1024)}
        self.workers: list[WorkerHandle] = [
            self._spawn(i) for i in range(self.num_workers)]

    # ---- process management ---------------------------------------------
    def _worker_ledger_path(self, idx: int) -> str:
        return os.path.join(self.ledger_dir, f"worker-{idx}.jsonl")

    def _spawn(self, idx: int, incarnation: int = 0) -> WorkerHandle:
        """Spawn + init + promotion-probe one worker slot.

        The handle comes back ``alive=False`` (and never enters routing)
        if any stage fails — spawning is itself fallible, and a slot that
        cannot pass the probe must not adopt anyone's lanes.
        """
        c2w_r, c2w_w = os.pipe()
        w2c_r, w2c_w = os.pipe()
        env = dict(os.environ)
        # the coordinator ships the plan explicitly over RPC; the env
        # spec must not double-arm an injector inside the worker
        env.pop(REPRO_FAULT_PLAN_ENV, None)
        src_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        # -c import (not -m): runpy would import the package (whose
        # __init__ already imported this module) and then re-execute the
        # module body as __main__ — the classic double-import warning
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from repro_torch.serve.cluster import _worker_main; "
             "sys.exit(_worker_main(sys.argv[1:]))",
             str(c2w_r), str(w2c_w)],
            pass_fds=(c2w_r, w2c_w), env=env, close_fds=True)
        os.close(c2w_r)
        os.close(w2c_w)
        h = WorkerHandle(proc=proc, rfd=w2c_r, wfd=c2w_w,
                         incarnation=incarnation,
                         versions={self._current_version},
                         load=self._cold_load(),
                         last_contact=time.monotonic())
        v = self._current_version
        try:
            self._rpc(h, {
                "op": "init", "worker_id": idx, "incarnation": incarnation,
                "snn_cfg": snn_cfg_to_wire(self.cfg),
                "params": params_to_wire(self._version_params[v]),
                "initial_weight_version": v,
                "lanes": self.lanes_per_worker,
                "chunk_steps": self.chunk_steps, "patience": self.patience,
                "seed": self.seed, "backend": self.backend,
                "device": self.device,
                "fault_cfg": fault_cfg_to_wire(self.fault_cfg),
                "plan": plan_to_wire(self.fault_plan),
                "ledger_path": self._worker_ledger_path(idx),
            }, _RPC_LONG_TIMEOUT_S)
            # the promotion probe across the process boundary: one chunk
            # dispatch must succeed before the slot serves traffic
            rep = self._rpc(h, {"op": "probe"}, _RPC_LONG_TIMEOUT_S)
            h.backend = rep.get("backend")
        except WorkerDied as e:
            h.error = str(e)
            self._kill_worker(h)
        return h

    def _cold_load(self) -> EngineLoad:
        return EngineLoad(
            lanes_total=self.lanes_per_worker, lanes_busy=0, queue_depth=0,
            mean_service_steps=float(self.cfg.num_steps), retired_total=0,
            density_ewma=None)

    def _kill_worker(self, h: WorkerHandle) -> None:
        h.alive = False
        try:
            h.proc.kill()
        except Exception:
            pass
        try:
            h.proc.wait(timeout=10)
        except Exception:
            pass
        for fd in (h.rfd, h.wfd):
            try:
                os.close(fd)
            except OSError:
                pass

    def _rpc(self, h: WorkerHandle, msg: dict,
             timeout_s: float | None) -> dict:
        """One request/reply exchange under the heartbeat deadline —
        applied to both directions: a stalled worker whose pipe buffer
        filled up blocks the request frame itself, and must trip the
        same hang detection as an overdue reply."""
        t0 = time.perf_counter()
        try:
            write_msg(h.wfd, msg, timeout_s)
            rep, nbytes = read_frame(h.rfd, timeout_s)
        except TimeoutError as e:
            raise WorkerDied("hang", str(e)) from None
        except (EOFError, OSError) as e:
            raise WorkerDied("crash", str(e)) from None
        if not rep.get("ok"):
            raise WorkerDied("error", str(rep.get("error", "")))
        if msg["op"] == "step":
            rpc_s, tel = time.perf_counter() - t0, self.telemetry
            tel["step_replies"] += 1
            tel["step_reply_bytes"] += nbytes
            tel["step_reply_max_bytes"] = max(tel["step_reply_max_bytes"],
                                              nbytes)
            tel["step_rpc_s"] += rpc_s
            tel["step_rpc_max_s"] = max(tel["step_rpc_max_s"], rpc_s)
        h.last_contact = time.monotonic()
        if "versions" in rep:
            h.versions = {int(v) for v in rep["versions"]}
        return rep

    # ---- routing / intake -----------------------------------------------
    def _alive(self) -> list[int]:
        return [i for i, h in enumerate(self.workers) if h.alive]

    def _route_index(self) -> int | None:
        """Least-loaded live worker; lowest index breaks ties (the same
        deterministic spray order as the in-process tier)."""
        idxs = self._alive()
        if not idxs:
            return None
        return min((load_score(self.workers[i].load), i) for i in idxs)[1]

    def submit(self, pixels_u8, *, deadline_steps: int | None = None,
               request_id: int | None = None) -> int:
        """Admit one request; the submit ledger line (pixels included)
        precedes routing — write-ahead, so a coordinator crash can never
        lose an admitted request."""
        px = np.asarray(pixels_u8, np.uint8).reshape(self.n_in)
        if request_id is None:
            rid = self._next_id
        else:
            rid = int(request_id)
            if rid in self._submitted:
                raise ValueError(f"request id {rid} already in use")
        self._next_id = max(self._next_id, rid + 1)
        # deadline_steps rides the write-ahead record: a coordinator
        # crash must not quietly upgrade an SLO-bounded request into an
        # unbounded one on recovery re-dispatch
        self._ledger.append({"kind": "submit", "rid": rid,
                             "px": array_to_wire(px),
                             "deadline_steps": deadline_steps})
        self._submitted.add(rid)
        self._order.append(rid)
        self._pixels[rid] = px
        self._dispatch(rid, px, deadline_steps=deadline_steps)
        return rid

    def _dispatch(self, rid: int, px: np.ndarray, *,
                  deadline_steps: int | None = None,
                  drop_reason: str = "no_capacity",
                  drop_worker: int | None = None,
                  drop_detail: str = "") -> None:
        """Route one request to the least-loaded live worker (retrying
        past workers that die under the submit RPC itself)."""
        while True:
            idx = self._route_index()
            if idx is None:
                self._drop(rid, drop_reason, drop_worker,
                           detail=drop_detail or "no live worker")
                return
            h = self.workers[idx]
            if deadline_steps is not None:
                eta = estimate_eta_steps(h.load)
                if eta > deadline_steps:
                    self._shed(rid, eta, deadline_steps)
                    return
            try:
                rep = self._rpc(h, {"op": "submit", "rid": rid,
                                    "px": array_to_wire(px)},
                                self.fault_cfg.heartbeat_deadline_s)
            except WorkerDied as e:
                self._on_worker_death(idx, e, self.round)
                continue
            h.pending = int(rep.get("pending", h.pending + 1))
            if "load" in rep:   # keep the routing surface live, not stale
                h.load = engine_load_from_wire(rep["load"])
            self._assignment[rid] = idx
            self.stats["routed_per_worker"][idx] += 1
            return

    # ---- accounting (every path writes the ledger first-class) ----------
    def _shed(self, rid: int, eta: float, deadline: int) -> None:
        rec = ShedRecord(request_id=rid, reason="deadline",
                         priority="standard", priority_level=0,
                         deadline_steps=deadline, eta_steps=eta)
        self.shed[rid] = rec
        self.stats["shed_deadline"] += 1
        self._ledger.append({"kind": "shed", "rid": rid,
                             **dataclasses.asdict(rec)})
        self._pixels.pop(rid, None)
        self._assignment.pop(rid, None)

    def _drop(self, rid: int, reason: str, worker: int | None,
              detail: str = "") -> None:
        """The never-silent fault drop (tier ``_drop``, process edition)."""
        rec = FaultRecord(request_id=rid, reason=reason, engine=worker,
                          faults=0, replay_seed=self.seed + rid,
                          detail=detail)
        self.faulted[rid] = rec
        self._ledger.append({"kind": "fault", "rid": rid,
                             **dataclasses.asdict(rec)})
        self._pixels.pop(rid, None)
        self._assignment.pop(rid, None)

    def _record_result(self, rid: int, wire_rec: dict) -> None:
        if rid in self.results:
            return
        self.results[rid] = result_from_wire(wire_rec)
        self._ledger.append({"kind": "result", "rid": rid,
                             **result_to_wire(self.results[rid])})
        self._pixels.pop(rid, None)
        self._assignment.pop(rid, None)

    def outstanding(self) -> list[int]:
        """Submitted ids with no terminal record yet (submit order)."""
        terminal = (self.results.keys() | self.shed.keys()
                    | self.faulted.keys())
        return [rid for rid in self._order if rid not in terminal]

    @property
    def pending(self) -> int:
        return sum(h.pending for h in self.workers if h.alive)

    # ---- drive ----------------------------------------------------------
    def step(self) -> list[int]:
        """One global lockstep round; returns rids finished this round.

        The round number is the fault plan's process-event coordinate —
        it never resets across worker respawns, so a ``[r, r]``-windowed
        kill fires in exactly one incarnation.
        """
        t0 = time.perf_counter()
        self.telemetry["active_lanes"].append(
            (self.round, [len(h.shadow) if h.alive else None
                          for h in self.workers]))
        try:
            return self._step()
        finally:
            self.telemetry["rounds"] += 1
            self.telemetry["host_s"] += time.perf_counter() - t0

    def _step(self) -> list[int]:
        r = self.round
        self.round += 1
        if (self.fault_plan is not None
                and not self._suppress_coordinator_kill
                and self.fault_plan.coordinator_kill(r)):
            self._crash(r)
        done: list[int] = []
        for idx in range(self.num_workers):
            h = self.workers[idx]
            if not h.alive:
                continue
            if h.pending <= 0:
                # idle heartbeat: a crash must not hide behind an empty
                # queue until traffic next lands there
                if (time.monotonic() - h.last_contact
                        >= self.fault_cfg.heartbeat_interval_s):
                    try:
                        rep = self._rpc(
                            h, {"op": "ping"},
                            self.fault_cfg.heartbeat_deadline_s)
                        h.load = engine_load_from_wire(rep["load"])
                    except WorkerDied as e:
                        self._on_worker_death(idx, e, r)
                continue
            try:
                rep = self._rpc(h, {"op": "step", "round": r},
                                self.fault_cfg.heartbeat_deadline_s)
            except WorkerDied as e:
                self._on_worker_death(idx, e, r)
                continue
            for w in rep["done"]:
                rid = int(w["request_id"])
                if rid not in self.results:
                    self._record_result(rid, w)
                    done.append(rid)
            h.shadow = {int(rid): row for rid, row in rep["checkpoint"]}
            h.load = engine_load_from_wire(rep["load"])
            h.pending = int(rep["pending"])
        return done

    def run(self, max_rounds: int | None = None) -> dict:
        """Drive lockstep rounds until every submitted id is terminal.

        Never silent: if the bounded loop ends with unaccounted ids the
        coordinator raises instead of returning a partial partition.
        """
        limit = max_rounds if max_rounds is not None else (
            (len(self.outstanding())
             + self.num_workers * self.lanes_per_worker)
            * (self.cfg.num_steps // max(1, self.chunk_steps) + 2)
            + 64 * self.num_workers + 16)
        for _ in range(limit):
            if not self.outstanding():
                break
            self.step()
        for idx in range(self.num_workers):
            h = self.workers[idx]
            if not h.alive:
                continue
            try:
                rep = self._rpc(h, {"op": "drain"},
                                max(30.0, self.fault_cfg.heartbeat_deadline_s))
            except WorkerDied as e:
                self._on_worker_death(idx, e, self.round)
                continue
            for w in rep["done"]:
                rid = int(w["request_id"])
                if rid not in self.results:
                    self._record_result(rid, w)
        left = self.outstanding()
        if left:
            raise RuntimeError(
                f"cluster run ended with unaccounted requests {left} — "
                f"the results ∪ shed ∪ faulted partition is incomplete")
        return dict(self.results)

    # ---- failover --------------------------------------------------------
    def _crash(self, rnd: int):
        """Injected coordinator death: every worker dies with it (the
        simulated host loss), the ledger handle closes mid-stream, and
        :class:`CoordinatorCrash` propagates to the harness — which
        recovers via :meth:`recover` against the same ``ledger_dir``."""
        for h in self.workers:
            if h.alive:
                self._kill_worker(h)
        self._ledger.close()
        raise CoordinatorCrash(
            f"coordinator killed at round {rnd} (injected fault plan)")

    def _on_worker_death(self, idx: int, died: WorkerDied,
                         rnd: int) -> None:
        """Worker failover: kill, respawn-and-readopt, evacuate, requeue.

        Respawn runs FIRST so the replacement slot is itself an adoption
        target for its predecessor's lanes.  ``state_lost`` kill events
        discard the shipped checkpoint (the injected analogue of a host
        dying with its state unrecoverable) — those windows become
        ``FaultRecord("state_lost")``, never silent drops.
        """
        h = self.workers[idx]
        detail = (f"worker {idx} (incarnation {h.incarnation}) "
                  f"{died.reason} at round {rnd}: {died.detail}")
        shadow = dict(h.shadow)
        h.shadow = {}
        self._kill_worker(h)
        self.stats["workers_failed"] += 1
        ev = (self.fault_plan.worker_kill(idx, rnd)
              if self.fault_plan is not None else None)
        state_lost = bool(ev is not None and ev.state_lost)
        if self._respawns[idx] < self.fault_cfg.max_respawns:
            self._respawns[idx] += 1
            nh = self._spawn(idx, incarnation=h.incarnation + 1)
            self.workers[idx] = nh
            if nh.alive:
                self.stats["respawned"] += 1
        # snapshot the queued set BEFORE evacuating: a shadow row adopted
        # onto the RESPAWNED same slot leaves _assignment[rid] == idx, and
        # re-submitting an adopted rid would (rightly) be rejected
        queued = sorted(rid for rid, w in self._assignment.items()
                        if w == idx and rid not in shadow)
        for rid in sorted(shadow):
            if (rid in self.results or rid in self.faulted
                    or rid in self.shed):
                continue
            if state_lost:
                self._drop(rid, "state_lost", idx, detail=detail)
            else:
                self._evacuate(rid, shadow[rid], idx, detail, rnd)
        for rid in queued:
            if (rid in self.results or rid in self.faulted
                    or rid in self.shed):
                self._assignment.pop(rid, None)
                continue
            # queued on the dead worker, never checkpointed: replay the
            # whole window from its write-ahead pixels — pure in
            # (seed, rid, pixels), so bit-identical to the lost attempt
            self._assignment.pop(rid, None)
            self._dispatch(rid, self._pixels[rid],
                           drop_reason="engine_lost", drop_worker=idx,
                           drop_detail=detail)
            if rid in self._assignment:
                self.stats["requeued"] += 1

    def _evacuate(self, rid: int, row: dict, dead_idx: int, detail: str,
                  rnd: int) -> None:
        """Adopt one shadow checkpoint onto a live worker, replaying its
        (possibly garbage-collected) weight version via ``ensure``."""
        while True:
            tgt = self._route_index()
            if tgt is None:
                self._drop(rid, "engine_lost", dead_idx, detail=detail)
                return
            th = self.workers[tgt]
            ver = int(array_from_wire(row["leaves"]["weight_version"]))
            try:
                if ver not in th.versions:
                    self._rpc(th, {
                        "op": "ensure_version", "version": ver,
                        "planes": planes_to_wire(self._version_planes[ver]),
                    }, self.fault_cfg.heartbeat_deadline_s)
                    th.versions.add(ver)
                rep = self._rpc(th, {"op": "adopt", "rid": rid, "row": row},
                                self.fault_cfg.heartbeat_deadline_s)
            except WorkerDied as e:
                self._on_worker_death(tgt, e, rnd)
                continue
            self._assignment[rid] = tgt
            th.pending = int(rep.get("pending", th.pending + 1))
            if "load" in rep:
                th.load = engine_load_from_wire(rep["load"])
            th.shadow[rid] = row   # the checkpoint now lives on tgt
            self.stats["evacuated"] += 1
            if self._crash_after_evacuations is not None:
                self._crash_after_evacuations -= 1
                if self._crash_after_evacuations <= 0:
                    self._crash(rnd)
            return

    # ---- weight rollout --------------------------------------------------
    def begin_rollout(self, params_q: dict, *, _replay: bool = False) -> int:
        """Broadcast new packed planes to every live worker, zero-drain
        (the tier's ``begin_rollout`` over RPC; respawned workers seed at
        the fleet's current version, older in-flight versions replay on
        demand during evacuation).

        The rollout is **ledgered** (``kind="rollout"``, params included
        — they are wire-serializable by construction) so a recovered
        coordinator replays the fleet up to the pre-crash weight version
        before re-running outstanding ids, instead of silently
        recomputing them against version-0 weights.  ``_replay`` marks
        that recovery path: it must not re-append the record, or every
        recovery would double the rollout history.
        """
        wire_params = params_to_wire(params_q)
        versions = set()
        for idx in range(self.num_workers):
            h = self.workers[idx]
            if not h.alive:
                continue
            try:
                rep = self._rpc(h, {"op": "begin_rollout",
                                    "params": wire_params},
                                _RPC_LONG_TIMEOUT_S)
            except WorkerDied as e:
                self._on_worker_death(idx, e, self.round)
                continue
            versions.add(int(rep["version"]))
            h.versions.add(int(rep["version"]))
        if not versions:
            raise RuntimeError(
                "begin_rollout: no live worker accepted the rollout — "
                "the fleet is dead; recover() or respawn before rolling "
                "weights")
        if len(versions) != 1:
            raise RuntimeError(
                f"begin_rollout: workers out of lockstep — the fleet "
                f"reported versions {sorted(versions)}; refusing to pick "
                f"one (a respawn raced the broadcast)")
        v = versions.pop()
        self._version_planes[v] = tuple(
            layer["w_q"] for layer in params_q["layers"])
        self._version_params[v] = params_q
        self._current_version = v
        if not _replay:
            self._ledger.append({"kind": "rollout", "version": v,
                                 "params": wire_params})
        return v

    # ---- recovery --------------------------------------------------------
    @classmethod
    def recover(cls, params_q: dict, cfg: SNNConfig, *, ledger_dir: str,
                **kw) -> "ClusterCoordinator":
        """Rebuild a coordinator from the ledgers after its own death.

        Folds every host's JSONL file back into the three accounting
        maps (``result`` beats ``shed``/``fault`` per id — a worker's
        replicated line proves the answer was computed), replays the
        ledgered weight rollouts so the fresh fleet sits at the
        pre-crash version, then re-runs the outstanding ids from their
        write-ahead pixels in submit order — each with its original
        ``deadline_steps``, so an SLO-bounded request stays bounded
        across the crash.  No new ``submit`` lines are written (they are
        already durable) and ``coordinator_kill`` is suppressed — the
        recovered instance must not replay its own death.
        """
        co = cls(params_q, cfg, ledger_dir=ledger_dir, _recovered=True,
                 **kw)
        paths = ([co._ledger.path]
                 + sorted(glob(os.path.join(ledger_dir, "worker-*.jsonl"))))
        acc = recover_accounting(paths)
        shed_f, fault_f = _record_fields(ShedRecord), _record_fields(
            FaultRecord)
        for rid, rec in acc["results"].items():
            co.results[int(rid)] = result_from_wire(rec)
        for rid, rec in acc["shed"].items():
            co.shed[int(rid)] = ShedRecord(
                **{k: v for k, v in rec.items() if k in shed_f})
        for rid, rec in acc["faulted"].items():
            co.faulted[int(rid)] = FaultRecord(
                **{k: v for k, v in rec.items() if k in fault_f})
        for rec in acc["rollouts"]:
            co.begin_rollout(params_from_wire(rec["params"]), _replay=True)
        submit_recs = dict(acc["submitted"])
        co._order = [int(rid) for rid, _ in acc["submitted"]]
        co._submitted = set(co._order)
        co._next_id = max(co._order, default=-1) + 1
        for rid in acc["outstanding"]:
            rec = submit_recs[rid]
            px = array_from_wire(rec["px"])
            co._pixels[int(rid)] = px
            ds = rec.get("deadline_steps")
            co._dispatch(int(rid), px,
                         deadline_steps=None if ds is None else int(ds))
        return co

    # ---- lifecycle -------------------------------------------------------
    def close(self) -> None:
        for h in self.workers:
            if h.alive:
                try:
                    write_msg(h.wfd, {"op": "shutdown"}, 10.0)
                    read_msg(h.rfd, 10.0)
                except Exception:
                    pass
                self._kill_worker(h)
        try:
            self._ledger.close()
        except Exception:
            pass

    def __enter__(self) -> "ClusterCoordinator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---- worker process main --------------------------------------------------

def _worker_main(argv: list[str]) -> int:
    """One engine process: blocking RPC loop over inherited pipe fds.

    Liveness is the coordinator's problem (every read here blocks
    forever); injected process faults execute *here* — ``worker_kill``
    dies mid-protocol with no reply, ``worker_hang`` sleeps through the
    heartbeat deadline — so the coordinator's detection path is the real
    one, not a simulation.
    """
    rfd, wfd = int(argv[0]), int(argv[1])
    engine = None
    plan = None
    worker_id = 0
    wledger: Ledger | None = None
    shipped: set[int] = set()

    def ship_new_results() -> list[dict]:
        """Wire + ledger-replicate results not yet shipped upstream (the
        ledger line lands BEFORE the reply frame — a result computed but
        never acknowledged still survives a coordinator crash)."""
        out = []
        for rid in sorted(set(engine.results) - shipped):
            w = result_to_wire(engine.results[rid])
            if wledger is not None:
                wledger.append({"kind": "result", "rid": int(rid), **w})
            shipped.add(rid)
            out.append(w)
        return out

    while True:
        try:
            msg = read_msg(rfd)
        except (EOFError, OSError):
            return 0
        op = msg.get("op")
        try:
            if op == "init":
                cfg = snn_cfg_from_wire(msg["snn_cfg"])
                params_q = params_from_wire(msg["params"])
                worker_id = int(msg["worker_id"])
                plan = plan_from_wire(msg.get("plan"))
                injector = (FaultInjector(plan, worker_id)
                            if plan is not None
                            and plan.engine_relevant(worker_id) else None)
                engine = SNNStreamEngine(
                    params_q, cfg, batch_size=int(msg["lanes"]),
                    chunk_steps=int(msg["chunk_steps"]),
                    patience=int(msg["patience"]), seed=int(msg["seed"]),
                    backend=msg.get("backend"), device=msg.get("device"),
                    engine_id=worker_id,
                    injector=injector,
                    fault_cfg=fault_cfg_from_wire(msg.get("fault_cfg")),
                    initial_weight_version=int(
                        msg.get("initial_weight_version", 0)))
                if msg.get("ledger_path"):
                    wledger = Ledger(msg["ledger_path"])
                write_msg(wfd, {"ok": True, "backend": engine.backend})
            elif op == "submit":
                engine.submit(array_from_wire(msg["px"]),
                              request_id=int(msg["rid"]))
                write_msg(wfd, {
                    "ok": True, "pending": engine.pending,
                    "load": engine_load_to_wire(engine.load_summary())})
            elif op == "adopt":
                engine.adopt(int(msg["rid"]), lane_from_wire(msg["row"]))
                write_msg(wfd, {
                    "ok": True, "pending": engine.pending,
                    "load": engine_load_to_wire(engine.load_summary())})
            elif op == "ensure_version":
                v = int(msg["version"])
                engine.bank.ensure(
                    v, engine._place_weights(planes_from_wire(msg["planes"])))
                write_msg(wfd, {"ok": True,
                                "versions": sorted(engine.bank.versions)})
            elif op == "begin_rollout":
                v = engine.begin_rollout(params_from_wire(msg["params"]))
                write_msg(wfd, {"ok": True, "version": int(v),
                                "versions": sorted(engine.bank.versions)})
            elif op == "probe":
                # one chunk dispatch on the (possibly empty) tile — the
                # promotion probe, and the kernel-loading warm-up that
                # keeps later step RPCs inside the heartbeat deadline
                engine._dispatch_chunk(engine.lanes)
                write_msg(wfd, {"ok": True,
                                "backend": engine.backend_effective})
            elif op == "step":
                rnd = int(msg["round"])
                if plan is not None:
                    if plan.worker_kill(worker_id, rnd) is not None:
                        os._exit(13)   # injected crash: no reply, no cleanup
                    if plan.worker_hang(worker_id, rnd):
                        time.sleep(3600.0)   # heartbeat deadline kills us
                engine.step()
                # second compaction: harvest lanes the chunk just retired
                # so their results ship THIS reply, and the checkpoint
                # below covers only still-active lanes
                engine._admit_and_compact()
                write_msg(wfd, {
                    "ok": True, "done": ship_new_results(),
                    "checkpoint": [[int(rid), lane_to_wire(row)]
                                   for rid, row in engine.checkpoint_lanes()],
                    "load": engine_load_to_wire(engine.load_summary()),
                    "pending": engine.pending,
                    "versions": sorted(engine.bank.versions)})
            elif op == "ping":
                write_msg(wfd, {
                    "ok": True,
                    "load": engine_load_to_wire(engine.load_summary()),
                    "pending": engine.pending,
                    "versions": sorted(engine.bank.versions)})
            elif op == "drain":
                engine.run(max_chunks=0)   # final harvest
                write_msg(wfd, {"ok": True, "done": ship_new_results(),
                                "pending": engine.pending})
            elif op == "shutdown":
                write_msg(wfd, {"ok": True})
                if wledger is not None:
                    wledger.close()
                return 0
            else:
                write_msg(wfd, {"ok": False,
                                "error": f"unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 — every fault goes upstream
            try:
                write_msg(wfd, {"ok": False,
                                "error": f"{type(e).__name__}: {e}"})
            except OSError:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
