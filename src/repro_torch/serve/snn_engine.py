"""Batched streaming SNN serving engine (port of ``repro.serve.snn_engine``).

Many requests share one batch tile of lanes and stream through the integer
datapath together, with two scheduling ideas:

  * **Early exit** — a lane whose running prediction has been stable for
    ``patience`` consecutive steps retires before the window ends.  The
    gate runs inside the window chunk, so a lane stops executing adds the
    step it retires.
  * **Lane compaction** — at chunk boundaries retired lanes are harvested,
    live lanes are compacted to the front of the tile (stable order) and
    the freed slots admit queued images (continuous batching).

On a CUDA device the chunk is ONE launch of an encode→LIF stack kernel
(``kernels.ops.fused_snn_stack_op`` with the gate state), which advances
every lane ``chunk_steps`` steps through every layer and runs the
stability gate per step: the resident kernel (``fused``) or, for a stack
whose per-lane state it cannot hold, the weight-streaming kernel
(``fused_streamed``).  The ``reference`` backend runs the same datapath as
per-step torch ops over ``core.snn.snn_int_stack_step_sharded`` (one shard
without a model axis).  All give the
same lane-state evolution for the same seeds.  The staged kernels cannot
resume mid-window, so the engine never runs them.

Each fresh request's PRNG lanes are seeded from ``seed + request_id``, so
a request's window is a pure function of its id: results do not depend on
the slot, the chunk split or the engine that served it.

:class:`ShardedSNNStreamEngine` spreads the lane tile over the data axis of
a device mesh and, on a model axis, each layer's output columns over the
model peers, with one partial-contraction launch per (step, layer, shard)
and a spike exchange between layers: from one process, or over a
``torch.distributed`` group as one process per rank.

Both engines carry the reference package's fault harness
(``serve.faults``): with an injector armed, every chunk dispatch consults
it, transient faults retry and back off, persistent ones step the engine
down its degradation ladder (``fused`` → ``fused_streamed`` →
``reference``, infeasible rungs skipped at construction) and back up
after clean chunks, a hang trips the chunk watchdog, and an engine that
fails raises :class:`~.faults.EngineFailure` for the serving tier to
evacuate.  The ``reference`` rung runs plain PyTorch, and only an
injected fault leads there: an error a kernel raises is never taken for
a fault.  With no injector the dispatch is the plain chunk, launch for
launch.

Both engines consult the tuned dispatch cache (``repro_torch.tune``) once
at construction: a hit fills the lane count, the chunk length and the
controller's threshold that the caller left unset, and an ``auto``
backend adopts the tuned run's backend where this device's gate admits
it.  A miss serves the static defaults (8 lanes, 4-step chunks).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import lif as lif_mod
from ..core import prng as prng_mod
from ..core.snn import (ModelGroup, SNNConfig, fused_unsupported_reason,
                        readout_pred, resolve_backend,
                        snn_int_stack_step_sharded)
from ..core.telemetry import (ChunkTelemetry, EngineLoad,
                              concat_shard_telemetry)
from ..device import resolve_device
from ..distributed.sharding import (DeviceMesh, gather_rows,
                                   make_2d_device_mesh, mesh_rank,
                                   refuse_process_mesh)
from ..kernels import ops
from ..kernels.fused_snn import LANE, check_block_b, layer_shard_ways, \
    pack_weights
from ..kernels.ops import V_PEAK_INIT
from .early_exit import StabilityGateState, stability_step
from .faults import (DeviceLostFault, DispatchFault, EngineFailure,
                     EngineHealthState, FaultInjector, FaultToleranceConfig,
                     PoisonDispatchError, injector_from_env, telemetry_ok)
from .rollout import WeightBank, merge_version_chunks, select_lanes
from .telemetry import AdaptiveDispatchConfig, TelemetryController, \
    make_controller, summarize_chunk

__all__ = ["SNNStreamEngine", "ShardedSNNStreamEngine", "LaneState",
           "RequestResult", "stream_chunk", "split_lanes", "shard_weights",
           "sharded_stream_chunk"]


class LaneState(NamedTuple):
    """State of one batch tile (every leaf has leading dim B)."""

    px: torch.Tensor          # (B, n_in) uint8 pixels
    rng: torch.Tensor         # (B, n_in) uint32 xorshift lanes
    v: tuple                  # per-layer (B, n_l) int32 membranes
    en: tuple                 # per-layer (B, n_l) bool clock gates
    v_peak: tuple             # per-layer (B, n_l) int32 running peaks
    counts: torch.Tensor      # (B, n_out) int32 spike registers
    first: torch.Tensor       # (B, n_out) int32 first-spike latch (T = none)
    gate_prev: torch.Tensor   # (B,) int32 stability-gate memory
    gate_streak: torch.Tensor  # (B,) int32
    steps: torch.Tensor       # (B,) int32 window steps executed
    adds: torch.Tensor        # (B,) int32 executed synaptic adds (energy)
    active: torch.Tensor      # (B,) bool lane still consuming compute
    weight_version: torch.Tensor  # (B,) int32 admission-time bank version


@dataclass
class RequestResult:
    request_id: int
    pred: int
    spike_counts: np.ndarray
    steps: int             # window steps actually consumed
    adds: int              # synaptic adds executed (energy side channel)
    early_exit: bool       # retired by the stability gate before T
    weight_version: int = 0  # weight version the window ran on


def _init_lanes(batch: int, layer_sizes: tuple[int, ...], num_steps: int,
                v_rest: int, device: torch.device) -> LaneState:
    n_in, n_out = layer_sizes[0], layer_sizes[-1]

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return LaneState(
        px=full((batch, n_in), 0, torch.uint8),
        rng=full((batch, n_in), 1).view(torch.uint32),
        v=tuple(full((batch, n), v_rest) for n in layer_sizes[1:]),
        en=tuple(full((batch, n), True, torch.bool)
                 for n in layer_sizes[1:]),
        v_peak=tuple(full((batch, n), V_PEAK_INIT)
                     for n in layer_sizes[1:]),
        counts=full((batch, n_out), 0),
        first=full((batch, n_out), num_steps),
        gate_prev=full((batch,), -1),
        gate_streak=full((batch,), 0),
        steps=full((batch,), 0),
        adds=full((batch,), 0),
        active=full((batch,), False, torch.bool),
        weight_version=full((batch,), 0),
    )


def stream_chunk(lanes: LaneState, weights: tuple, *, chunk_steps: int,
                 num_steps: int, lif_cfg: lif_mod.LIFConfig, dot_impl: str,
                 active_pruning: bool, patience: int, readout: str = "count",
                 backend: str = "reference",
                 sparse_skip: bool | None = None,
                 model_shards: int | None = None,
                 model_group: ModelGroup | None = None):
    """Advance every active lane by up to ``chunk_steps`` window steps.

    ``backend="fused"`` runs the whole chunk (every layer, every step, the
    stability gate) as one launch of the resident stack kernel,
    ``"fused_streamed"`` as one launch of the weight-streaming kernel
    (``weights`` int16 codes or, as the engines place them, int8 planes);
    ``"reference"`` steps the same datapath with torch ops.  A retired or
    inactive lane is frozen: PRNG, membranes, counters and its add counter
    stop.  Returns ``(lanes', ChunkTelemetry)``.

    ``model_shards`` switches to the model-axis datapath
    (``core.snn.snn_int_stack_step_sharded``): ``weights`` are then
    per-layer tuples of per-peer shards (:func:`shard_weights`).  A stack
    kernel cannot host the spike exchange between layers, so a ``fused``
    or ``fused_streamed`` backend becomes one partial-contraction launch
    per (step, layer, shard), and ``reference`` the plain contraction; the
    gate and freeze below run on the full gathered arrays either way.
    With ``model_group`` (a model axis over processes) ``weights`` are
    this rank's own tensors, one a layer, and the exchange is a
    collective.
    """
    if backend not in ("fused", "fused_streamed", "reference"):
        raise ValueError(f"unknown chunk backend {backend!r}")
    if backend != "reference" and model_shards is None:
        k = ops.fused_snn_stack_op(
            lanes.px, lanes.rng, weights, num_steps=num_steps,
            chunk_steps=chunk_steps, decay_shift=lif_cfg.decay_shift,
            v_threshold=lif_cfg.v_threshold, v_rest=lif_cfg.v_rest,
            v_min=lif_cfg.v_min, v_max=lif_cfg.v_max,
            active_pruning=active_pruning,
            init={"v": lanes.v, "en": lanes.en, "v_peak": lanes.v_peak,
                  "counts": lanes.counts, "first": lanes.first,
                  "steps": lanes.steps},
            gate={"active": lanes.active, "prev": lanes.gate_prev,
                  "streak": lanes.gate_streak},
            patience=patience, readout=readout, sparse_skip=sparse_skip,
            streamed=backend == "fused_streamed",
            layer_sizes=(lanes.px.shape[1],) + tuple(v.shape[1]
                                                     for v in lanes.v))
        return LaneState(
            px=lanes.px, rng=k["prng_state"], v=k["v"], en=k["en"],
            v_peak=k["v_peak"], counts=k["spike_counts"],
            first=k["first_spike_t"], gate_prev=k["gate"]["prev"],
            gate_streak=k["gate"]["streak"], steps=k["steps"],
            adds=lanes.adds + k["active_adds"].sum(0, dtype=torch.int32),
            active=k["gate"]["active"],
            weight_version=lanes.weight_version), k["telemetry"]
    contraction = "plain" if backend == "reference" else "kernel"
    if model_shards is None:
        weights, model_shards = tuple((w,) for w in weights), 1
    st = lanes
    tspk, ten, ttile = [], [], []
    for _ in range(chunk_steps):
        act = st.active
        layer_states = tuple(lif_mod.LIFStateInt(v=v, enable=e)
                             for v, e in zip(st.v, st.en))
        rng, new_states, fired, adds_t, tel = snn_int_stack_step_sharded(
            st.rng, st.px, layer_states, weights, lif_cfg,
            model_shards=model_shards, dot_impl=dot_impl,
            active_pruning=active_pruning, sparse_skip=sparse_skip,
            contraction=contraction, model_group=model_group)
        counts = st.counts + fired.to(torch.int32)
        first = torch.where(fired & (st.first == num_steps),
                            st.steps[:, None], st.first)
        v_peak = tuple(torch.maximum(p, s.v)
                       for p, s in zip(st.v_peak, new_states))
        # a lane with no output spike yet has no prediction to be stable
        # about: its gate stays at init until the first spike
        has_spike = counts.amax(dim=-1) > 0
        pred = readout_pred(counts, first, new_states[-1].v, readout,
                            num_steps, v_peak=v_peak[-1]).to(torch.int32)
        gate, done = stability_step(
            StabilityGateState(prev=st.gate_prev, streak=st.gate_streak),
            pred, patience)
        gate_prev = torch.where(has_spike, gate.prev, -1)
        gate_streak = torch.where(has_spike, gate.streak, 0)
        done = done & has_spike
        steps = st.steps + act.to(torch.int32)
        still = act & ~done & (steps < num_steps)

        def keep(new, old):
            return select_lanes(act, new, old)

        # frozen lanes execute nothing, so their telemetry rows are zero;
        # the tile row stays raw (the block's executed geometry)
        tspk.append(torch.where(act[None, :], tel["n_spk"], 0))
        ten.append(torch.where(act[None, :], tel["n_en"], 0))
        ttile.append(tel["tiles"])
        st = LaneState(
            px=st.px, rng=keep(rng, st.rng),
            v=keep(tuple(s.v for s in new_states), st.v),
            en=keep(tuple(s.enable for s in new_states), st.en),
            v_peak=keep(v_peak, st.v_peak),
            counts=keep(counts, st.counts), first=keep(first, st.first),
            gate_prev=keep(gate_prev, st.gate_prev),
            gate_streak=keep(gate_streak, st.gate_streak),
            steps=steps, adds=st.adds + torch.where(act, adds_t, 0),
            active=torch.where(act, still, st.active),
            weight_version=st.weight_version)
    return st, ChunkTelemetry(n_spk=torch.stack(tspk), n_en=torch.stack(ten),
                              tiles_skipped=torch.stack(ttile))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor → writable numpy copy (uint32 through its int32 view)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32).copy()
    return t.cpu().numpy().copy()


def _cuda_leaves(x):
    """The CUDA tensors of a nested tuple / list / dict / lane state."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _cuda_leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _cuda_leaves(v)


def _map(fn, st: LaneState) -> LaneState:
    """Apply ``fn`` to every array leaf of a lane state."""
    return LaneState(*[tuple(fn(a) for a in f) if isinstance(f, tuple)
                       else fn(f) for f in st])


def _leaves(st: LaneState) -> list:
    """The array leaves of a lane state, in field order."""
    return [a for f in st for a in (f if isinstance(f, tuple) else (f,))]


def _unleaves(like: LaneState, leaves) -> LaneState:
    """Inverse of :func:`_leaves`: ``leaves`` in ``like``'s structure."""
    it = iter(leaves)
    return LaneState(*[tuple(next(it) for _ in f) if isinstance(f, tuple)
                       else next(it) for f in like])


class SNNStreamEngine:
    """Continuous-batching front end over the streaming window chunk.

    Usage::

        eng = SNNStreamEngine(params_q, cfg, batch_size=1024)
        ids = [eng.submit(img) for img in images]     # queue requests
        results = eng.run()                            # {id: RequestResult}

    ``params_q`` is ``{"layers": [{"w_q": (n_in, n_out) int16 codes, ...}]}``
    (numpy arrays or tensors; see ``repro_torch.convert.params_from_jax``).
    ``device`` None is the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain PyTorch paths.  ``backend`` None/"auto"
    resolves on a card through the resumable chain ``fused`` →
    ``fused_streamed`` (the resident stack kernel, else the
    weight-streaming one), raising when neither holds the stack, and to
    ``reference`` on the CPU; ``"fused"`` or ``"fused_streamed"`` on the
    CPU runs the kernels' plain version.  ``adaptive`` configures the
    telemetry controller (None = the REPRO_ADAPTIVE_DISPATCH default,
    frozen): it only moves value-neutral knobs, so results are the same
    either way.

    ``dispatch_cache`` (a ``repro_torch.tune.DispatchCache``, a path,
    None for the ``REPRO_DISPATCH_CACHE`` env, or False for none) is
    consulted once, keyed by this device's kind and the mesh ``(1,)``;
    the outcome is ``cache_decision``.  A hit fills ``batch_size``,
    ``chunk_steps`` and the controller's threshold where the caller left
    them None (explicit arguments win knob by knob), and an ``auto``
    backend adopts the tuned run's backend when the cached shapes are the
    ones running and ``core.snn.resolve_backend``'s cache gate admits it
    (a resumable backend; a stack kernel only on a card whose shared
    memory holds the lanes).  ``block_b`` is the
    kernels' fixed batch block: None or ``kernels.fused_snn.BLOCK_B``;
    any other value raises.

    ``injector`` arms the fault harness (``serve.faults``; None arms it
    from ``REPRO_FAULT_PLAN`` when that is set) under the ``fault_cfg``
    recovery policy.  The engine's degradation ladder ``_ladder`` holds
    the rungs from the configured backend down that its shared-memory
    model admits, ``reference`` last; ``backend_effective`` names the
    rung chunks run on, and the bank places every weight version once in
    the form of every rung.  ``local_batch`` and ``model_shards`` scope
    the feasibility checks to one device's lanes and weight shard (the
    sharded engine passes them).
    """

    _SERVICE_EWMA_ALPHA = 0.25

    def __init__(self, params_q: dict, cfg: SNNConfig, *,
                 batch_size: int | None = None,
                 chunk_steps: int | None = None,
                 patience: int = 2, seed: int = 0,
                 backend: str | None = None,
                 local_batch: int | None = None,
                 model_shards: int = 1,
                 adaptive: AdaptiveDispatchConfig | None = None,
                 engine_id: int = 0,
                 injector: FaultInjector | None = None,
                 fault_cfg: FaultToleranceConfig | None = None,
                 initial_weight_version: int = 0,
                 device: str | torch.device | None = None,
                 block_b: int | None = None,
                 dispatch_cache=None):
        from ..tune.cache import CacheDecision, decide_dispatch
        if cfg.readout not in ("count", "first_spike", "membrane"):
            raise ValueError(
                f"unknown readout {cfg.readout!r}: the streaming engine "
                f"implements 'count', 'first_spike' and 'membrane'")
        check_block_b(block_b)
        self.device = resolve_device(device)
        # the dispatch cache, resolved once (the sharded engine passes the
        # decision it made for its mesh); explicit arguments beat tuned
        # values knob by knob, and a miss serves the static defaults
        if isinstance(dispatch_cache, CacheDecision):
            self.cache_decision = dispatch_cache
        else:
            self.cache_decision = decide_dispatch(
                dispatch_cache, cfg=cfg, backend=backend, mesh_shape=(1,),
                device=self.device)
        tuned = (self.cache_decision.tuned if self.cache_decision.hit
                 else None)
        if tuned is not None:
            batch_size = (tuned.lanes_per_device if batch_size is None
                          else batch_size)
            chunk_steps = (tuned.chunk_steps if chunk_steps is None
                           else chunk_steps)
        batch_size = 8 if batch_size is None else batch_size
        chunk_steps = 4 if chunk_steps is None else chunk_steps
        codes = tuple(layer["w_q"] for layer in params_q["layers"])
        self.layer_sizes = tuple([int(codes[0].shape[0])]
                                 + [int(w.shape[1]) for w in codes])
        self.local_batch = batch_size if local_batch is None else local_batch
        self.model_shards = int(model_shards)
        requested = "auto" if backend is None else backend
        self.backend = self._resolve_backend(cfg, requested,
                                             shapes=(chunk_steps,
                                                     self.local_batch))
        if self.backend in ("fused", "fused_streamed"):
            ops.validate_weight_codes(codes)
        # the resumable slice of the backend chain below the configured
        # backend, rungs the feasibility model refuses skipped, so that a
        # demotion never lands on a rung that cannot run;
        # health.demotion_level indexes this tuple
        rungs = ("fused", "fused_streamed", "reference")
        self._ladder = tuple(
            b for b in rungs[rungs.index(self.backend):]
            if b in (self.backend, "reference")
            or self._unsupported(cfg, b == "fused_streamed") is None)
        self.engine_id = int(engine_id)
        self.injector = (injector if injector is not None
                         else injector_from_env(engine_id))
        self.fault_cfg = fault_cfg or FaultToleranceConfig()
        self.health = EngineHealthState()
        self._cooldown = 0           # scheduling rounds left to sit out
        self.bank = WeightBank(self._place_weights(codes),
                               version=int(initial_weight_version))
        self.cfg = cfg
        self.batch_size = batch_size
        self.patience = patience
        self.seed = seed
        if tuned is not None:
            # the tuned threshold, and the chunk length unless the caller
            # set it (``chunk_steps`` is the effective value either way)
            self.controller = TelemetryController.from_cache(
                dataclasses.replace(tuned, chunk_steps=chunk_steps),
                cfg_adaptive=adaptive, num_steps=cfg.num_steps)
        else:
            self.controller = make_controller(
                adaptive, spike_density_threshold=cfg.spike_density_threshold,
                chunk_steps=chunk_steps, num_steps=cfg.num_steps)
        self.n_in, self.n_out = self.layer_sizes[0], self.layer_sizes[-1]
        self.lanes = _init_lanes(batch_size, self.layer_sizes, cfg.num_steps,
                                 cfg.lif.v_rest, self.device)
        self.lane_req: list[int | None] = [None] * batch_size
        self.queue: list[tuple[int, np.ndarray]] = []
        self._adoptions: list[tuple[int, LaneState]] = []
        self.results: dict[int, RequestResult] = {}
        self._next_id = 0
        # host mirror of LaneState.weight_version (only admission writes it)
        self._lane_versions = np.zeros(batch_size, np.int64)
        self._service_ewma: float | None = None
        self._retired_total = 0
        self.dispatches = 0       # chunk executions (kernel launches on a
                                  # fused backend)
        self._active_host = None  # pinned (B,) active mask (CUDA readback)

    def _unsupported(self, cfg: SNNConfig, streamed: bool) -> str | None:
        """Why a stack kernel cannot hold one device's lanes and weight
        shard (None = it can)."""
        return fused_unsupported_reason(
            cfg, len(self.layer_sizes) - 1, self.layer_sizes,
            self.local_batch, streamed=streamed,
            model_shards=self.model_shards)

    def _resolve_backend(self, cfg: SNNConfig, requested: str, *,
                         shapes: tuple[int, int]) -> str:
        """The chunk backend: the resumable stack kernels only, since a
        chunk resumes mid-window; an ``auto`` request adopts the tuned
        run's backend when ``shapes`` (chunk steps, lanes) are the tuned
        ones."""
        b = resolve_backend(cfg, requested, len(self.layer_sizes) - 1,
                            layer_sizes=self.layer_sizes,
                            local_batch=self.local_batch,
                            model_shards=self.model_shards,
                            device=self.device,
                            dispatch_cache=self.cache_decision,
                            shapes=shapes, resumable=True)
        if b != "staged":
            return b
        if requested == "staged":
            raise ValueError(
                "streaming chunk backend must be 'fused', 'fused_streamed' "
                "or 'reference' (the staged kernels cannot resume "
                "mid-window); got 'staged'")
        raise ValueError(
            f"no resumable stack kernel holds this stack: "
            f"{self._unsupported(cfg, True)} — the staged kernels cannot "
            f"resume mid-window; pass backend='reference' to serve it in "
            f"plain PyTorch")

    @property
    def weights(self) -> tuple:
        """Weights of the CURRENT bank version (new admissions bind these)
        in the form the effective rung reads: int16 codes, or int8 planes
        on ``fused_streamed``."""
        return self._version_weights(self.bank.current)

    def _version_weights(self, version: int) -> tuple:
        return self.bank.weights(version)[
            self._weight_form(self.backend_effective)]

    def _weight_form(self, rung: str) -> str:
        """The placed form a ladder rung reads."""
        return "planes" if rung == "fused_streamed" else "codes"

    def _place_form(self, codes: tuple, form: str) -> tuple:
        """One weight version on the device in one form: int16 codes, or
        the LANE-padded int8 planes the weight-streaming kernel reads
        (``kernels.fused_snn.pack_weights``), packed here once so that no
        chunk pads or packs them."""
        if form == "planes":
            return tuple(pack_weights(_lane_pad(torch.as_tensor(w).to(
                torch.int16))).to(self.device) for w in codes)
        return tuple(torch.as_tensor(w).to(self.device, torch.int16)
                     .contiguous() for w in codes)

    def _place_weights(self, codes: tuple) -> dict:
        """The bank's entry for one weight version: its placed form for
        every rung of the ladder, keyed by form."""
        return {form: self._place_form(codes, form) for form in
                dict.fromkeys(self._weight_form(b) for b in self._ladder)}

    @property
    def chunk_steps(self) -> int:
        """Window steps of the NEXT chunk (the controller's live choice)."""
        return self.controller.chunk_steps

    @property
    def dispatch_threshold(self) -> float:
        return self.controller.dispatch_threshold

    # ---- request intake -------------------------------------------------
    def _id_in_use(self, rid: int) -> bool:
        return (rid in self.results or rid in self.lane_req
                or any(q[0] == rid for q in self.queue)
                or any(a[0] == rid for a in self._adoptions))

    def submit(self, pixels_u8: np.ndarray, *,
               request_id: int | None = None) -> int:
        """Enqueue one image; returns its request id (the PRNG seeds from
        ``seed + request_id``)."""
        pixels_u8 = np.asarray(pixels_u8, np.uint8).reshape(self.n_in)
        if request_id is None:
            rid = self._next_id
        else:
            rid = int(request_id)
            if self._id_in_use(rid):
                raise ValueError(f"request id {rid} already in use")
        self._next_id = max(self._next_id, rid + 1)
        self.queue.append((rid, pixels_u8))
        return rid

    def load_summary(self) -> EngineLoad:
        """Routing-tier load signals: host bookkeeping only, no device sync.

        Includes the health surface: consecutive faults, the ladder rung,
        the hang watchdog's margin (``None`` when no injector is armed, so
        the watchdog never runs) and liveness."""
        return EngineLoad(
            lanes_total=self.batch_size,
            lanes_busy=sum(r is not None for r in self.lane_req),
            queue_depth=len(self.queue) + len(self._adoptions),
            mean_service_steps=(float(self.cfg.num_steps)
                                if self._service_ewma is None
                                else self._service_ewma),
            retired_total=self._retired_total,
            density_ewma=self.controller.density_ewma,
            consecutive_faults=self.health.consecutive_faults,
            demotion_level=self.health.demotion_level,
            watchdog_margin=(None if self.injector is None
                             else self.fault_cfg.watchdog_chunks
                             - self.health.stalled_chunks),
            alive=self.health.alive)

    @property
    def pending(self) -> int:
        return (len(self.queue) + len(self._adoptions)
                + sum(r is not None for r in self.lane_req))

    # ---- scheduling -----------------------------------------------------
    def _host_pred(self, counts, first, v_last, v_peak) -> int:
        """Harvest-time prediction for one retired lane."""
        return int(readout_pred(
            torch.from_numpy(counts), torch.from_numpy(first),
            torch.from_numpy(v_last), self.cfg.readout, self.cfg.num_steps,
            v_peak=torch.from_numpy(v_peak)))

    def _harvest(self, st: LaneState, finished: np.ndarray) -> list[int]:
        """Collect RequestResults for every lane in the ``finished`` mask."""
        done_ids = []
        for i in np.nonzero(finished)[0]:
            rid = self.lane_req[int(i)]
            steps = int(st.steps[i])
            self.results[rid] = RequestResult(
                request_id=rid,
                pred=self._host_pred(st.counts[i], st.first[i],
                                     st.v[-1][i], st.v_peak[-1][i]),
                spike_counts=st.counts[i].copy(), steps=steps,
                adds=int(st.adds[i]),
                early_exit=steps < self.cfg.num_steps,
                weight_version=int(st.weight_version[i]))
            done_ids.append(rid)
            self._retired_total += 1
            a = self._SERVICE_EWMA_ALPHA
            self._service_ewma = (float(steps) if self._service_ewma is None
                                  else (1 - a) * self._service_ewma
                                  + a * steps)
        return done_ids

    def _admit_into(self, st: LaneState, slot: int) -> None:
        """Fill host lane ``slot`` with the next waiting request: an adopted
        row (written back verbatim) before a fresh request."""
        if self._adoptions:
            rid, row = self._adoptions.pop(0)
            for dst, src in zip(st, row):
                if isinstance(dst, tuple):
                    for d, s in zip(dst, src):
                        d[slot] = s
                else:
                    dst[slot] = src
            self.lane_req[slot] = rid
            return
        rid, pixels = self.queue.pop(0)
        st.px[slot] = pixels
        st.rng[slot] = prng_mod.seed_state(self.seed + rid, (self.n_in,),
                                           device="cpu").numpy()
        for v in st.v:
            v[slot] = self.cfg.lif.v_rest
        for en in st.en:
            en[slot] = True
        for vp in st.v_peak:
            vp[slot] = V_PEAK_INIT
        st.counts[slot] = 0
        st.first[slot] = self.cfg.num_steps
        st.gate_prev[slot] = -1
        st.gate_streak[slot] = 0
        st.steps[slot] = 0
        st.adds[slot] = 0
        st.active[slot] = True
        st.weight_version[slot] = self.bank.current
        self.lane_req[slot] = rid

    def _host_tile(self) -> LaneState:
        return _map(_to_host, self.lanes)

    def _upload(self, st: LaneState) -> LaneState:
        return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                    .to(self.device), st)

    def _read_active(self) -> np.ndarray:
        """The tile's (B,) active mask on the host.  On CUDA it is copied
        into pinned memory behind the work already queued on the main
        stream and waited for by an event, so work queued on another
        stream (a speculative chunk) is not waited for."""
        active = self.lanes.active
        if active.device.type != "cuda":
            return active.cpu().numpy()
        if self._active_host is None or \
                self._active_host.shape != active.shape:
            self._active_host = torch.empty(active.shape, dtype=active.dtype,
                                            pin_memory=True)
        self._active_host.copy_(active, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(active.device))
        ev.synchronize()
        return self._active_host.numpy().copy()

    def _needs_compaction(self) -> bool:
        """Only the (B,) active mask crosses to the host; the full tile
        round trip happens only when a lane retired or work can be
        admitted."""
        occupied = np.array([r is not None for r in self.lane_req])
        active = self._read_active()
        waiting = bool(self.queue or self._adoptions)
        return bool((occupied & ~active).any() or (
            waiting and not (occupied & active).all()))

    def _admit_and_compact(self) -> list[int]:
        """Harvest retired lanes, compact live ones (stable, live first),
        admit waiting work into the freed tail.  Returns finished ids."""
        if not self._needs_compaction():
            return []
        occupied = np.array([r is not None for r in self.lane_req])
        st = self._host_tile()
        done_ids = self._harvest(st, occupied & ~st.active)
        live = np.nonzero(occupied & st.active)[0]
        free = np.nonzero(~(occupied & st.active))[0]
        order = np.concatenate([live, free]).astype(np.int64)
        st = _map(lambda a: a[order], st)
        n_live = len(live)
        self.lane_req = ([self.lane_req[int(i)] for i in live]
                         + [None] * (self.batch_size - n_live))
        for slot in range(n_live, self.batch_size):
            if not (self.queue or self._adoptions):
                break
            self._admit_into(st, slot)
        self._sync_versions(st)
        self.lanes = self._upload(st)
        return done_ids

    def _sync_versions(self, st: LaneState) -> None:
        """Refresh the host version mirror; drop drained weight versions
        (dropping the last old one completes a rollout)."""
        self._lane_versions = np.asarray(st.weight_version).astype(np.int64)
        self.bank.gc({int(v) for v, r in zip(self._lane_versions,
                                             self.lane_req)
                      if r is not None})

    # ---- lane migration -------------------------------------------------
    def _live_rows(self, st: LaneState) -> list[tuple[int, LaneState]]:
        occupied = np.array([r is not None for r in self.lane_req])
        return [(self.lane_req[int(i)],
                 _map(lambda a, i=int(i): a[i].copy(), st))
                for i in np.nonzero(occupied & st.active)[0]]

    def snapshot_lanes(self) -> list[tuple[int, LaneState]]:
        """Harvest finished lanes, then return and release every in-flight
        lane as ``(request_id, row)`` — its complete chunk-boundary state,
        which :meth:`adopt` on any same-seed engine resumes exactly."""
        occupied = np.array([r is not None for r in self.lane_req])
        st = self._host_tile()
        self._harvest(st, occupied & ~st.active)
        rows = self._live_rows(st)
        self.lane_req = [None] * self.batch_size
        self._lane_versions = np.zeros(self.batch_size, np.int64)
        return rows

    def checkpoint_lanes(self) -> list[tuple[int, LaneState]]:
        """Non-destructive copy of every in-flight lane (same rows as
        :meth:`snapshot_lanes`; the engine keeps running)."""
        return self._live_rows(self._host_tile())

    def evict_lane(self, request_id: int) -> LaneState:
        """Pull one in-flight lane off the tile (the poison-request path):
        returns its row, as :meth:`snapshot_lanes` does, and frees its
        slot without touching any other lane."""
        slot = self.lane_req.index(request_id)
        st = self._host_tile()
        row = _map(lambda a: a[slot].copy(), st)
        st.active[slot] = False
        self.lane_req[slot] = None
        self._sync_versions(st)
        self.lanes = self._upload(st)
        return row

    def adopt(self, request_id: int, row: LaneState) -> None:
        """Queue an evacuated lane row; it is admitted ahead of fresh
        requests and resumes where it stopped.  Its weight version must be
        in this engine's bank."""
        rid = int(request_id)
        if self._id_in_use(rid):
            raise ValueError(f"request id {rid} already in use")
        v = int(row.weight_version)
        if v not in self.bank.versions:
            raise KeyError(
                f"adopting request {rid} needs weight version {v}, not in "
                f"bank {self.bank.versions} — restore it via bank.ensure()")
        self._adoptions.append((rid, row))
        self._next_id = max(self._next_id, rid + 1)

    def begin_rollout(self, params_q: dict) -> int:
        """Publish new weights without draining: new admissions bind the
        returned version, in-flight lanes finish on their own."""
        codes = tuple(layer["w_q"] for layer in params_q["layers"])
        sizes = tuple([int(codes[0].shape[0])]
                      + [int(w.shape[1]) for w in codes])
        if sizes != self.layer_sizes:
            raise ValueError(
                f"rollout cannot change the topology: engine serves "
                f"{self.layer_sizes}, new weights are {sizes}")
        if self.backend in ("fused", "fused_streamed"):
            ops.validate_weight_codes(codes)
        return self.bank.begin(self._place_weights(codes))

    # ---- dispatch -------------------------------------------------------
    def _advance(self, lanes: LaneState, weights: tuple):
        self.dispatches += 1
        return stream_chunk(
            lanes, weights, chunk_steps=self.controller.chunk_steps,
            num_steps=self.cfg.num_steps, lif_cfg=self.cfg.lif,
            dot_impl=self.cfg.dot_impl,
            active_pruning=self.cfg.active_pruning, patience=self.patience,
            readout=self.cfg.readout, backend=self.backend_effective,
            sparse_skip=self.cfg.sparse_skip)

    def _lane_rows(self, mask: np.ndarray) -> np.ndarray:
        """The rows of a (B,) host mask that this process's tile holds."""
        return mask

    def _dispatch_versions(self, lanes: LaneState):
        """One chunk per live weight version: each run freezes the other
        versions' lanes, and the per-lane merge takes every lane from its
        own version's run."""
        occ = [r is not None for r in self.lane_req]
        versions = sorted({int(v) for v, o in zip(self._lane_versions, occ)
                           if o})
        if len(versions) <= 1:
            v = versions[0] if versions else self.bank.current
            return self._advance(lanes, self._version_weights(v))
        outs = []
        for v in versions:
            mask = self._lane_rows(self._lane_versions == v)
            sub = lanes._replace(active=lanes.active & torch.as_tensor(
                mask, device=self.device))
            out, tel = self._advance(sub, self._version_weights(v))
            outs.append((mask, out, tel))
        return merge_version_chunks(outs)

    # ---- fault-guarded dispatch (serve.faults) --------------------------
    @property
    def backend_effective(self) -> str:
        """The ladder rung chunks dispatch on (the configured ``backend``
        until faults demote the engine)."""
        return self._ladder[self.health.demotion_level]

    def _health_event(self, ev: dict) -> None:
        """Record a health transition in the health log and in the
        telemetry controller's history."""
        self.health.events.append(ev)
        self.controller.history.append(ev)

    def _demote(self) -> None:
        lvl = self.health.demotion_level
        self._health_event({"event": "demote", "from": self._ladder[lvl],
                            "to": self._ladder[lvl + 1], "level": lvl + 1})
        self.health.demotion_level = lvl + 1
        # the new rung gets a fresh fault budget and a fresh clean streak
        self.health.consecutive_faults = 0
        self.health.clean_chunks = 0

    def _promote(self) -> None:
        lvl = self.health.demotion_level
        self._health_event({"event": "promote", "from": self._ladder[lvl],
                            "to": self._ladder[lvl - 1], "level": lvl - 1})
        self.health.demotion_level = lvl - 1
        self.health.clean_chunks = 0

    def _fail(self, reason: str, *, state_lost: bool = False):
        self.health.alive = False
        self._health_event({"event": "engine_failure", "reason": reason,
                            "state_lost": state_lost})
        raise EngineFailure(
            f"engine {self.engine_id} failed: {reason}",
            engine=self.engine_id, reason=reason, state_lost=state_lost)

    def _dispatch_chunk(self, lanes: LaneState):
        """Chunk dispatch with the fault harness in the loop.

        With no injector armed this is exactly :meth:`_dispatch_versions`.
        Armed, every launch attempt consults the injector first (the
        ``try`` covers that consult alone: an error the chunk itself
        raises propagates with the health state untouched):

        * **transient dispatch fault** → up to ``max_retries`` immediate
          retries of the pure chunk on unchanged lane state;
          ``demote_after`` consecutive faults step down the ladder; a
          round whose retries all faulted backs off a bounded number of
          scheduling rounds; ``fail_after`` consecutive faults with no
          rung left raise :class:`EngineFailure`;
        * **hang** → no progress; ``watchdog_chunks`` stalls in a row fail
          the engine with its lane state intact;
        * **device loss** → immediate failure, optionally with the lane
          state lost;
        * **poison request** → propagates for the tier to evict the lane;
        * **corrupted telemetry** → the record fails :func:`telemetry_ok`
          and is dropped; the chunk's result stands.

        Returns ``(lanes', telemetry | None)``: ``None`` marks a round
        with no observable record (hang, backoff, corruption).
        """
        if self.injector is None:
            return self._dispatch_versions(lanes)
        if not self.health.alive:
            raise EngineFailure(
                f"engine {self.engine_id} is dead", engine=self.engine_id,
                reason="dead", state_lost=False)
        ft = self.fault_cfg
        attempt = 0
        while True:
            try:
                tok = self.injector.before_dispatch(
                    attempt, backend=self.backend_effective,
                    rids=[r for r in self.lane_req if r is not None])
            except DeviceLostFault as e:
                self._fail("device_lost", state_lost=e.state_lost)
            except PoisonDispatchError:
                raise
            except DispatchFault as e:
                self.health.record_fault("dispatch", str(e))
                if (self.health.consecutive_faults >= ft.demote_after
                        and self.health.demotion_level + 1
                        < len(self._ladder)):
                    self._demote()
                    attempt = 0
                    continue
                if self.health.consecutive_faults >= ft.fail_after:
                    self._fail("dispatch_exhausted")
                attempt += 1
                if attempt <= ft.max_retries:
                    continue
                # the whole round faulted: deterministic bounded backoff,
                # counted in scheduling rounds (the tier's step currency)
                burst = self.health.consecutive_faults - 1
                self._cooldown = min(ft.backoff_base << min(burst, 8),
                                     ft.backoff_max)
                return lanes, None
            if tok == "hang":
                self.health.stalled_chunks += 1
                if self.health.stalled_chunks >= ft.watchdog_chunks:
                    self._fail("hang")
                return lanes, None
            out, tel = self._dispatch_versions(lanes)
            self.health.stalled_chunks = 0
            tel = self.injector.filter_telemetry(tel)
            if not telemetry_ok(tel):
                self.health.telemetry_faults += 1
                self._health_event({"event": "fault", "kind": "telemetry"})
                tel = None
            else:
                self.health.record_clean()
                if (self.health.demotion_level > 0
                        and self.health.clean_chunks >= ft.promote_after):
                    self._promote()
            return out, tel

    def _observe(self, src: LaneState, nxt: LaneState,
                 tel: ChunkTelemetry) -> None:
        """Feed one chunk's telemetry to the controller (adaptive only:
        frozen mode never reads telemetry back)."""
        if self.controller.frozen:
            return
        self.controller.observe(summarize_chunk(
            tel, self.layer_sizes, steps_before=src.steps,
            steps_after=nxt.steps, active_before=src.active,
            active_after=nxt.active))

    def step(self) -> list[int]:
        """Admit + run one chunk.  Returns the request ids finished."""
        done = self._admit_and_compact()
        if self._cooldown > 0:
            # transient-fault backoff: sit this scheduling round out
            self._cooldown -= 1
            return done
        src = self.lanes
        self.lanes, tel = self._dispatch_chunk(src)
        if tel is not None:
            self._observe(src, self.lanes, tel)
        return done

    def run(self, max_chunks: int | None = None) -> dict[int, RequestResult]:
        """Drive chunks until every submitted request has a result."""
        limit = max_chunks if max_chunks is not None else (
            (self.pending + self.batch_size)
            * (self.cfg.num_steps // max(1, self.controller.min_chunk_steps)
               + 2)
            # fault rounds (backoff, hang stalls) make no progress: an
            # armed harness gets bounded slack instead of a hard wedge
            + (0 if self.injector is None else 64))
        for _ in range(limit):
            if self.pending == 0:
                break
            self.step()
        self._admit_and_compact()
        return self.results


# ---------------------------------------------------------------------------
# the (data × model) lane mesh
# ---------------------------------------------------------------------------

def _device_grid(mesh: DeviceMesh, axis_name: str,
                 model_axis_name: str) -> list[list[torch.device]]:
    """The mesh's devices as rows of data shards × columns of model peers
    (one column when the mesh has no model axis)."""
    names = mesh.axis_names
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no {axis_name!r} axis")
    used = [axis_name] + ([model_axis_name] if model_axis_name in names
                          else [])
    if any(mesh.shape[n] > 1 for n in names if n not in used):
        raise ValueError(f"mesh {names} has axes other than {used} wider "
                         f"than 1")
    order = [names.index(n) for n in used]
    order += [i for i in range(len(names)) if i not in order]
    grid = np.transpose(mesh.devices, order).reshape(
        mesh.shape[axis_name], -1)
    return [list(row) for row in grid]


def split_lanes(lanes: LaneState, devices) -> list[LaneState]:
    """The lane tile cut into ``len(devices)`` contiguous row blocks, block
    ``d`` on ``devices[d]`` (data shard ``d``'s home device): the port of
    the data axis of ``lane_partition_specs``.  Lane state never splits on
    the model axis, so a row means the same on any mesh."""
    per = lanes.px.shape[0] // len(devices)
    return [_map(lambda a, d=d, dev=dev: a[d * per:(d + 1) * per].to(dev),
                 lanes) for d, dev in enumerate(devices)]


def _cat_lanes(parts, device) -> LaneState:
    """Inverse of :func:`split_lanes`: the data shards' tiles, in order,
    as one tile on ``device``."""
    def cat(leaves):
        return torch.cat([a.to(device) for a in leaves])

    return LaneState(*[
        tuple(cat(ls) for ls in zip(*f)) if isinstance(f[0], tuple)
        else cat(f) for f in zip(*parts)])


def _lane_pad(w: torch.Tensor) -> torch.Tensor:
    """A new zero-padded copy of ``w`` with both axes a multiple of LANE."""
    k, n = w.shape
    out = torch.zeros((k + (-k) % LANE, n + (-n) % LANE), dtype=torch.int16)
    out[:k, :n] = w
    return out


def shard_weights(codes: tuple, grid, model_ways: tuple | None, *,
                  planes: bool = False, coord: tuple | None = None) -> tuple:
    """Place the weight codes for a mesh: the port of
    ``weight_partition_specs``.

    Returns one entry per data shard (row of ``grid``).  Without a model
    axis (``model_ways`` None) an entry holds each layer's (n_in, n_out)
    int16 codes on the shard's home device, or with ``planes`` (the
    streamed kernel's operand) their LANE-padded int8 planes.  With one,
    it holds per layer a tuple of per-peer tensors: for a layer that splits ``ways``-way its
    contiguous output-column shards, each on its peer's device, and for a
    replicated layer the whole matrix on the home device; every one
    LANE-padded with zeros and packed once into its own contiguous
    ``(2, pad(n_out), pad(n_in))`` int8 planes
    (``kernels.fused_snn.pack_weights``, the partial-contraction kernel's
    operand), so no launch pads, packs or copies it.  A device named more
    than once in the grid holds each tensor once.

    With ``coord``, a rank's (data, model) cell of a process mesh, only
    that cell's tensors are placed, on its device, and the rank's entry
    is returned: per layer one tensor, its column shard (the whole matrix
    of a layer that replicates), or without a model axis the codes or
    planes.
    """
    if coord is not None:
        d, m = coord
        own = []
        for w, ways in zip(codes, model_ways or (None,) * len(codes)):
            w = torch.as_tensor(w).to(torch.int16)
            if ways is None:
                t = pack_weights(_lane_pad(w)) if planes else w.clone()
            else:
                n_sh = w.shape[1] // ways
                k = m if ways > 1 else 0
                t = pack_weights(_lane_pad(w[:, k * n_sh:(k + 1) * n_sh]))
            own.append(t.to(grid[d][m]).contiguous())
        return tuple(own)
    placed = {}

    def put(key, dev, make):
        if (key, dev) not in placed:
            placed[(key, dev)] = make().to(dev).contiguous()
        return placed[(key, dev)]

    codes = tuple(torch.as_tensor(w).to(torch.int16) for w in codes)
    out = []
    for row in grid:
        if model_ways is None:
            out.append(tuple(put((l, 0), row[0], lambda w=w: (
                pack_weights(_lane_pad(w)) if planes else w.clone()))
                for l, w in enumerate(codes)))
            continue
        layers = []
        for l, (w, ways) in enumerate(zip(codes, model_ways)):
            n_sh = w.shape[1] // ways
            layers.append(tuple(
                put((l, m), row[m],
                    lambda w=w, m=m: pack_weights(
                        _lane_pad(w[:, m * n_sh:(m + 1) * n_sh])))
                for m in range(ways)))
        out.append(tuple(layers))
    return tuple(out)


def sharded_stream_chunk(lanes: LaneState, weights: tuple, devices, *,
                         model_shards: int | None = None,
                         model_group: ModelGroup | None = None, **chunk_kw):
    """One chunk on a mesh: the port of ``make_sharded_stream_chunk``.

    Splits the lane tile over the data shards (:func:`split_lanes`, shard
    ``d`` to ``devices[d]``), runs :func:`stream_chunk` on each with its
    entry of :func:`shard_weights` (the model-axis datapath when
    ``model_shards`` is given) and joins the tiles and the telemetry
    (``core.telemetry.concat_shard_telemetry``: lanes and blocks
    data-outer) on the tile's device.  Every op of the chunk is per lane,
    so the result equals :func:`stream_chunk` on the whole tile.

    On a process mesh (``devices`` None) ``lanes`` and ``weights`` are
    this rank's own, its data shard's rows and its cell's tensors
    (:func:`shard_weights` with ``coord``): the chunk runs on them alone,
    the model axis' exchange as collectives over ``model_group``, and
    returns the rank's rows and its data shard's record.
    """
    if devices is None:
        return stream_chunk(lanes, weights, model_shards=model_shards,
                            model_group=model_group, **chunk_kw)
    home = lanes.px.device
    outs = [stream_chunk(part, w, model_shards=model_shards, **chunk_kw)
            for part, w in zip(split_lanes(lanes, devices), weights)]
    tel = concat_shard_telemetry(
        [ChunkTelemetry(*[a.to(home) for a in t]) for _, t in outs])
    return _cat_lanes([o for o, _ in outs], home), tel


class ShardedSNNStreamEngine(SNNStreamEngine):
    """(Data × model)-parallel lane mesh over the streaming engine (port of
    ``repro.serve.ShardedSNNStreamEngine``).

    The lane tile is sharded over the ``axis_name`` axis of a
    ``distributed.sharding.DeviceMesh``: data shard ``d`` owns
    ``batch_size // n_devices`` contiguous lane slots and runs the chunk
    on them.  If the mesh also carries a ``model_axis_name`` axis wider
    than 1 (``make_2d_device_mesh``), every layer whose width divides it
    splits its weight columns over the model peers: each peer contracts
    the full input-spike vector against its shard (one partial-contraction
    launch per step, layer and shard on a fused backend), steps LIF on its
    columns, and the shards' spikes and membranes concatenate at the layer
    boundary.  Layers that do not divide replicate and run once per data
    shard.  Results equal :class:`SNNStreamEngine`'s on the same seeds;
    lane rows never encode the mesh, so ``snapshot_lanes`` / ``adopt``
    move requests between any two engines.

    The mesh may name one device more than once (four model shards on one
    card); the shards then run one after the other on it.  ``backend``
    resolves, and the degradation ladder is built, by the stack kernels'
    feasibility model on one data shard's lanes and one model peer's
    weight shard, as the reference package judges them: on a card
    ``auto`` is ``fused``, else ``fused_streamed``, else it raises, and a
    named backend the model refuses raises.  On a model axis both fused
    rungs run the partial-contraction kernel (one launch per step, layer
    and shard) on the same packed shards; only their labels differ.
    Plain PyTorch runs the contraction only on the ``reference`` rung.
    The dispatch cache is keyed by the ``(data, model)`` mesh shape, and a
    hit's lane count is per data shard.

    Scheduling differences from the base engine:

      * **Block-local compaction**: retired lanes are compacted within
        their data shard's slot block, never across blocks.
      * **Round-robin admission**: queued requests fill freed slots
        cycling across the data shards' blocks.
      * **Speculative dispatch** (``overlap=True``, the default): after
        committing chunk *k* the engine enqueues chunk *k+1* on its output
        before the host reads chunk *k*'s retirements back.  If that
        readback leads to a compaction, or the controller's chunk length
        moved, the speculation is discarded and the chunk runs again from
        the compacted tile; the chunk is a pure function of the tile, so
        using it never changes results.  ``stats["spec_used"]`` /
        ``stats["spec_wasted"]`` count the outcomes.  On CUDA chunk *k+1*
        runs on a side stream of each device, after an event that marks
        chunk *k* committed on the main stream, so the readback of chunk
        *k* (on the main stream) does not wait for it; a used speculation
        is joined by the main stream waiting for the side stream, and a
        discarded one's outputs are kept until its event has passed.

    **One process per rank.**  On a mesh whose ``torch_mesh`` is set (a
    ``torch.distributed`` group of one rank per mesh cell,
    ``configs.snn_mnist.make_stream_mesh``) the engine is one rank of an
    SPMD program, as JAX's ``shard_map`` body is: the rank holds only its
    data shard's lane rows and its model peer's weight tensors
    (:func:`shard_weights` with ``coord``), launches the contraction on
    its own shard at every layer and exchanges the fired spikes and
    membranes over the model group (``distributed.sharding.exchange``);
    the host reads (the active mask, the lane tile, the telemetry the
    controller reads) gather the data shards' rows over the data group,
    so every rank holds the whole tile on the host and makes every host
    decision alike.  Every rank must therefore submit the same images in
    the same order; ``run()`` then returns the same results on every
    rank.  The fault harness (an injector, ``fault_cfg`` or
    ``REPRO_FAULT_PLAN``) raises ``NotImplementedError`` there: a fault on
    one rank would split the ranks' collective order.
    """

    def __init__(self, params_q: dict, cfg: SNNConfig, *,
                 mesh: DeviceMesh | None = None, axis_name: str = "data",
                 model_axis_name: str = "model",
                 lanes_per_device: int | None = None,
                 batch_size: int | None = None,
                 chunk_steps: int | None = None,
                 patience: int = 2, seed: int = 0,
                 backend: str | None = None, overlap: bool = True,
                 adaptive: AdaptiveDispatchConfig | None = None,
                 engine_id: int = 0,
                 injector: FaultInjector | None = None,
                 fault_cfg: FaultToleranceConfig | None = None,
                 initial_weight_version: int = 0,
                 block_b: int | None = None,
                 dispatch_cache=None):
        from ..tune.cache import CacheDecision, decide_dispatch
        if mesh is None:
            mesh = make_2d_device_mesh(
                model_devices=1, axis_names=(axis_name, model_axis_name))
        if model_axis_name == axis_name:
            raise ValueError(
                f"model_axis_name {model_axis_name!r} must differ from the "
                f"lane axis {axis_name!r}")
        self._grid = _device_grid(mesh, axis_name, model_axis_name)
        tm = mesh.torch_mesh
        # this rank's (data, model) cell on a process mesh, else None
        self._coord = None if tm is None else (
            mesh_rank(tm, axis_name), mesh_rank(tm, model_axis_name))
        if self._coord is not None and (
                injector is not None or fault_cfg is not None
                or injector_from_env(engine_id) is not None):
            refuse_process_mesh(mesh, "the fault harness")
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_devices = mesh.shape[axis_name]
        self.model_axis_name = model_axis_name
        self.model_devices = mesh.shape.get(model_axis_name, 1)
        self.model_axis = (model_axis_name if self.model_devices > 1
                           else None)
        w_shapes = [tuple(layer["w_q"].shape) for layer in params_q["layers"]]
        sizes = tuple([w_shapes[0][0]] + [s[1] for s in w_shapes])
        self.model_ways = layer_shard_ways(sizes, self.model_devices)
        # the cache is consulted here, keyed by this (data, model) mesh,
        # since the tuned per-device lane count fixes the tile's shape;
        # the base constructor takes the decision as made
        if isinstance(dispatch_cache, CacheDecision):
            decision = dispatch_cache
        else:
            decision = decide_dispatch(
                dispatch_cache, cfg=cfg, backend=backend,
                mesh_shape=(self.n_devices, self.model_devices),
                device=self._grid[0][0])
        if (decision.hit and batch_size is None
                and lanes_per_device is None):
            lanes_per_device = decision.tuned.lanes_per_device
        if batch_size is None:
            batch_size = (8 if lanes_per_device is None
                          else lanes_per_device) * self.n_devices
        elif (lanes_per_device is not None
              and batch_size != lanes_per_device * self.n_devices):
            raise ValueError(
                f"conflicting tile shape: batch_size={batch_size} but "
                f"lanes_per_device={lanes_per_device} × "
                f"{self.n_devices} devices = "
                f"{lanes_per_device * self.n_devices} — pass one or the "
                f"other")
        if batch_size % self.n_devices:
            raise ValueError(
                f"batch_size={batch_size} must divide evenly over the "
                f"{self.n_devices}-device {axis_name!r} axis")
        self.overlap = overlap
        self.stats = {"chunks": 0, "spec_used": 0, "spec_wasted": 0}
        self._spec: tuple | None = None
        self._spec_src: LaneState | None = None
        self._spec_steps: int | None = None
        self._side: dict = {}          # device -> side stream (CUDA only)
        self._spec_done: dict | None = None
        self._spec_dropped: list = []
        super().__init__(params_q, cfg, batch_size=batch_size,
                         chunk_steps=chunk_steps, patience=patience,
                         seed=seed, backend=backend,
                         local_batch=batch_size // self.n_devices,
                         model_shards=self.model_devices, adaptive=adaptive,
                         engine_id=engine_id, injector=injector,
                         fault_cfg=fault_cfg,
                         initial_weight_version=initial_weight_version,
                         device=self._grid[0][0] if tm is None else
                         self._grid[self._coord[0]][self._coord[1]],
                         block_b=block_b, dispatch_cache=decision)
        self._model_group = None
        if tm is not None:
            self.lanes = _init_lanes(self.local_batch, self.layer_sizes,
                                     cfg.num_steps, cfg.lif.v_rest,
                                     self.device)
            if self.model_axis:
                self._model_group = ModelGroup(tm, model_axis_name,
                                               self.model_ways)

    # ---- device placement ----------------------------------------------
    def _weight_form(self, rung: str) -> str:
        # on a model axis every rung reads the same packed column shards
        return "shards" if self.model_axis else super()._weight_form(rung)

    def _place_form(self, codes: tuple, form: str) -> tuple:
        return shard_weights(
            codes, self._grid, self.model_ways if form == "shards" else None,
            planes=form == "planes", coord=self._coord)

    def _advance(self, lanes: LaneState, weights: tuple):
        self.dispatches += 1
        return sharded_stream_chunk(
            lanes, weights,
            None if self._coord else [row[0] for row in self._grid],
            model_shards=self.model_devices if self.model_axis else None,
            model_group=self._model_group,
            chunk_steps=self.controller.chunk_steps,
            num_steps=self.cfg.num_steps, lif_cfg=self.cfg.lif,
            dot_impl=self.cfg.dot_impl,
            active_pruning=self.cfg.active_pruning, patience=self.patience,
            readout=self.cfg.readout, backend=self.backend_effective,
            sparse_skip=self.cfg.sparse_skip)

    # ---- the host's view of a process mesh ------------------------------
    def _lane_rows(self, mask: np.ndarray) -> np.ndarray:
        if self._coord is None:
            return mask
        lo = self._coord[0] * self.local_batch
        return mask[lo:lo + self.local_batch]

    def _gather_data(self, xs, *, host: bool = False) -> list:
        """The data shards' rows of each tensor, in data order (one
        collective over the data group)."""
        return gather_rows(xs, self.mesh.torch_mesh, self.axis_name,
                           host=host)

    def _host_tile(self) -> LaneState:
        if self._coord is None:
            return super()._host_tile()
        leaves = self._gather_data(_leaves(self.lanes), host=True)
        return _unleaves(self.lanes, [_to_host(a) for a in leaves])

    def _upload(self, st: LaneState) -> LaneState:
        if self._coord is not None:    # a rank keeps its data shard's rows
            lo = self._coord[0] * self.local_batch
            st = _map(lambda a: a[lo:lo + self.local_batch], st)
        return super()._upload(st)

    def _read_active(self) -> np.ndarray:
        if self._coord is None or self.n_devices == 1:
            return super()._read_active()
        return self._gather_data([self.lanes.active],
                                 host=True)[0].numpy().copy()

    def _observe(self, src: LaneState, nxt: LaneState,
                 tel: ChunkTelemetry) -> None:
        if self._coord is None or self.controller.frozen:
            return super()._observe(src, nxt, tel)
        # the mesh's record (lanes and blocks data-outer) and the lane
        # counters the summary reads, in one gather over the data group
        *leaves, s0, s1, a0, a1 = self._gather_data(
            [t.movedim(-1, 0) for t in tel]
            + [src.steps, nxt.steps, src.active, nxt.active])
        tel = ChunkTelemetry(*[t.movedim(0, -1) for t in leaves])
        self.controller.observe(summarize_chunk(
            tel, self.layer_sizes, steps_before=s0, steps_after=s1,
            active_before=a0, active_after=a1))

    # ---- scheduling -----------------------------------------------------
    def _admit_and_compact(self) -> list[int]:
        """Block-local compaction + round-robin admission (see class doc)."""
        if not self._needs_compaction():
            return []
        occupied = np.array([r is not None for r in self.lane_req])
        st = self._host_tile()
        done_ids = self._harvest(st, occupied & ~st.active)
        order, lane_req, free_slots = [], [], []
        for d in range(self.n_devices):
            lo = d * self.local_batch
            block = np.arange(lo, lo + self.local_batch)
            keep = occupied[block] & st.active[block]
            live, free = block[keep], block[~keep]
            order.extend(live.tolist() + free.tolist())
            lane_req.extend([self.lane_req[int(i)] for i in live]
                            + [None] * len(free))
            free_slots.append(list(range(lo + len(live),
                                         lo + self.local_batch)))
        st = _map(lambda a: a[np.asarray(order, np.int64)], st)
        self.lane_req = lane_req
        while (self.queue or self._adoptions) and any(free_slots):
            for d in range(self.n_devices):
                if not (self.queue or self._adoptions):
                    break
                if free_slots[d]:
                    self._admit_into(st, free_slots[d].pop(0))
        self._sync_versions(st)
        self.lanes = self._upload(st)
        return done_ids

    def step(self) -> list[int]:
        """Admit + run one chunk, with chunk k+1 enqueued speculatively."""
        done = self._admit_and_compact()
        if self._cooldown > 0:
            self._cooldown -= 1
            return done
        if (self._spec is not None and self.lanes is self._spec_src
                and self._spec_steps == self.controller.chunk_steps):
            # the tile is the very one the speculation ran from and the
            # controller still wants its chunk length: it IS this chunk
            src = self._spec_src
            nxt, tel = self._join_speculation()
            self.stats["spec_used"] += 1
        else:
            if self._spec is not None:
                self.stats["spec_wasted"] += 1
                self._drop_speculation()
            src = self.lanes
            nxt, tel = self._dispatch_chunk(src)
        self._spec = self._spec_src = self._spec_steps = None
        self._spec_done = None
        self.lanes = nxt
        self.stats["chunks"] += 1
        if tel is not None:
            self._observe(src, nxt, tel)
        # no speculation while a fault harness is armed: a speculative
        # launch would consume injector consults one step early and detach
        # the fault coordinates from the committed dispatch sequence
        if self.overlap and self.injector is None and (
                self.queue or any(r is not None for r in self.lane_req)):
            self._spec_src = nxt
            self._spec_steps = self.controller.chunk_steps
            self._spec = self._speculate(nxt)
        return done

    # ---- speculation on side streams (CUDA) -----------------------------
    def _side_stream(self, dev: torch.device):
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(device=dev)
        return self._side[dev]

    def _speculate(self, src: LaneState):
        """Dispatch chunk k+1 from ``src`` (chunk k's output).  On CUDA it
        runs on each device's side stream after chunk k is committed on
        the main stream; everything it reads is marked as used there.

        On a process mesh the chunk's exchanges run inside it.  Under
        ``nccl`` they are enqueued behind the side stream, their buffers
        are allocated on it and it waits for each collective, so the
        events recorded below cover them too.  Under ``gloo`` the staged
        exchange blocks the host until the side stream has produced its
        input, so a speculation overlaps nothing there."""
        if self.device.type != "cuda":
            return self._dispatch_versions(src)
        reads = list(_cuda_leaves(src)) + [
            t for v in self.bank.versions
            for t in _cuda_leaves(self.bank.weights(v))]
        main = self.device if self.device.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
        devices = {t.device for t in reads} | {main}
        sides = {d: self._side_stream(d) for d in devices}
        for d, side in sides.items():
            side.wait_event(torch.cuda.current_stream(d).record_event())
        for t in reads:
            t.record_stream(sides[t.device])
        with contextlib.ExitStack() as stack:
            for side in sides.values():
                stack.enter_context(torch.cuda.stream(side))
            spec = self._dispatch_versions(src)
        self._spec_done = {d: side.record_event()
                           for d, side in sides.items()}
        return spec

    def _join_speculation(self):
        """The speculative chunk's outputs, made safe to use on the main
        streams: each waits for its side stream, and every output is
        marked as used there."""
        spec = self._spec
        if self._spec_done is None:
            return spec
        for d, side in self._side.items():
            torch.cuda.current_stream(d).wait_stream(side)
        for t in _cuda_leaves(spec):
            t.record_stream(torch.cuda.current_stream(t.device))
        return spec

    def _drop_speculation(self) -> None:
        """Discard the speculative chunk; on CUDA its outputs are released
        only once its side-stream events have passed."""
        if self._spec_done is not None:
            self._spec_dropped.append((self._spec_done, self._spec))
        self._spec_dropped = [
            (evs, out) for evs, out in self._spec_dropped
            if not all(e.query() for e in evs.values())]
