"""The paper's SNN on torch tensors (port of ``repro.core.snn``).

Network topology (paper §IV-A): Poisson encoder → fully-connected LIF
layer stack → spike-register readout over a T-step window; the paper's
configuration is the single 784→10 layer.  Training: :func:`snn_init`,
the differentiable :func:`snn_apply_float` (surrogate gradients, QAT
through fake-quantised weights) and :func:`snn_loss`;
:func:`quantize_params` maps the float weights onto 9-bit codes.  The
integer inference engine: :func:`snn_apply_int` (whole window) and the
resumable :func:`snn_window_chunk`, on backends that give the same
integers:

  fused           — the resident encode→LIF stack kernel (``kernels.ops``):
                    one launch per chunk on CUDA
  fused_streamed  — the same function on the weight-streaming kernel, for
                    stacks whose per-lane state the resident kernel's
                    shared memory cannot hold
  staged          — the encoder kernel once, then one LIF kernel per
                    layer, over materialised spike trains, the readouts
                    taken in the kernels' epilogues (whole windows only;
                    any int16 weight code)
  reference       — per-step torch ops (:func:`snn_int_stack_step`)
  auto            — on a CUDA device the chain fused → fused_streamed →
                    staged, the first whose kernel holds the stack; the
                    reference on the CPU.  A whole-window call that the
                    chain gives to fused_streamed runs staged instead
                    (:func:`snn_apply_int`): layer by layer over all T
                    steps, since it need not resume

On CPU tensors every kernel backend runs its kernels' plain versions.

Parameters: float ``{"layers": [{"w": float32 (n_in, n_out)}]}``;
quantized ``{"layers": [{"w_q": int16 (n_in, n_out), "scale": float}]}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..distributed.sharding import exchange, mesh_rank
from ..kernels import fused_snn, ops
from ..kernels.ops import V_PEAK_INIT
from . import encoding, fixed_point, lif, prng
from .spans import count, span
from .telemetry import (ChunkTelemetry, layer_tile_skips, model_tile_skips,
                        resolve_sparse_skip)

__all__ = ["SNNConfig", "snn_init", "snn_apply_float", "snn_loss",
           "quantize_params", "readout_pred", "encode_lif_timestep",
           "snn_int_stack_step", "snn_int_stack_step_sharded",
           "ModelGroup", "snn_apply_int", "resolve_backend",
           "fused_unsupported_reason", "SNNWindowState", "snn_window_init",
           "snn_window_chunk"]


@dataclass(frozen=True)
class SNNConfig:
    layer_sizes: tuple[int, ...] = (784, 10)   # paper: single FC 784→10
    num_steps: int = 20                        # simulation window
    lif: lif.LIFConfig = field(default_factory=lif.LIFConfig)
    weight_bits: int = 8                       # paper: 8-bit codes (+ sign)
    qat: bool = True                           # train through fake-quant
    surrogate_slope: float = 4.0
    readout: str = "count"                     # count|first_spike|membrane
    active_pruning: bool = False
    dot_impl: str = "int32"                    # reference Σ W·S precision
    # reference backend, one layer: encode inside the LIF step, one loop
    # over the window (the JAX package's fused scan)
    fuse_encoder: bool = False
    backend: str = "auto"         # auto|fused|fused_streamed|staged|reference
    sparse_skip: bool | None = None            # tile-skip telemetry
    spike_density_threshold: float | None = None  # controller baseline
    # False: the fused-encoder scan keeps no trace, so v_trace,
    # active_adds, input_spikes, v_peak and telemetry come back None
    emit_trace: bool = True
    # float threshold of training; quantize_params scales it onto the
    # integer Threshold-Reg
    train_threshold: float = 1.0

    @property
    def n_in(self) -> int:
        return self.layer_sizes[0]

    @property
    def n_classes(self) -> int:
        return self.layer_sizes[-1]


def snn_init(generator: torch.Generator, cfg: SNNConfig, *,
             device: str | torch.device | None = None) -> dict:
    """Float params: per layer normal weights × 2/√fan_in (LeCun-style,
    scaled for spiking inputs of rate ≲ 0.5), drawn from ``generator`` on
    its own device and placed on ``device`` (None = the card)."""
    dev = resolve_device(device)
    layers = []
    for fan_in, fan_out in zip(cfg.layer_sizes[:-1], cfg.layer_sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=generator.device)
        layers.append({"w": (w * (2.0 / fan_in ** 0.5)).to(dev)})
    return {"layers": layers}


def _train_lif_cfg(cfg: SNNConfig) -> lif.LIFConfig:
    """Float-threshold LIF of training (V_th = ``train_threshold``)."""
    return lif.LIFConfig(decay_shift=cfg.lif.decay_shift,
                         v_threshold=cfg.train_threshold, v_rest=0)


def snn_apply_float(params: dict, pixels01: torch.Tensor,
                    generator: torch.Generator, cfg: SNNConfig):
    """Differentiable forward; ``pixels01`` (batch, n_in) in [0, 1], the
    spike train drawn from ``generator`` on the pixels' device.

    Returns dict(rates=(batch, n_classes) mean firing rates,
    spikes=(T, batch, n_classes), v_trace=(T, batch, n_classes)).
    """
    spikes = encoding.poisson_encode_float(pixels01, cfg.num_steps,
                                           generator=generator)
    tcfg = _train_lif_cfg(cfg)
    for layer in params["layers"]:
        w = layer["w"]
        if cfg.qat:
            w = fixed_point.fake_quant(w, cfg.weight_bits)
        spikes, v_trace, _ = lif.run_lif_float(spikes, w, tcfg,
                                               cfg.surrogate_slope)
    return {"rates": encoding.spike_train_rates(spikes), "spikes": spikes,
            "v_trace": v_trace}


def snn_loss(params: dict, pixels01: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator, cfg: SNNConfig):
    """Rate-coded cross-entropy: softmax over time-summed spike counts,
    plus a small L2 on rates against saturation.  Returns
    ``(loss, {"loss": nll, "acc": accuracy})``."""
    out = snn_apply_float(params, pixels01, generator, cfg)
    # counts in [0, T] -> logits; the scale keeps softmax in a sane range
    logits = out["rates"] * float(cfg.num_steps) * 0.5
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    nll = -torch.gather(logp, -1, labels[:, None]).mean()
    reg = 1e-3 * torch.mean(out["rates"] ** 2)
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return nll + reg, {"loss": nll.detach(), "acc": acc}


@torch.no_grad()
def quantize_params(params: dict, cfg: SNNConfig) -> dict:
    """Float → fixed point for the integer engine.

    Integer codes are ``w · gain`` with ``gain = v_threshold /
    train_threshold``, so Σ w_q·S crosses the Threshold-Reg exactly when
    the float accumulator would cross ``train_threshold`` (up to
    rounding); signed ``weight_bits + 1``-bit codes (paper §V-B: 9 bits),
    int16, on the weights' device.
    """
    gain = float(cfg.lif.v_threshold) / cfg.train_threshold
    code_bits = cfg.weight_bits + 1
    qmin, qmax = -(1 << (code_bits - 1)), (1 << (code_bits - 1)) - 1
    out = []
    for layer in params["layers"]:
        w = layer["w"]
        if cfg.qat:
            w = fixed_point.fake_quant(w, cfg.weight_bits)
        w_q = torch.clamp(torch.round(w * gain), qmin, qmax)
        out.append({"w_q": w_q.to(torch.int16), "scale": 1.0 / gain})
    return {"layers": out}


def _param_sizes(params_q: dict) -> tuple[int, ...]:
    return tuple([int(params_q["layers"][0]["w_q"].shape[0])]
                 + [int(l["w_q"].shape[1]) for l in params_q["layers"]])


def fused_unsupported_reason(cfg: SNNConfig, n_layers: int,
                             layer_sizes: tuple[int, ...] | None = None,
                             local_batch: int | None = None, *,
                             streamed: bool = False,
                             model_shards: int = 1) -> str | None:
    """Why a CUDA stack kernel cannot run this stack (None = it can).

    The Hopper feasibility model.  The resident kernel keeps each lane's
    pixels and PRNG state in registers (at most ``K1_MAX_PIXELS`` inputs,
    counted after padding to ``K1_PIXEL_ALIGN``) and its per-layer
    membranes/enables/peaks, readout registers and two spike bitmaps in
    dynamic shared memory at the real widths
    (``kernels.fused_snn.stack_smem_bytes``); the weight-streaming kernel
    (``streamed``) keeps only its 64 lanes' spike bitmaps and small
    counters there (``stack_streamed_smem_bytes``, on the LANE-padded
    widths), whatever the batch.  One thread block may claim up to
    ``SMEM_LIMIT_BYTES`` (232,448 B on sm_90).  Both kernels' parameter
    blocks hold ``MAX_LAYERS`` layers of at most 65,535 neurons (inputs
    and neurons are indexed in 16 bits).
    On a ``model_shards``-way model axis every layer that divides
    (``kernels.fused_snn.layer_shard_ways``) holds only its
    output-column shard per peer, so the check runs on the per-shard
    widths, as the reference judges VMEM per shard.
    """
    if n_layers < 1:
        return "the network has no layers"
    if model_shards < 1:
        return f"model_shards={model_shards} is not a positive shard count"
    if n_layers > fused_snn.MAX_LAYERS:
        return (f"{n_layers} layers exceed the stack kernels' "
                f"{fused_snn.MAX_LAYERS}-layer parameter block")
    sizes = layer_sizes
    if sizes is None and len(cfg.layer_sizes) - 1 == n_layers:
        sizes = cfg.layer_sizes
    if sizes is None:
        return None
    ways = fused_snn.layer_shard_ways(sizes, model_shards)
    sizes = (sizes[0],) + tuple(int(n) // w for n, w in zip(sizes[1:], ways))
    lane = fused_snn.LANE
    padded = [int(n) + (-int(n)) % lane for n in sizes]
    if max(padded) > 65535:
        return f"layer widths {tuple(sizes)} exceed the uint16 spike indices"
    k0 = int(sizes[0]) + (-int(sizes[0])) % fused_snn.K1_PIXEL_ALIGN
    if not streamed and k0 > fused_snn.K1_MAX_PIXELS:
        return (f"{sizes[0]} inputs exceed the {fused_snn.K1_MAX_PIXELS} "
                f"pixels a lane the resident kernel holds in registers")
    need = (fused_snn.stack_streamed_smem_bytes(padded) if streamed else
            fused_snn.stack_smem_bytes([k0] + [int(n) for n in sizes[1:]],
                                       fused_snn.block_b_for(local_batch)))
    if need > fused_snn.SMEM_LIMIT_BYTES:
        kind = "streamed working set" if streamed else \
            "shared-memory carve-up"
        shard = (f" on a {model_shards}-way model axis"
                 if model_shards > 1 else "")
        return (f"{kind} {need} B for layer_sizes={tuple(sizes)}{shard} "
                f"exceeds the {fused_snn.SMEM_LIMIT_BYTES} B a thread block "
                f"may use")
    return None


def resolve_backend(cfg: SNNConfig, backend: str | None = None,
                    n_layers: int = 1, *,
                    layer_sizes: tuple[int, ...] | None = None,
                    local_batch: int | None = None,
                    model_shards: int = 1,
                    device: str | torch.device = "cuda",
                    dispatch_cache=None, mesh_shape=(1,),
                    shapes: tuple[int, int] | None = None,
                    resumable: bool = False) -> str:
    """Pick the integer-engine backend that runs on ``device``.

    ``auto`` on a CUDA device walks the chain fused → fused_streamed →
    staged: the resident stack kernel for a stack whose per-lane state
    fits its shared memory, the weight-streaming kernel past that, and the
    staged kernels (which hold any stack) last; on the CPU ``auto`` is
    ``reference``.  An explicit ``fused`` or ``fused_streamed`` that its
    kernel cannot run raises, naming the next rung, instead of degrading;
    plain PyTorch runs on the card only when the caller names
    ``reference``.  ``model_shards`` scopes the shared-memory check to one
    model peer's shard (see :func:`fused_unsupported_reason`).

    ``dispatch_cache`` (a ``repro_torch.tune.DispatchCache``, a cache-file
    path, a ``CacheDecision`` already made, or None) short-circuits an
    ``auto`` resolution: a hit for this config on this device kind and
    ``mesh_shape`` carries the backend that resolved in the tuned run,
    adopted if it passes this device's gate — a stack kernel only on a
    card whose shared memory holds the lanes, ``staged`` unless the
    caller needs a ``resumable`` backend, ``reference`` only off the card
    — and otherwise the chain above runs.  ``shapes`` is the caller's
    running ``(chunk_steps, lanes)``: when given, the cached backend
    applies only at the shapes it was tuned at.  Explicit requests ignore
    the cache.
    """
    b = backend if backend is not None else cfg.backend
    on_cuda = torch.device(device).type == "cuda"

    def reason(streamed: bool, lanes: int | None = local_batch
               ) -> str | None:
        return fused_unsupported_reason(cfg, n_layers, layer_sizes,
                                        lanes, streamed=streamed,
                                        model_shards=model_shards)

    if b == "auto" and dispatch_cache is not None:
        from ..tune.cache import CacheDecision, decide_dispatch
        decision = (dispatch_cache
                    if isinstance(dispatch_cache, CacheDecision)
                    else decide_dispatch(dispatch_cache, cfg=cfg,
                                         backend="auto",
                                         mesh_shape=mesh_shape,
                                         device=device))
        t = decision.tuned if decision.hit else None
        lanes = (None if t is None else t.lanes_per_device
                 if local_batch is None else local_batch)
        if t is None or (shapes is not None and tuple(shapes)
                         != (t.chunk_steps, t.lanes_per_device)):
            ok = False
        elif t.backend in ("fused", "fused_streamed"):
            ok = on_cuda and reason(t.backend == "fused_streamed",
                                    lanes) is None
        elif t.backend == "staged":
            ok = not resumable
        else:
            ok = not on_cuda
        if ok:
            return t.backend

    if b == "auto":
        if not on_cuda:
            b = "reference"
        elif reason(False) is None:
            b = "fused"
        elif reason(True) is None:
            b = "fused_streamed"
        else:
            b = "staged"
    if b == "fused" and (why := reason(False)) is not None:
        raise ValueError(
            f"backend='fused' was explicitly requested but the stack kernel "
            f"does not support this configuration: {why} — use "
            f"backend='fused_streamed' or 'staged'")
    if b == "fused_streamed" and (why := reason(True)) is not None:
        raise ValueError(
            f"backend='fused_streamed' was explicitly requested but even "
            f"the weight-streaming kernel cannot run this configuration: "
            f"{why} — use backend='staged'")
    if b not in ("fused", "fused_streamed", "staged", "reference"):
        raise ValueError(f"unknown SNN backend {b!r}")
    return b


def readout_pred(counts: torch.Tensor, first_t: torch.Tensor,
                 v_final: torch.Tensor, readout: str, num_steps: int,
                 v_trace: torch.Tensor | None = None,
                 v_peak: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane prediction under the configured readout (int64 indices).

    ``count``: spike-register argmax.  ``first_spike``: earliest-spiking
    class in an additive ``1 << 24`` tier, clipped membrane as the no-spike
    tiebreak.  ``membrane``: argmax of the carried peak ``v_peak``, or of
    ``max(v_trace)`` over time.  Ties go to the first index.
    """
    if readout == "count":
        return torch.argmax(counts, dim=-1)
    if readout == "membrane":
        if v_peak is not None:
            return torch.argmax(v_peak, dim=-1)
        return torch.argmax(v_trace.amax(dim=0), dim=-1)
    large = 1 << 24
    score = torch.where(counts > 0, large + (num_steps - first_t),
                        torch.clamp(v_final, -large + 1, large - 1))
    return torch.argmax(score, dim=-1)


def _whole_window_backend(cfg: SNNConfig, backend: str | None,
                          layer_sizes: tuple[int, ...], lanes: int,
                          device) -> tuple[str, bool]:
    """The backend a whole-window :func:`snn_apply_int` call runs, and
    whether its codes are held to the stack kernels' signed 9-bit range.

    :func:`resolve_backend`'s, except where an ``auto`` request reaches
    ``fused_streamed``: a stack the resident kernel cannot hold then runs
    the staged kernels, layer by layer over all T steps, which beat the
    step-major streaming kernel at every lane count measured, 64 to
    10,000 (``PERF.md`` §6, the lane-count table), so no lane count
    keeps it.  The codes are still validated there, as on the stack
    kernels, so that ``auto`` refuses the same weights on every route.
    An explicit ``fused_streamed`` launches the streaming kernel.
    """
    b = resolve_backend(cfg, backend, len(layer_sizes) - 1,
                        layer_sizes=layer_sizes, local_batch=lanes,
                        device=device)
    requested = backend if backend is not None else cfg.backend
    if b == "fused_streamed" and requested == "auto":
        return "staged", True
    return b, b in ("fused", "fused_streamed")


def snn_apply_int(params_q: dict, pixels_u8: torch.Tensor,
                  prng_state: torch.Tensor, cfg: SNNConfig, *,
                  backend: str | None = None):
    """Bit-exact fixed-point inference over the whole window.

    Runs on the device of ``pixels_u8``.  Returns a dict with ``pred``,
    ``spike_counts``, ``v_trace``, ``v_final``, ``active_adds``,
    ``input_spikes`` (None on the fused backends: the spike train never
    exists there), ``first_spike_t``, ``prng_state``, ``v_peak`` (per-layer
    tuple) and ``telemetry``.  The reference backend's fused-encoder scan
    (``cfg.fuse_encoder`` on one layer) with ``cfg.emit_trace`` off keeps
    no trace: ``v_trace``, ``active_adds``, ``input_spikes``, ``v_peak``
    and ``telemetry`` are then None.  The call is the span
    ``snn.apply_int`` and counts once in the counter
    ``snn.apply_int.<backend>`` of the backend that ran (``core.spans``).
    """
    with span("snn.apply_int"):
        b, nine_bit = _whole_window_backend(cfg, backend,
                                            _param_sizes(params_q),
                                            pixels_u8.shape[0],
                                            pixels_u8.device)
        count("snn.apply_int." + b)
        if nine_bit:
            ops.validate_weight_codes(tuple(layer["w_q"]
                                            for layer in params_q["layers"]))
        if b in ("fused", "fused_streamed"):
            res = _apply_int_fused(params_q, pixels_u8, prng_state, cfg,
                                   streamed=b == "fused_streamed")
        elif b == "staged":
            res = _apply_int_staged(params_q, pixels_u8, prng_state, cfg)
        else:
            res = _apply_int_reference(params_q, pixels_u8, prng_state, cfg)
        vp = res["v_peak"]
        res["pred"] = readout_pred(res["spike_counts"], res["first_spike_t"],
                                   res["v_final"], cfg.readout, cfg.num_steps,
                                   v_trace=res["v_trace"],
                                   v_peak=None if vp is None else vp[-1])
        return res


def _lif_kw(cfg: SNNConfig) -> dict:
    c = cfg.lif
    return dict(decay_shift=c.decay_shift, v_threshold=c.v_threshold,
                v_rest=c.v_rest, v_min=c.v_min, v_max=c.v_max,
                active_pruning=cfg.active_pruning)


def _apply_int_fused(params_q, pixels_u8, prng_state, cfg: SNNConfig, *,
                     streamed: bool = False):
    """One stack-kernel launch over the whole window (resident, or with the
    weights streamed when ``streamed``)."""
    weights = tuple(layer["w_q"] for layer in params_q["layers"])
    k = ops.fused_snn_stack_op(pixels_u8, prng_state, weights,
                               num_steps=cfg.num_steps,
                               sparse_skip=cfg.sparse_skip, streamed=streamed,
                               **_lif_kw(cfg))
    return {"spike_counts": k["spike_counts"], "v_trace": k["v_trace"],
            "v_final": k["v_final"], "active_adds": k["active_adds"],
            "input_spikes": None, "first_spike_t": k["first_spike_t"],
            "prng_state": k["prng_state"], "v_peak": k["v_peak"],
            "telemetry": k["telemetry"]}


def _derive_stack_telemetry(layer_ins, layer_outs, layer_vtr,
                            cfg: SNNConfig):
    """Telemetry + peaks re-derived from whole-window spike trains.

    Per layer a neuron is enabled at step t iff it has not fired before t
    (or pruning is off); the tile counter replays the launch-geometry skip
    predicates on the same spike/enable state.  Returns
    ``(ChunkTelemetry, v_peak tuple)``.
    """
    ss = resolve_sparse_skip(cfg.sparse_skip)
    n_spk_l, n_en_l, tiles_l, peaks = [], [], [], []
    for x, out, vtr in zip(layer_ins, layer_outs, layer_vtr):
        if cfg.active_pruning:
            out_i = out.to(torch.int32)
            en = (torch.cumsum(out_i, dim=0) - out_i) == 0
        else:
            en = torch.ones_like(out, dtype=torch.bool)
        n_spk_l.append(x.sum(-1, dtype=torch.int32))
        n_en_l.append(en.sum(-1, dtype=torch.int32))
        tiles_l.append(layer_tile_skips(x, en, sparse_skip=ss))
        peaks.append(vtr.amax(dim=0))
    tel = ChunkTelemetry(n_spk=torch.stack(n_spk_l, dim=1),
                         n_en=torch.stack(n_en_l, dim=1),
                         tiles_skipped=torch.stack(tiles_l, dim=1))
    return tel, tuple(peaks)


def _apply_int_staged(params_q, pixels_u8, prng_state, cfg: SNNConfig):
    """The staged kernels: one encoder launch, then one LIF launch per
    layer, each over the padded spike train the launch before wrote.  The
    telemetry, the peaks and the last layer's counts come from the
    kernels' epilogues (``kernels.ops.lif_forward_readout_op``), so no
    PyTorch pass reads a (T, B, width) train; they equal
    :func:`_derive_stack_telemetry`'s on the same trains."""
    T, B = cfg.num_steps, pixels_u8.shape[0]
    sizes = _param_sizes(params_q)
    tallies = ops.staged_tallies(T, len(sizes) - 1, B, pixels_u8.device)
    x, prng_next = ops.poisson_encode_readout_op(pixels_u8, prng_state, T,
                                                 tallies)
    input_spikes = x[:, :B, :sizes[0]]
    peaks = []
    for l, layer in enumerate(params_q["layers"]):
        r = ops.lif_forward_readout_op(x, layer["w_q"], tallies, layer=l,
                                       b_valid=B, **_lif_kw(cfg))
        x = r["spikes"]
        peaks.append(r["v_peak"])
    telemetry = ops.staged_telemetry(
        tallies, sizes, B, sparse_skip=resolve_sparse_skip(cfg.sparse_skip),
        active_pruning=cfg.active_pruning)
    # the executed-add channel is the telemetry's adds summed over layers
    return {"spike_counts": r["counts"], "v_trace": r["v_trace"],
            "v_final": r["v_final"],
            "active_adds": telemetry.adds.sum(1, dtype=torch.int32),
            "input_spikes": input_spikes, "first_spike_t": r["first"],
            "prng_state": prng_next, "v_peak": tuple(peaks),
            "telemetry": telemetry}


def _apply_int_reference(params_q, pixels_u8, prng_state, cfg: SNNConfig):
    """Per-layer torch scans over the materialised spike trains, or, for
    one layer with ``cfg.fuse_encoder``, one scan that encodes inside the
    LIF step (:func:`_fused_encode_lif`)."""
    if cfg.fuse_encoder and len(params_q["layers"]) == 1:
        res, prng_next = _fused_encode_lif(params_q["layers"][0]["w_q"],
                                           pixels_u8, prng_state, cfg)
        spikes, adds = res["input_spikes"], res["active_adds"]
        layer_ins, layer_outs = [spikes], [res["spikes"]]
        layer_vtr = [res["v_trace"]]
    else:
        spikes, prng_next = encoding.poisson_encode_hw(pixels_u8, prng_state,
                                                       cfg.num_steps)
        x = spikes
        adds = 0
        res = None
        layer_ins, layer_outs, layer_vtr = [], [], []
        for layer in params_q["layers"]:
            layer_ins.append(x)
            res = lif.run_lif_int(x, layer["w_q"], cfg.lif,
                                  active_pruning=cfg.active_pruning,
                                  dot_impl=cfg.dot_impl)
            adds = adds + res["active_adds"]
            x = res["spikes"]
            layer_outs.append(x)
            layer_vtr.append(res["v_trace"])
    if layer_vtr[0] is not None:
        telemetry, v_peak = _derive_stack_telemetry(layer_ins, layer_outs,
                                                    layer_vtr, cfg)
    else:                                  # emit_trace off: no trace kept
        telemetry, v_peak = None, None
    out_spikes = res["spikes"]
    T = cfg.num_steps
    t_idx = torch.arange(T, dtype=torch.int32,
                         device=out_spikes.device)[:, None, None]
    first_t = torch.where(out_spikes, t_idx, T).amin(dim=0)
    return {"spike_counts": out_spikes.sum(0, dtype=torch.int32),
            "v_trace": res["v_trace"], "v_final": res["state"].v,
            "active_adds": adds, "input_spikes": spikes,
            "first_spike_t": first_t, "prng_state": prng_next,
            "v_peak": v_peak, "telemetry": telemetry}


def _fused_encode_lif(w_q: torch.Tensor, pixels_u8: torch.Tensor,
                      prng_state: torch.Tensor, cfg: SNNConfig):
    """One loop over the window, each step the PRNG step, spike compare,
    Σ W·S and LIF update of :func:`encode_lif_timestep`: the same integers
    as the unfused scans.  With ``cfg.emit_trace`` off only the output
    spikes are kept, and the trace, adds and input spikes are None.
    Returns ``(res, prng_state)``, ``res`` shaped as ``lif.run_lif_int``'s
    plus ``input_spikes``."""
    state = lif.init_state_int(tuple(pixels_u8.shape[:-1])
                               + (int(w_q.shape[-1]),), cfg.lif,
                               device=pixels_u8.device)
    rng = prng_state
    fired_l, vtr, adds, s_all = [], [], [], []
    for _ in range(cfg.num_steps):
        n_en = state.enable.sum(-1, dtype=torch.int32)
        rng, state, fired, s_t = encode_lif_timestep(
            rng, pixels_u8, state, w_q, cfg.lif, dot_impl=cfg.dot_impl,
            active_pruning=cfg.active_pruning)
        fired_l.append(fired)
        if cfg.emit_trace:
            vtr.append(state.v)
            adds.append(s_t.sum(-1, dtype=torch.int32) * n_en)
            s_all.append(s_t)
    res = {"spikes": torch.stack(fired_l), "state": state, "v_trace": None,
           "active_adds": None, "input_spikes": None}
    if cfg.emit_trace:
        res.update(v_trace=torch.stack(vtr), active_adds=torch.stack(adds),
                   input_spikes=torch.stack(s_all))
    return res, rng


def encode_lif_timestep(rng: torch.Tensor, pixels_u8: torch.Tensor,
                        state: lif.LIFStateInt, w_q: torch.Tensor,
                        lif_cfg: lif.LIFConfig, *, dot_impl: str = "int32",
                        active_pruning: bool = False):
    """One encoder+LIF timestep: PRNG step → spike compare → Σ W·S →
    integrate/leak/fire/reset → pruning gate.

    Returns ``(rng, new_state, fired, input_spikes)``.
    """
    rng = prng.xorshift32_step(rng)
    s_t = pixels_u8 > prng.uniform_u8(rng)
    current = lif.synaptic_current_int(s_t, w_q, dot_impl)
    current = torch.where(state.enable, current, 0)
    new_state, fired = lif.lif_step_int(state, current, lif_cfg)
    if active_pruning:
        new_state = new_state._replace(enable=new_state.enable & ~fired)
    return rng, new_state, fired, s_t


class ModelGroup(NamedTuple):
    """A model axis over processes: this rank's torch ``DeviceMesh``, the
    model axis' name on it, and each layer's shard count
    (``kernels.fused_snn.layer_shard_ways``)."""

    mesh: object
    axis: str
    ways: tuple

    @property
    def rank(self) -> int:
        """This process's model peer."""
        return mesh_rank(self.mesh, self.axis)


def snn_int_stack_step(rng: torch.Tensor, pixels_u8: torch.Tensor,
                       states: tuple, weights: tuple,
                       lif_cfg: lif.LIFConfig, *, dot_impl: str = "int32",
                       active_pruning: bool = False,
                       sparse_skip: bool | None = None):
    """One timestep through the whole layer stack: the one-shard case of
    :func:`snn_int_stack_step_sharded` with the plain contraction.

    Returns ``(rng, new_states, fired_out, adds, tel)``: ``adds`` the
    executed-add count summed over layers, ``tel`` this step's telemetry
    row — ``n_spk``/``n_en`` (L, B) int32 and ``tiles`` (L, n_blocks).
    """
    return snn_int_stack_step_sharded(
        rng, pixels_u8, states, tuple((w,) for w in weights), lif_cfg,
        model_shards=1, dot_impl=dot_impl, active_pruning=active_pruning,
        sparse_skip=sparse_skip)


def snn_int_stack_step_sharded(rng: torch.Tensor, pixels_u8: torch.Tensor,
                               states: tuple, weights: tuple,
                               lif_cfg: lif.LIFConfig, *, model_shards: int,
                               dot_impl: str = "int32",
                               active_pruning: bool = False,
                               sparse_skip: bool | None = None,
                               contraction: str = "plain",
                               model_group: ModelGroup | None = None):
    """One timestep through the whole layer stack on a ``model_shards``-way
    model axis (1 = no model axis, :func:`snn_int_stack_step`).

    Layer state, pixels and PRNG lanes arrive full, on the data shard's
    device.  ``weights[l]`` is a tuple of the layer's per-peer weight
    shards in peer order: the LANE-padded output-column shards of a layer
    that splits (``kernels.fused_snn.layer_shard_ways``), each on its
    peer's device, or one whole matrix for a layer that replicates; on a
    model axis each is the int8 planes of ``kernels.fused_snn.
    pack_weights`` (``serve.shard_weights``), else int16 codes.  Per
    sharded layer each peer takes its membrane and enable columns, runs
    the partial Σ W·S of the full input-spike vector against its shard
    (``contraction="kernel"`` launches ``kernels.ops.
    partial_contraction_op``, ``"plain"`` the reference integer dot and
    ``layer_tile_skips``, the same integers), steps LIF on the shard, and
    the shards' fired spikes and membranes concatenate back to full (the
    spike exchange; a peer copy where peers sit on other devices).  A
    replicated layer runs once, since every peer would compute it alike.
    Counts, pruning and the telemetry run on the full arrays, so all of it
    equals the one-shard step.

    With ``model_group`` the model axis runs over processes, one rank per
    peer, as JAX's ``shard_map`` body runs: ``weights[l]`` is this rank's
    own tensor (its column shard, or the whole matrix of a layer that
    replicates, ``model_group.ways[l] == 1``); the rank slices its
    membrane and enable columns at ``model_rank · n_shard``, contracts
    and steps LIF on them, and ``distributed.sharding.exchange`` gathers
    the fired spikes and membranes over the group (two collectives a
    layer that splits).  A replicated layer runs on every rank.  The
    tile rows are gathered once a step over the group, model-inner.

    Returns ``(rng, new_states, fired_out, adds, tel)`` as
    :func:`snn_int_stack_step` does; ``tel["tiles"]`` is
    (L, model_shards · n_blocks): each peer's own skipped tile pairs,
    model-inner, a replicated layer's listed once per peer
    (``core.telemetry.model_tile_skips``).
    """
    ss = resolve_sparse_skip(sparse_skip)
    home = pixels_u8.device
    rng = prng.xorshift32_step(rng)
    x = pixels_u8 > prng.uniform_u8(rng)

    def contract(spikes, en, w):
        if contraction == "kernel":
            return ops.partial_contraction_op(spikes, en, w, sparse_skip=ss)
        if contraction != "plain":
            raise ValueError(f"unknown contraction {contraction!r}")
        if w.dtype == torch.int8:              # a placed shard's planes
            w = fused_snn.unpack_weights(w)
        w = w[:spikes.shape[-1], :en.shape[-1]]
        return (lif.synaptic_current_int(spikes, w, dot_impl),
                layer_tile_skips(spikes, en, sparse_skip=ss))

    n_spk, n_en, tiles, new_states = [], [], [], []
    adds = torch.zeros(pixels_u8.shape[:-1], dtype=torch.int32, device=home)
    for st, shards in zip(states, weights):
        n_spk.append(x.sum(-1, dtype=torch.int32))
        n_en.append(st.enable.sum(-1, dtype=torch.int32))
        adds = adds + n_spk[-1] * n_en[-1]
        if model_group is not None:
            new_st, fired, skipped = _layer_on_rank(
                x, st, shards, model_group, len(n_spk) - 1, contract,
                lif_cfg)
            tiles.append(skipped)
        elif len(shards) == 1:
            current, skipped = contract(x, st.enable, shards[0])
            tiles.append(model_tile_skips([skipped], model_shards))
            current = torch.where(st.enable, current, 0)
            new_st, fired = lif.lif_step_int(st, current, lif_cfg)
        else:
            n_sh = st.v.shape[-1] // len(shards)
            v_parts, fired_parts, skips = [], [], []
            for m, w_m in enumerate(shards):
                peer = w_m.device
                cols = slice(m * n_sh, (m + 1) * n_sh)
                en_sh = st.enable[:, cols].to(peer)
                cur_sh, skipped = contract(x.to(peer), en_sh, w_m)
                cur_sh = torch.where(en_sh, cur_sh, 0)
                new_sh, fired_sh = lif.lif_step_int(
                    lif.LIFStateInt(v=st.v[:, cols].to(peer), enable=en_sh),
                    cur_sh, lif_cfg)
                v_parts.append(new_sh.v.to(home))
                fired_parts.append(fired_sh.to(home))
                skips.append(skipped.to(home))
            tiles.append(model_tile_skips(skips, model_shards))
            fired = torch.cat(fired_parts, dim=-1)
            new_st = lif.LIFStateInt(v=torch.cat(v_parts, dim=-1),
                                     enable=st.enable)
        if active_pruning:
            new_st = new_st._replace(enable=new_st.enable & ~fired)
        new_states.append(new_st)
        x = fired
    tiles = torch.stack(tiles)
    if model_group is not None:
        tiles = exchange(tiles, model_group.mesh, model_group.axis)
    tel = {"n_spk": torch.stack(n_spk), "n_en": torch.stack(n_en),
           "tiles": tiles}
    return rng, tuple(new_states), x, adds, tel


def _layer_on_rank(x, st, w, group: ModelGroup, layer: int, contract,
                   lif_cfg):
    """One layer on this rank of a model axis over processes: the body of
    JAX's sharded step.  Returns ``(new_state, fired, skipped)``, the
    state and spikes full, ``skipped`` this rank's own tile counts."""
    ways = group.ways[layer]
    if ways == 1:
        current, skipped = contract(x, st.enable, w)
        current = torch.where(st.enable, current, 0)
        new_st, fired = lif.lif_step_int(st, current, lif_cfg)
        return new_st, fired, skipped
    n_sh = st.v.shape[-1] // ways
    cols = slice(group.rank * n_sh, (group.rank + 1) * n_sh)
    en_sh = st.enable[:, cols]
    cur_sh, skipped = contract(x, en_sh, w)
    cur_sh = torch.where(en_sh, cur_sh, 0)
    new_sh, fired_sh = lif.lif_step_int(
        lif.LIFStateInt(v=st.v[:, cols], enable=en_sh), cur_sh, lif_cfg)
    # the spike exchange: every peer recovers the full membrane row and
    # fired vector (the next layer's input), shards in rank order
    v = exchange(new_sh.v, group.mesh, group.axis)
    fired = exchange(fired_sh, group.mesh, group.axis)
    return lif.LIFStateInt(v=v, enable=st.enable), fired, skipped


class SNNWindowState(NamedTuple):
    """Resumable mid-window state of the integer engine."""

    rng: torch.Tensor       # (B, n_in) uint32 xorshift lanes
    v: tuple                # per-layer (B, n_l) int32 membranes
    en: tuple               # per-layer (B, n_l) bool clock gates
    v_peak: tuple           # per-layer (B, n_l) int32 running peaks
    counts: torch.Tensor    # (B, n_out) int32 spike registers
    first: torch.Tensor     # (B, n_out) int32, sentinel = cfg.num_steps
    steps: torch.Tensor     # (B,) int32 window steps executed


def snn_window_init(params_q: dict, prng_state: torch.Tensor,
                    cfg: SNNConfig) -> SNNWindowState:
    """Fresh start-of-window state for a batch of ``prng_state.shape[0]``."""
    batch = prng_state.shape[0]
    dev = prng_state.device
    sizes = _param_sizes(params_q)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return SNNWindowState(
        rng=prng_state,
        v=tuple(full((batch, n), cfg.lif.v_rest) for n in sizes[1:]),
        en=tuple(full((batch, n), True, torch.bool) for n in sizes[1:]),
        v_peak=tuple(full((batch, n), V_PEAK_INIT) for n in sizes[1:]),
        counts=full((batch, sizes[-1]), 0),
        first=full((batch, sizes[-1]), cfg.num_steps),
        steps=full((batch,), 0),
    )


def snn_window_chunk(params_q: dict, pixels_u8: torch.Tensor,
                     state: SNNWindowState, cfg: SNNConfig, *,
                     chunk_steps: int, backend: str | None = None):
    """Advance the window by ``chunk_steps`` steps with carried state.

    Returns ``(new_state, chunk)`` where ``chunk`` holds this segment's
    ``v_trace`` (chunk, B, n_out), ``active_adds`` (chunk, B) and
    ``telemetry``; concatenated over any split of the window they equal the
    one-shot record, on every backend that can resume.  The staged kernels
    cannot: ``staged`` raises whether it is named or ``auto`` reaches it.
    """
    weights = tuple(layer["w_q"] for layer in params_q["layers"])
    requested = backend if backend is not None else cfg.backend
    refusal = ("chunked window execution supports the 'fused', "
               "'fused_streamed' and 'reference' backends only (the staged "
               "kernels cannot resume mid-window)")
    if requested == "staged":
        raise ValueError(refusal)
    b = resolve_backend(cfg, backend, len(weights),
                        layer_sizes=_param_sizes(params_q),
                        local_batch=pixels_u8.shape[0],
                        device=pixels_u8.device)
    if b == "staged":
        raise ValueError(f"{refusal}; backend='auto' resolved to 'staged' "
                         f"because no stack kernel holds this stack — pass "
                         f"backend='reference' to run it in plain PyTorch")
    if b in ("fused", "fused_streamed"):
        ops.validate_weight_codes(weights)
        k = ops.fused_snn_stack_op(
            pixels_u8, state.rng, weights, num_steps=cfg.num_steps,
            chunk_steps=chunk_steps, sparse_skip=cfg.sparse_skip,
            streamed=b == "fused_streamed",
            init={"v": state.v, "en": state.en, "v_peak": state.v_peak,
                  "counts": state.counts, "first": state.first,
                  "steps": state.steps},
            **_lif_kw(cfg))
        new_state = SNNWindowState(
            rng=k["prng_state"], v=k["v"], en=k["en"], v_peak=k["v_peak"],
            counts=k["spike_counts"], first=k["first_spike_t"],
            steps=k["steps"])
        return new_state, {"v_trace": k["v_trace"],
                           "active_adds": k["active_adds"],
                           "telemetry": k["telemetry"]}

    st = state
    vtr, adds, tspk, ten, ttile = [], [], [], [], []
    for _ in range(chunk_steps):
        layer_states = tuple(lif.LIFStateInt(v=v, enable=e)
                             for v, e in zip(st.v, st.en))
        rng, new_states, fired, adds_t, tel = snn_int_stack_step(
            st.rng, pixels_u8, layer_states, weights, cfg.lif,
            dot_impl=cfg.dot_impl, active_pruning=cfg.active_pruning,
            sparse_skip=cfg.sparse_skip)
        first = torch.where(fired & (st.first == cfg.num_steps),
                            st.steps[:, None], st.first)
        st = SNNWindowState(
            rng=rng, v=tuple(s.v for s in new_states),
            en=tuple(s.enable for s in new_states),
            v_peak=tuple(torch.maximum(p, s.v)
                         for p, s in zip(st.v_peak, new_states)),
            counts=st.counts + fired.to(torch.int32), first=first,
            steps=st.steps + 1)
        vtr.append(new_states[-1].v)
        adds.append(adds_t)
        tspk.append(tel["n_spk"])
        ten.append(tel["n_en"])
        ttile.append(tel["tiles"])
    return st, {"v_trace": torch.stack(vtr), "active_adds": torch.stack(adds),
                "telemetry": ChunkTelemetry(n_spk=torch.stack(tspk),
                                            n_en=torch.stack(ten),
                                            tiles_skipped=torch.stack(ttile))}
