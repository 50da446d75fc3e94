#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. device — a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build — compiles every kernel source under
   ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a (one nvcc per
   source, all at once) and prints each build's time and ptxas' register /
   shared-memory / spill report.
3. kernels vs plain — every kernel against its plain PyTorch version on
   the same operands on the card, integer-equal on every output:
   K1, the resident encode→LIF stack kernel (two warps a lane, each
   thread's PRNG words and pixels in registers, spike lists in shared
   memory, operands at their real widths), and K2, the weight-streaming
   one (Σ W·S on the int8 tensor cores over the weights' two planes, 64
   lanes per thread-block cluster, padded operands), in 16 cases each
   (counts, trace, first-spike latch, adds, PRNG state, per-layer v / en /
   v_peak, steps, gate and the three telemetry leaves; gated and ungated,
   one 20-step launch and 5 chunks of 4, sparse_skip on and off; K1 on
   the paper config, the pruned first-spike config, the deep stack and a
   membrane-readout variant, K2 on the wide stack with two readouts, the
   deep stack and the membrane variant); K1 in 13 more (``K1_CASES``,
   shared with the card tests: k0 of 100, 64, 208, 1,040 and 3,072,
   layers of 37, 130 and 300 columns, heads of 10 and 7, 1,021, 200 and
   24 lanes, frozen 8-lane blocks with sparse_skip on, 784→1664→10 and
   784→2176→10, codes in ±2,000); K2 on planes placed once in 16 more
   (``K2_CASES``, shared with the card tests: 1,021 and 24 lanes, one
   to four layers, codes at -256 and 255 in every column, dead 128-column
   enable tiles in every other 8-lane block, pruning on, stacks of 4,096
   and 7,168 columns too wide for the kernel's v / v_peak stages, gated
   and ungated), and K2 == K1 on the deep stack; K4, the encoder kernel;
   K5, the LIF kernel (each step's Σ W·S on the int8 tensor cores, the
   LIF update in its epilogue, K split over a cluster for narrow layers),
   in 13 cases (``K5_CASES``, shared with the card tests: spike bytes of
   0, 1, 2 and 255 first, counted by value; int16 extremes in every
   column; 1,021, 1,000 and 24 lanes; K = 784, 64, 2,048 and 16,384; N =
   10 padded to 128; T = 1 and 20; pruning; K splits of 1, 4 and 8 as the
   kernel picks them; a sum past 2^31 that wraps), then on the wide stack's shapes (pruning on and
   off, int16 codes beyond the 9-bit range); the staged backend (K4 + one
   K5 per layer) equal to the reference backend on the wide stack, and
   once more under ``torch.profiler`` for K5's own device time over its
   three launches; ``auto`` resolving to the staged kernels for a stack
   no stack kernel holds.
   K3, the partial contraction of one model shard on its packed int8
   planes, in 24 cases (the wide stack's shard shapes 784→512 and
   2048→512, its replicated head 2048→10 and the 784→5 head shard of a
   2-way axis, plus 4096-deep shards; 1,021 lanes padded to 1,024, and
   1,000 and 24 lanes, which are not multiples of the kernel's 64-lane
   tile; input densities 0, ~6%, ~14% and 100%; enables all on, 80%
   random, and dead 128-column tiles in every other 8-lane block; codes
   random or at -256 and 255 in every column; sparse_skip on and off),
   current and skipped counts integer-equal; K6, the spike matmul on the
   int8 tensor cores, masked, dot and auto on both sides of the density
   threshold in 12 cases (``K6_CASES``: (1,024, 2048→2048) at 5.8% and
   10.4% density, (1,021, 784→10), 1,000 and 24 lanes, K = 4,096,
   densities 0, 0.1% and 100%, signed 9-bit codes, codes over all of
   int16 and every column holding -32768 and 32767, spike bytes 0/1 and
   0/1/2/255), outputs and telemetry equal.
4. serve — ``SNNStreamEngine`` with ``backend=None`` serves 4,096 seeded
   images twice: the paper's 784→10 classifier through K1, and the wide
   784→2048→2048→10 stack through K2 (batch 1024, chunk 4, patience 2,
   seeded random weight codes).  Every launch of each main path is
   counted, the results must equal the reference backend's on the card id
   for id, and the wide stack's hidden layers must spike at 1–50%; each
   serve runs once more under ``torch.profiler``: the 784→10 one for K1's
   device time and the other kernels' (the glue) and copies' per chunk,
   the wide one for K2's own device time over its launches and the grid
   it launched.  Then
   ``ShardedSNNStreamEngine`` serves the same 4,096 wide-stack requests on
   a 1×4 (data × model) mesh of the one card through K3 alone (no K1 or
   K2 launch), with results equal to the K2 run's id for id; it is served
   again with speculative dispatch off, on, on and off, and once more
   under ``torch.profiler`` for the device busy share of that run's wall
   time; a 2×2 mesh serves 1,024 of
   them and a 1×2 mesh serves the 784→10 requests (its head sharded
   5 + 5), each equal to the single-device run.  The K6 path routes a
   wide hidden layer's 20-step spike train through ``spike_matmul_op``'s
   density dispatch.
   Then the serving tier and the fault harness (``serve.faults``), each
   run's results equal to the single-device serves' id for id:
   ``SNNServingTier`` of 2 engines × 1,024 lanes serves the 4,096 784→10
   requests under one ``FaultPlan``: dispatch faults on engine 0 walk its
   ladder down (K1 → K2 → the plain ``reference`` rung) and clean chunks
   walk it back up to K1, one corrupted telemetry record is dropped, a
   poison request is quarantined with its replay seed, and engine 1 hangs
   mid-window until the watchdog fails it and its lanes evacuate onto
   engine 0; the same tier serves once more with no plan.  A data-sharded
   tier (2 engines × 2 data shards of the card) loses engine 1 mid-window
   and evacuates it.  ``ShardedSNNStreamEngine`` on the 1×4 mesh serves
   1,024 wide requests under dispatch faults on ``fused``: one demotion
   to ``fused_streamed``, K3 the only kernel on both rungs.
5. times — each kernel and its plain version at the main path's shapes
   (K1 at ``SNN_CONFIG`` and at ``SNN_CONFIG_DEEP``, with the bytes its
   launch moves and the host time per wrapper call and per
   ``fused_snn_stack_op`` call), with the bound: the larger of the bytes
   the function must move
   (unpadded shapes, each input read once, each output written once) at
   3.35 TB/s and its integer operations at the card's INT32 rate; for K2,
   K3, K5 and K6, whose contraction runs on two int8 weight planes, the
   operations are the shorter of the executed adds at the INT32 rate
   and 2·B·K·N·2 int8 operations at the tensor cores' 1,979 T/s (the
   add-only bound is kept beside it); K5 likewise, at (20, 1,024,
   2048→2048) and at the 16384→10 head (padded to 128 columns).  K2 is
   timed on planes placed once,
   as the engine places them.  For K3 (each wide layer's shard
   shape) and K6 (both realisations) also one ``torch.matmul`` in float32
   (TF32 off) on the same operands, exact here because |Σ| < 2^24; for K5
   one such product of its contraction alone.

The second-to-last lines are the ``{"kernels": [...]}`` record and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import snn_mnist as cfgs  # noqa: E402
from repro_torch.core import snn  # noqa: E402
from repro_torch.core.prng import seed_state  # noqa: E402
from repro_torch.kernels import (_build, fused_snn, lif_step, ops,  # noqa: E402
                                 poisson_encode, spike_matmul)
from repro_torch.serve import (FaultEvent, FaultInjector,  # noqa: E402
                                FaultPlan, FaultToleranceConfig,
                                SNNServingTier, SNNStreamEngine)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM INT32 rate: the data sheet's 67 TFLOP/s float32 counts an FMA as
# two operations on 128 FP32 lanes per SM; an SM has 64 INT32 lanes and an
# add is one operation, so a quarter of it.
INT32_OPS_PER_S = 67e12 / 4
INT8_TC_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor cores (data sheet)
SEED = 0
SERVE_BATCH, SERVE_CHUNK, SERVE_PATIENCE, SERVE_REQUESTS = 1024, 4, 2, 4096
CHECK_BATCH = 1021            # pads to 1024: exercises the batch padding
T_STAGED = 20                 # staged window of the K4 / K5 checks and times
HEAD_WIDTH = 16384            # K5's head shape: 784 -> HEAD_WIDTH -> 10
CSRC = "src/repro_torch/kernels/csrc/"
# the kernels: name, source, the TPU kernel each replaces, its launch counter
KERNELS = {
    "K1": ("fused_snn_stack", CSRC + "fused_snn_stack.cu",
           "src/repro/kernels/fused_snn.py:554", fused_snn.fused_snn_stack),
    "K2": ("fused_snn_stack_streamed", CSRC + "fused_snn_streamed.cu",
           "src/repro/kernels/fused_snn.py:554 (streamed=True, :355-421)",
           fused_snn.fused_snn_stack_streamed),
    "K3": ("partial_contraction", CSRC + "partial_contraction.cu",
           "src/repro/kernels/fused_snn.py:275",
           fused_snn.partial_contraction),
    "K4": ("poisson_encode", CSRC + "poisson_encode.cu",
           "src/repro/kernels/poisson_encode.py:49",
           poisson_encode.poisson_encode),
    "K5": ("lif_forward", CSRC + "lif_step.cu",
           "src/repro/kernels/lif_step.py:70", lif_step.lif_forward),
    "K6": ("spike_matmul", CSRC + "spike_matmul.cu",
           "src/repro/kernels/spike_matmul.py:64", spike_matmul.spike_matmul),
}
MESH_WIDE = (1, 4)            # (data, model) shards of the one card


def reset_counts() -> None:
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, (_, _, _, fn) in KERNELS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    infos = _build.build_all()
    log(f"[build] {len(infos)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s; " + subprocess.run(
            [_build._nvcc(), "--version"], capture_output=True,
            text=True).stdout.strip().splitlines()[-1])
    for name, info in infos.items():
        how = "cached build" if info.cached else f"nvcc {info.seconds:.2f} s"
        log(f"[build] {name}: {how} -> {info.path.relative_to(ROOT)}")
        for line in info.log.splitlines():
            if re.search(r"registers|spill|smem|stack frame|Compiling|"
                         r"Function properties", line):
                log(f"[build]   {line.strip()}")
    for name in _build.SOURCES:
        _build.load_library(name)


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [] if x is None else [x]


def _as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def _max_abs_err(got, want) -> int:
    """Largest |kernel − plain| over every output leaf (integers)."""
    g, w = _flat(got), _flat(want)
    if len(g) != len(w):
        raise AssertionError(f"{len(g)} kernel outputs vs {len(w)} plain")
    err = 0
    for a, b in zip(g, w):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"output {a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, int((_as_i64(a) - _as_i64(b)).abs().max()))
    return err


def _weights(rng, sizes, dev, mean=6.0, std=40.0):
    """Seeded signed 9-bit codes, centred so that neurons fire."""
    return tuple(
        torch.from_numpy(np.clip(np.round(rng.normal(mean, std, (i, o))),
                                 -256, 255).astype(np.int16)).to(dev)
        for i, o in zip(sizes[:-1], sizes[1:]))


def _fan_in_weights(rng, sizes, dev, scale=170.0):
    """Seeded signed 9-bit codes, normal(0, scale / sqrt(fan-in)): at the
    default scale the wide stack's hidden layers spike at roughly 5-15%,
    neither silent nor saturated; with pruning (each neuron fires at most
    once a window) a scale of 350 keeps the output layer spiking."""
    return tuple(
        torch.from_numpy(np.clip(np.round(rng.normal(0.0, scale / np.sqrt(i),
                                                     (i, o))),
                                 -256, 255).astype(np.int16)).to(dev)
        for i, o in zip(sizes[:-1], sizes[1:]))


def _images(rng, n, n_in=784):
    """MNIST-like uint8 images: dark background, ~20% bright strokes."""
    px = np.zeros((n, n_in), np.uint8)
    on = rng.random((n, n_in)) < 0.2
    px[on] = rng.integers(96, 256, int(on.sum()), dtype=np.uint8)
    return px


def _lif_kw(cfg, readout, sparse_skip, patience=SERVE_PATIENCE):
    c = cfg.lif
    return dict(window_steps=cfg.num_steps, decay_shift=c.decay_shift,
                v_threshold=c.v_threshold, v_rest=c.v_rest, v_min=c.v_min,
                v_max=c.v_max, active_pruning=cfg.active_pruning,
                patience=patience, readout=readout, sparse_skip=sparse_skip)


def _run_window(cfg, px, st, ws, kw, gate, chunk, compare,
                kernel=fused_snn.fused_snn_stack):
    """Run the whole window in ``chunk``-step launches of a stack kernel,
    holding each launch against the plain version when ``compare``.
    Returns (op-level results per launch, max abs error)."""
    init, results, err = None, [], 0
    streamed = kernel is fused_snn.fused_snn_stack_streamed
    for _ in range(cfg.num_steps // chunk):
        args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                        v_rest=cfg.lif.v_rest, init=init,
                                        gate=gate, streamed=streamed)
        got = kernel(*args, chunk_steps=chunk, block_b=meta["block_b"], **kw)
        torch.cuda.synchronize()
        if compare:
            want = fused_snn.fused_snn_stack_plain(
                *args, chunk_steps=chunk, block_b=meta["block_b"], **kw)
            torch.cuda.synchronize()
            e = _max_abs_err(got, want)
            if e:
                raise AssertionError(f"kernel != plain (max |err| {e})")
            err = max(err, e)
        res = ops.stack_results(got, meta)
        results.append(res)
        st = res["prng_state"]
        init = {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
                "counts": res["spike_counts"], "first": res["first_spike_t"],
                "steps": res["steps"]}
        gate = res.get("gate")
    return results, err


def _same_window(one, chunks) -> None:
    """k chunks == one launch on every carried leaf and per-step record."""
    last, first = chunks[-1], one[0]
    for key in ("spike_counts", "first_spike_t", "v_final", "prng_state",
                "steps", "v", "en", "v_peak"):
        if _max_abs_err(last[key], first[key]):
            raise AssertionError(f"chunked != one-shot on {key}")
    for key in ("v_trace", "active_adds"):
        cat = torch.cat([c[key] for c in chunks])
        if _max_abs_err(cat, first[key]):
            raise AssertionError(f"chunked != one-shot on {key}")
    for f in ("n_spk", "n_en", "tiles_skipped"):
        cat = torch.cat([getattr(c["telemetry"], f) for c in chunks])
        if _max_abs_err(cat, getattr(first["telemetry"], f)):
            raise AssertionError(f"chunked != one-shot on telemetry.{f}")
    if "gate" in first and any(
            _max_abs_err(last["gate"][k], first["gate"][k])
            for k in ("active", "prev", "streak")):
        raise AssertionError("chunked != one-shot on the gate")


def _gate(batch, dev, frozen="some"):
    """Fresh gate state with lanes frozen from t=0: every 13th lane
    (``"some"``), none (``"none"``), or (``"blocks"``) every 13th lane and
    every lane of each third 8-lane block, whose would-be spikes and
    enables still set its block's tile flags."""
    act = torch.ones(batch, dtype=torch.bool, device=dev)
    if frozen != "none":
        act[::13] = False
    if frozen == "blocks":
        act[(torch.arange(batch, device=dev) // 8) % 3 == 1] = False
    return {"active": act,
            "prev": torch.full((batch,), -1, dtype=torch.int32, device=dev),
            "streak": torch.zeros(batch, dtype=torch.int32, device=dev)}


def _stack_cases(dev, tag, kernel, cases) -> tuple[int, int]:
    """16 cases of one stack kernel against the plain version: each
    (config, readout, pruning, weights) gated and ungated, sparse_skip on
    and off, one 20-step launch and 5 chunks of 4."""
    rng = np.random.default_rng(SEED)
    n_cases, err = 0, 0
    t0 = time.perf_counter()
    for name, readout, prune, weights in cases:
        cfg = dataclasses.replace(getattr(cfgs, name), readout=readout,
                                  active_pruning=prune)
        ws = weights(rng, cfg.layer_sizes, dev)
        px = torch.from_numpy(_images(rng, CHECK_BATCH)).to(dev)
        st = seed_state(SEED + n_cases, (CHECK_BATCH, cfg.n_in), device=dev)
        for gated in (False, True):
            for sparse_skip in (True, False):
                gate = _gate(CHECK_BATCH, dev) if gated else None
                kw = _lif_kw(cfg, readout, sparse_skip)
                one, e1 = _run_window(cfg, px, st, ws, kw, gate,
                                      cfg.num_steps, True, kernel)
                chunks, e2 = _run_window(cfg, px, st, ws, kw, gate, 4,
                                         True, kernel)
                _same_window(one, chunks)
                spikes = int(one[0]["spike_counts"].sum())
                if spikes == 0:
                    raise AssertionError(f"{name}: no output spikes")
                err = max(err, e1, e2)
                n_cases += 1
                log(f"[{tag}-vs-plain] {name:18s} readout={readout:11s} "
                    f"prune={prune!s:5s} gated={gated!s:5s} "
                    f"sparse_skip={sparse_skip!s:5s} B={CHECK_BATCH} T=20 "
                    f"one-shot + 5x4: equal (output spikes {spikes})")
    log(f"[{tag}-vs-plain] {n_cases} cases, every output integer-equal, "
        f"{time.perf_counter() - t0:.2f} s")
    return n_cases, err


def phase_kernel_vs_plain(dev) -> tuple[int, int]:
    n_cases, err = _stack_cases(dev, "K1", fused_snn.fused_snn_stack, [
        ("SNN_CONFIG", "count", False, _weights),
        ("SNN_CONFIG_PRUNED", "first_spike", True, _weights),
        ("SNN_CONFIG_DEEP", "count", False, _weights),
        ("SNN_CONFIG", "membrane", False, _weights)])
    t0 = time.perf_counter()
    for i, case in enumerate(K1_CASES):
        k1_edge_case(dev, case, SEED + 50 + i)
        n_cases += 1
    log(f"[K1-vs-plain] {len(K1_CASES)} edge cases equal, "
        f"{time.perf_counter() - t0:.2f} s")
    return n_cases, err


# (widths, lanes, readout, pruning, gate, sparse_skip) for K1 at the
# operands' real widths: k0 of 100 (padded to 112 by the op), 64, 208,
# 1,040 and 3,072 (one, two and three register slots of 16 pixels per
# thread); layers of 37, 130 and 300 columns (masked column tails, 1 to 3
# tiles); 1,021, 200 and 24 lanes (a ragged last 8-lane block); frozen
# lanes with sparse_skip on ("blocks": every 13th lane and each third
# 8-lane block frozen from t=0); the widest one-hidden-layer stack the
# earlier shared-memory layout held (784 -> 1664 -> 10) and the widest
# this one holds (784 -> 2176 -> 10); codes outside the 9-bit range (a
# seventh field, the codes' bound); and a head of 7 columns.
# tests/test_torch_kernels_cuda.py runs the same cases.
K1_CASES = [
    ((100, 37, 10), CHECK_BATCH, "count", False, "blocks", True),
    ((784, 130, 10), 24, "first_spike", True, "some", True),
    ((784, 130, 10), 24, "count", False, None, False),
    ((784, 300, 64, 10), CHECK_BATCH, "membrane", False, "blocks", True),
    ((64, 10), CHECK_BATCH, "count", False, "none", True),
    ((784, 10), 24, "count", False, "blocks", True),
    ((1040, 64, 10), 24, "first_spike", True, "some", True),
    ((3072, 10), CHECK_BATCH, "count", False, "blocks", True),
    ((784, 1664, 10), CHECK_BATCH, "count", False, "blocks", True),
    ((784, 2176, 10), 24, "membrane", False, "some", False),
    ((784, 10), 200, "first_spike", False, "some", True, 2000),
    ((784, 64, 10), 24, "count", True, "blocks", True, 2000),
    ((208, 7), CHECK_BATCH, "count", False, "some", True),
]


def k1_edge_case(dev, case, seed) -> int:
    """K1 against its plain version on the same real-width operands in one
    ``K1_CASES`` case: one 20-step launch and five chunks of 4, each launch
    equal to the plain version and counted once, the chunks equal to the
    one launch.  Returns the output spikes of the window."""
    sizes, b, readout, prune, frozen, sparse_skip = case[:6]
    bound = case[6] if len(case) > 6 else 256
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(cfgs.SNN_CONFIG, layer_sizes=sizes,
                              readout=readout, active_pruning=prune)
    ws = tuple(
        torch.from_numpy(np.clip(np.round(rng.normal(
            0.0, 350.0 * bound / 256 / np.sqrt(i), (i, o))), -bound,
            bound - 1).astype(np.int16)).to(dev)
        for i, o in zip(sizes[:-1], sizes[1:]))
    px = torch.from_numpy(_images(rng, b, sizes[0])).to(dev)
    st = seed_state(seed, (b, sizes[0]), device=dev)
    gate = None if frozen is None else _gate(b, dev, frozen)
    kw = _lif_kw(cfg, readout, sparse_skip)
    before = fused_snn.fused_snn_stack.launches
    one, _ = _run_window(cfg, px, st, ws, kw, gate, cfg.num_steps, True)
    chunks, _ = _run_window(cfg, px, st, ws, kw, gate, 4, True)
    if fused_snn.fused_snn_stack.launches != before + 6:
        raise AssertionError("K1 did not count one launch per call")
    _same_window(one, chunks)
    spikes = int(one[0]["spike_counts"].sum())
    if spikes == 0:
        raise AssertionError(f"K1 case {case}: no output spikes")
    log(f"[K1-vs-plain] B={b} {'->'.join(map(str, sizes))} "
        f"readout={readout:11s} prune={prune!s:5s} frozen={frozen!s:6s} "
        f"sparse_skip={sparse_skip!s:5s} codes in [{-bound}, {bound - 1}] "
        f"T=20 one-shot + 5x4: equal (output spikes {spikes})")
    return spikes


def phase_streamed_vs_plain(dev) -> tuple[int, int]:
    n_cases, err = _stack_cases(dev, "K2", fused_snn.fused_snn_stack_streamed, [
        ("SNN_CONFIG_WIDE", "count", False, _fan_in_weights),
        ("SNN_CONFIG_WIDE", "first_spike", True,
         functools.partial(_fan_in_weights, scale=350.0)),
        ("SNN_CONFIG_DEEP", "count", False, _weights),
        ("SNN_CONFIG", "membrane", False, _weights)])
    for case in K2_CASES:
        for gated in (True, False):
            k2_edge_case(dev, case, gated, SEED + 29 + n_cases)
            n_cases += 1
    # where both stack kernels run, K2 == K1 output for output
    rng = np.random.default_rng(SEED + 7)
    cfg = cfgs.SNN_CONFIG_DEEP
    ws = _weights(rng, cfg.layer_sizes, dev)
    px = torch.from_numpy(_images(rng, CHECK_BATCH)).to(dev)
    st = seed_state(SEED + 7, (CHECK_BATCH, cfg.n_in), device=dev)
    for gated in (False, True):
        gate = _gate(CHECK_BATCH, dev) if gated else None
        args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                        gate=gate)
        planes, _ = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                       gate=gate, streamed=True)
        kw = dict(_lif_kw(cfg, cfg.readout, True), chunk_steps=cfg.num_steps,
                  block_b=meta["block_b"])
        k1 = ops.stack_results(fused_snn.fused_snn_stack(*args, **kw), meta)
        k2 = ops.stack_results(
            fused_snn.fused_snn_stack_streamed(*planes, **kw), meta)
        torch.cuda.synchronize()
        e = _max_abs_err(*([tuple(v.values()) if isinstance(v, dict) else v
                            for v in r.values()] for r in (k2, k1)))
        if e:
            raise AssertionError(f"K2 != K1 on SNN_CONFIG_DEEP (max |err| {e})")
    log("[K2-vs-K1] SNN_CONFIG_DEEP gated and ungated, T=20: every output "
        "equal")
    return n_cases, err


# (lanes, widths, codes, enables, pruning) for K2 on placed planes:
# 1,021 and 24 lanes are not multiples of its 64-lane cluster; "extremes"
# puts -256 and 255 in every column, "dead" kills whole 128-column enable
# tiles in every other 8-lane block; one to four layers; the last two
# stacks are too wide for the kernel's v / v_peak stages, so its epilogue
# reads them from device memory.  tests/test_torch_kernels_cuda.py runs
# the same cases.
K2_CASES = [
    (CHECK_BATCH, (784, 2048, 2048, 10), "extremes", "dead", False),
    (24, (784, 2048, 2048, 10), "fan-in", "dead", True),
    (CHECK_BATCH, (784, 10), "random", "all", False),
    (24, (784, 128, 10), "extremes", "dead", True),
    (CHECK_BATCH, (784, 128, 64, 10), "fan-in", "dead", False),
    (200, (784, 512, 256, 128, 10), "fan-in", "all", True),
    (200, (784, 4096, 4096, 10), "fan-in", "dead", False),
    (24, (784, 7168, 10), "extremes", "all", True),
]


def k2_edge_case(dev, case, gated, seed) -> int:
    """K2 on planes placed once against the plain version on the codes in
    one ``K2_CASES`` case: two 4-step chunks of an 8-step window from a
    carried state with the case's enables, every output equal and one
    launch per chunk.  Returns the output spikes over both chunks."""
    b, sizes, kind, enables, prune = case
    rng = np.random.default_rng(seed)
    ws = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = (np.round(rng.normal(0, 350 / np.sqrt(i), (i, o)))
             if kind == "fan-in" else rng.integers(-256, 256, (i, o)))
        w = np.clip(w, -256, 255).astype(np.int16)
        if kind == "extremes":
            w[0::3], w[1::3] = -256, 255
        ws.append(torch.from_numpy(w).to(dev))
    codes = tuple(ops._pad2(w, fused_snn.LANE, fused_snn.LANE) for w in ws)
    planes = ops.stack_weights(ws, sizes[0], streamed=True)[0]
    px = torch.from_numpy(_images(rng, b, sizes[0])).to(dev)
    st = seed_state(seed, (b, sizes[0]), device=dev)
    en = np.ones((b, sum(sizes[1:])), bool)
    if enables == "dead":
        for r in range(0, b, 16):
            for c in range(0, en.shape[1], 256):
                en[r:r + 8, c:c + 128] = False
    en = torch.from_numpy(en).to(dev).split(list(sizes[1:]), dim=1)
    T = 8
    init = {"v": tuple(torch.zeros((b, n), dtype=torch.int32, device=dev)
                       for n in sizes[1:]),
            "en": tuple(e.contiguous() for e in en), "v_peak": None,
            "counts": torch.zeros((b, sizes[-1]), dtype=torch.int32,
                                  device=dev),
            "first": torch.full((b, sizes[-1]), T, dtype=torch.int32,
                                device=dev),
            "steps": torch.zeros(b, dtype=torch.int32, device=dev)}
    gate = _gate(b, dev) if gated else None
    kw = dict(window_steps=T, decay_shift=4, v_threshold=128,
              active_pruning=prune, patience=SERVE_PATIENCE,
              readout="count", sparse_skip=True, chunk_steps=4)
    out_spikes = 0
    for _ in range(T // 4):
        args, meta = ops.stack_operands(px, st, ws, num_steps=T, init=init,
                                        gate=gate, streamed=True)
        args[2] = planes
        before = fused_snn.fused_snn_stack_streamed.launches
        got = fused_snn.fused_snn_stack_streamed(
            *args, block_b=meta["block_b"], **kw)
        torch.cuda.synchronize()
        if fused_snn.fused_snn_stack_streamed.launches != before + 1:
            raise AssertionError("K2 did not count one launch per chunk")
        want = fused_snn.fused_snn_stack_plain(
            *args[:2], codes, *args[3:], block_b=meta["block_b"], **kw)
        e = _max_abs_err(got, want)
        if e:
            raise AssertionError(
                f"K2 != plain on B={b} {sizes} codes {kind} enables "
                f"{enables} prune={prune} gated={gated} (max |err| {e})")
        res = ops.stack_results(got, meta)
        out_spikes += int(res["spike_counts"].sum())
        st = res["prng_state"]
        init = {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
                "counts": res["spike_counts"], "first": res["first_spike_t"],
                "steps": res["steps"]}
        gate = res.get("gate")
    if out_spikes == 0:
        raise AssertionError(f"K2 case B={b} {sizes}: no output spikes")
    log(f"[K2-vs-plain] planes B={b} {'->'.join(map(str, sizes))} "
        f"codes {kind:8s} enables {enables:4s} prune={prune!s:5s} "
        f"gated={gated!s:5s} T={T} 2x4: equal (output spikes summed over "
        f"chunks {out_spikes})")
    return out_spikes


def _spike_bytes(rng, shape, density, kind):
    """uint8 spikes non-zero at about ``density``: of value 1 (``"0/1"``)
    or 1, 2 or 255 (``"0/1/2/255"``, which the kernel counts by value), or
    all ones (``"ones"``).  One byte draw, looked up, so a (20, 1,024,
    16,384) train costs 335 MB of host memory and no more."""
    if kind == "ones":
        return np.ones(shape, np.uint8)
    lut = np.zeros(256, np.uint8)
    on = int(round(density * 256))
    lut[:on] = 1 if kind == "0/1" else np.array([1, 2, 255], np.uint8)[
        np.arange(on) % 3]
    return lut[rng.integers(0, 256, shape, dtype=np.uint8)]


def _lif_codes(rng, K, N, kind):
    """(K, N) int16 codes: uniform signed 9-bit (``"9-bit"``), in [-2000,
    2000] (``"±2000"``), over all of int16 (``"int16"``), over int16 with
    every column holding -32768 and 32767 (``"int16 extremes"``), or
    columns of 32767 and -32768 in turn (``"full-scale"``)."""
    if kind == "full-scale":
        w = np.empty((K, N), np.int16)
        w[:, 0::2], w[:, 1::2] = (1 << 15) - 1, -(1 << 15)
        return w
    lo, hi = {"9-bit": (-256, 256), "±2000": (-2000, 2001)}.get(
        kind, (-(1 << 15), 1 << 15))
    w = rng.integers(lo, hi, (K, N)).astype(np.int16)
    if kind == "int16 extremes":
        w[0::3], w[1::3] = -(1 << 15), (1 << 15) - 1
    return w


# (T, lanes, K, N, spike density, spike bytes, codes, pruning) for K5
# against its plain version on the card, the bytes of 2 and 255 first
# (counted by value, as the JAX kernel's dot counts them).  1,021, 1,000
# and 24 lanes are not multiples of the kernel's 128-lane tile; K = 784,
# 1,552 and 64 are not multiples of its 128-deep K tile; N = 10 pads to
# 128; T = 1 and 20; pruning on.  The kernel picks its K split: 1 for the
# wide layers, and for the 2048 -> 10 head of 8,192 lanes, whose 64
# clusters of 4 an H100 cannot hold at once; 4 for 8 to 15 K tiles over
# at most 16 tiles of 128 x 128 (1536 -> 10, and 1552 -> 256 at 1,000
# lanes, 13 K tiles over 4 slices); 8 for the 2048 -> 10 and 16384 -> 10
# heads and the last case, whose sums pass 2^31 and wrap.
# tests/test_torch_kernels_cuda.py runs the same cases.
K5_CASES = [
    (20, CHECK_BATCH, 784, 2048, 0.104, "0/1/2/255", "int16", False),
    (20, 1024, 2048, 2048, 0.104, "0/1/2/255", "int16 extremes", True),
    (20, 24, 784, 10, 0.104, "0/1/2/255", "int16", True),
    (1, CHECK_BATCH, 64, 10, 0.104, "0/1/2/255", "9-bit", False),
    (4, 1000, 1552, 256, 0.104, "0/1/2/255", "int16 extremes", True),
    (20, 1024, 16384, 10, 0.104, "0/1/2/255", "int16", True),
    (20, 1024, 2048, 2048, 0.104, "0/1", "int16 extremes", False),
    (20, CHECK_BATCH, 2048, 10, 0.104, "0/1", "9-bit", True),
    (2, 8192, 2048, 10, 0.104, "0/1", "9-bit", False),
    (20, 1024, 1536, 10, 0.104, "0/1", "9-bit", False),
    (20, CHECK_BATCH, 16384, 10, 0.104, "0/1/2/255", "int16", True),
    (1, 24, 64, 128, 0.5, "0/1", "9-bit", True),
    (2, 8, 65664, 128, 1.0, "ones", "full-scale", False),
]


def k5_case(dev, case, seed) -> int:
    """K5 against its plain version on the card in one ``K5_CASES`` case,
    through ``ops.lif_forward_op`` (its padding of lanes, K and columns):
    every output equal and one launch.  The wrap case checks that Σ W·S
    wrapped.  Returns the fired spikes."""
    T, B, K, N, dens, spikes, codes, prune = case
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(_spike_bytes(rng, (T, B, K), dens, spikes)).to(dev)
    w = torch.from_numpy(_lif_codes(rng, K, N, codes)).to(dev)
    if codes == "full-scale":       # Σ of 65,664 codes of 32,767 wraps
        kw = dict(decay_shift=30, v_threshold=1 << 30, v_min=-(1 << 31),
                  v_max=(1 << 31) - 1)
    else:
        lif = cfgs.SNN_CONFIG_WIDE.lif
        kw = dict(decay_shift=lif.decay_shift, v_threshold=lif.v_threshold,
                  v_rest=lif.v_rest, v_min=lif.v_min, v_max=lif.v_max)
    kw["active_pruning"] = prune
    before = lif_step.lif_forward.launches
    got = ops.lif_forward_op(s, w, **kw)
    torch.cuda.synchronize()
    if lif_step.lif_forward.launches != before + 1:
        raise AssertionError("K5 did not count one launch")
    e = _max_abs_err(got, lif_step.lif_forward_plain(s, w, **kw))
    if e:
        raise AssertionError(f"K5 != plain on case {case} (max |err| {e})")
    if codes == "full-scale":
        wrapped = (K * 32767 + (1 << 31)) % (1 << 32) - (1 << 31)
        if not (wrapped < 0 and int(got[1][0, 0, 0]) ==
                wrapped - (wrapped >> 30)):
            raise AssertionError("K5's wrap case did not wrap")
    return int(got[0].sum())


def _staged_trace(wide_params, px, st, v_trace) -> dict:
    """The staged wide run once more under ``torch.profiler``: K5's own
    device time over its three launches (the trace's kernel events)."""
    wide = cfgs.SNN_CONFIG_WIDE
    again, k5 = _kernel_trace(
        lambda: snn.snn_apply_int(wide_params, px, st, wide,
                                  backend="staged"), "lif_forward_kernel")
    if k5["launches"] != 3 or _max_abs_err(again["v_trace"], v_trace):
        raise AssertionError(f"the profiled staged run: {k5}")
    log(f"[staged] profiled once more (torch.profiler trace): "
        f"{k5['launches']} K5 kernel events taking {k5['ms']:.3f} ms of "
        f"device time, grids {k5['grids']}; results equal")
    return k5


def phase_staged(dev, wide_params) -> dict:
    """K4 and K5 against their plain versions, the staged backend against
    the reference on the wide stack, and ``auto`` reaching the staged
    kernels."""
    t0 = time.perf_counter()
    for i, case in enumerate(K5_CASES):
        fired = k5_case(dev, case, SEED + 40 + i)
        T, B, K, N, dens, spikes, codes, prune = case
        log(f"[K5-vs-plain] T={T} B={B} {K}->{N} bytes {spikes:9s} density "
            f"{dens} codes {codes:14s} prune={prune!s:5s}: equal ({fired} "
            f"spikes fired)")
    n_k5, err_k5 = len(K5_CASES), 0
    rng = np.random.default_rng(SEED + 3)
    px = torch.from_numpy(_images(rng, CHECK_BATCH)).to(dev)
    st = seed_state(SEED + 3, (CHECK_BATCH, 784), device=dev)
    # K4 at (T, 1,021 lanes, 784) through its op (padding to 1024 x 896)
    spikes, st_k4 = ops.poisson_encode_op(px, st, T_STAGED)
    torch.cuda.synchronize()
    want = poisson_encode.poisson_encode_plain(px, st, T_STAGED)
    err_k4 = _max_abs_err((spikes, st_k4), want)
    if err_k4:
        raise AssertionError(f"K4 != plain (max |err| {err_k4})")
    # its final PRNG state equals K1's after as many steps from the seed
    cfg = cfgs.SNN_CONFIG
    k1 = ops.fused_snn_stack_op(px, st, _weights(rng, cfg.layer_sizes, dev),
                                num_steps=T_STAGED, decay_shift=4,
                                v_threshold=128)
    if _max_abs_err(k1["prng_state"], st_k4):
        raise AssertionError("K4's final PRNG state != K1's")
    log(f"[K4-vs-plain] T={T_STAGED} B={CHECK_BATCH} N=784: spikes and state "
        f"equal; final state equals K1's after {T_STAGED} steps; input "
        f"spike density {float(spikes.float().mean()):.4f}")
    # K5 on both wide hidden layers, pruning on and off, 9-bit codes and
    # codes in [-2000, 2000]
    wide = cfgs.SNN_CONFIG_WIDE
    w_fan = [torch.as_tensor(l["w_q"]).to(dev) for l in wide_params["layers"]]
    w_big = [torch.from_numpy(rng.integers(-2000, 2001, tuple(w.shape))
                              .astype(np.int16)).to(dev) for w in w_fan]
    lif = wide.lif
    for codes, ws in (("9-bit", w_fan), ("[-2000, 2000]", w_big)):
        for prune in (False, True):
            kw = dict(decay_shift=lif.decay_shift, v_threshold=lif.v_threshold,
                      v_rest=lif.v_rest, v_min=lif.v_min, v_max=lif.v_max,
                      active_pruning=prune)
            x, dens = spikes, []
            for l in range(2):                    # the two hidden layers
                got = ops.lif_forward_op(x, ws[l], **kw)
                torch.cuda.synchronize()
                e = _max_abs_err(got, lif_step.lif_forward_plain(x, ws[l],
                                                                 **kw))
                if e:
                    raise AssertionError(f"K5 != plain on hidden layer {l + 1}"
                                         f" ({codes}, prune={prune}): {e}")
                err_k5 = max(err_k5, e)
                n_k5 += 1
                x = got[0]
                dens.append(float(x.float().mean()))
            log(f"[K5-vs-plain] 784->2048->2048 codes {codes:13s} "
                f"prune={prune!s:5s} T={T_STAGED} B={CHECK_BATCH}: equal; "
                f"hidden densities {dens[0]:.4f} {dens[1]:.4f}")
    # the staged backend on the wide stack, on the card, == the reference
    reset_counts()                                # the staged path starts
    got = snn.snn_apply_int(wide_params, px, st, wide, backend="staged")
    torch.cuda.synchronize()
    staged_counts = counts()                      # the staged path ended
    if (staged_counts["K4"], staged_counts["K5"]) != (1, 3):
        raise AssertionError(f"staged run launched {staged_counts}")
    want = snn.snn_apply_int(wide_params, px, st, wide, backend="reference")
    for key in ("pred", "spike_counts", "v_trace", "first_spike_t", "v_final",
                "active_adds", "prng_state", "v_peak", "telemetry"):
        if _max_abs_err(got[key], want[key]):
            raise AssertionError(f"staged != reference on {key}")
    if _max_abs_err(got["input_spikes"], want["input_spikes"].to(torch.uint8)):
        raise AssertionError("staged != reference on input_spikes")
    log(f"[staged] SNN_CONFIG_WIDE B={CHECK_BATCH} T=20: every output equal "
        f"to the reference backend's; launches K4 {staged_counts['K4']}, "
        f"K5 {staged_counts['K5']}")
    k5 = _staged_trace(wide_params, px, st, got["v_trace"])
    # auto on a stack no stack kernel holds (nine layers of 64) is staged
    narrow = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=(64,) * 10)
    p = {"layers": [{"w_q": w} for w in
                    _fan_in_weights(rng, narrow.layer_sizes, dev)]}
    b = snn.resolve_backend(narrow, n_layers=9, device=dev)
    if b != "staged":
        raise AssertionError(f"auto on 9 x 64 resolved to {b!r}")
    before = counts()
    res = snn.snn_apply_int(p, px[:, :64].contiguous(),
                            st[:, :64].contiguous(), narrow)
    torch.cuda.synchronize()
    after = counts()
    if (after["K4"] - before["K4"], after["K5"] - before["K5"]) != (1, 9) \
            or after["K1"] != before["K1"] or after["K2"] != before["K2"]:
        raise AssertionError(f"auto on 9 x 64 launched {before} -> {after}")
    want = snn.snn_apply_int(p, px[:, :64].contiguous(),
                             st[:, :64].contiguous(), narrow,
                             backend="reference")
    if _max_abs_err(res["spike_counts"], want["spike_counts"]):
        raise AssertionError("auto (staged) != reference on 9 x 64")
    log(f"[staged] auto on 9 layers of 64 -> 'staged': K4 +1, K5 +9, equal to "
        f"the reference; {time.perf_counter() - t0:.2f} s")
    return {"K4": {"launches": staged_counts["K4"], "max_abs_err": err_k4,
                   "cases": 1},
            "K5": {"launches": staged_counts["K5"], "max_abs_err": err_k5,
                   "cases": n_k5, "staged_device_ms": k5["ms"],
                   "staged_grids": k5["grids"]}}


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor's rows and columns up to multiples."""
    out = torch.zeros((t.shape[0] + (-t.shape[0]) % rows,
                       t.shape[1] + (-t.shape[1]) % cols), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _k3_operands(rng, B, n_in, n_out, density, en_kind, dev,
                 codes="random"):
    """Padded K3 operands: spikes at ``density``; enables all on, 80%
    random, or dead in whole 128-column tiles of every other 8-lane block;
    codes random in [-256, 255] or (``"extremes"``) with every column
    holding -256 and 255.  Returns ``(x, en, planes, codes)``: the planes
    as the engine places them, the padded int16 codes for the library
    product."""
    x = torch.from_numpy(rng.random((B, n_in)) < density).to(dev)
    if en_kind == "all":
        en = np.ones((B, n_out), bool)
    elif en_kind == "80%":
        en = rng.random((B, n_out)) < 0.8
    else:
        en = rng.random((B, n_out)) < 0.8
        for b in range(0, B, 16):                 # every other 8-lane block
            for c in range(0, n_out, 256):        # every other column tile
                en[b:b + 8, c:c + 128] = False
    w = rng.integers(-256, 256, (n_in, n_out)).astype(np.int16)
    if codes == "extremes":
        w[0::3], w[1::3] = -256, 255
    w = _pad(torch.from_numpy(w).to(dev), fused_snn.LANE, fused_snn.LANE)
    bb, lane = fused_snn.BLOCK_B, fused_snn.LANE
    return (_pad(x.to(torch.uint8), bb, lane),
            _pad(torch.from_numpy(en).to(dev).to(torch.uint8), bb, lane),
            fused_snn.pack_weights(w), w)


# (B, n_in, n_out, input density, enables, sparse_skip, codes); n_out is
# also the shard's n_valid.  B = 1,000 and 24 are not multiples of the
# kernel's 64-lane tile; the dead pattern kills every other 8-lane block,
# one half of each 16-lane MMA fragment.
K3_CASES = [
    (CHECK_BATCH, 784, 512, 0.14, "all", True, "random"),
    (CHECK_BATCH, 784, 512, 0.14, "80%", False, "random"),
    (CHECK_BATCH, 784, 512, 1.0, "dead", True, "random"),
    (CHECK_BATCH, 784, 512, 0.06, "dead", False, "random"),
    (CHECK_BATCH, 2048, 512, 0.06, "all", True, "random"),
    (CHECK_BATCH, 2048, 512, 0.06, "dead", True, "random"),
    (CHECK_BATCH, 2048, 512, 0.14, "80%", False, "random"),
    (CHECK_BATCH, 2048, 512, 0.0, "all", True, "random"),
    (CHECK_BATCH, 2048, 10, 0.06, "all", True, "random"),
    (CHECK_BATCH, 2048, 10, 1.0, "80%", False, "random"),
    (CHECK_BATCH, 2048, 10, 0.14, "dead", True, "random"),
    (CHECK_BATCH, 784, 5, 0.14, "all", True, "random"),
    (CHECK_BATCH, 784, 5, 0.0, "80%", False, "random"),
    (CHECK_BATCH, 784, 5, 1.0, "dead", True, "random"),
    (1000, 2048, 512, 0.10, "dead", True, "random"),
    (1000, 784, 10, 0.14, "80%", True, "random"),
    (24, 2048, 512, 0.14, "dead", True, "random"),
    (24, 784, 5, 0.5, "all", False, "random"),
    (CHECK_BATCH, 4096, 512, 0.10, "dead", True, "random"),
    (CHECK_BATCH, 4096, 256, 0.14, "80%", False, "random"),
    (CHECK_BATCH, 2048, 5, 1.0, "all", True, "extremes"),
    (CHECK_BATCH, 2048, 10, 1.0, "dead", True, "extremes"),
    (CHECK_BATCH, 784, 10, 1.0, "80%", False, "extremes"),
    (CHECK_BATCH, 2048, 512, 1.0, "dead", True, "extremes"),
]


def phase_k3_vs_plain(dev) -> tuple[int, int]:
    """K3 on every case against its plain version on the same padded
    operands, current and skipped counts."""
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    err, skipped_any, dead_zeroed = 0, 0, 0
    for B, n_in, n_out, dens, en_kind, ss, codes in K3_CASES:
        x, en, wp, _ = _k3_operands(rng, B, n_in, n_out, dens, en_kind, dev,
                                    codes)
        got = fused_snn.partial_contraction(x, en, wp, n_valid=n_out,
                                            sparse_skip=ss)
        torch.cuda.synchronize()
        want = fused_snn.partial_contraction_plain(x, en, wp, n_valid=n_out,
                                                   sparse_skip=ss)
        e = _max_abs_err(got, want)
        if e:
            raise AssertionError(f"K3 != plain on B={B} {n_in}->{n_out} "
                                 f"density {dens} enables {en_kind} "
                                 f"sparse_skip={ss} codes {codes} (max "
                                 f"|err| {e})")
        err = max(err, e)
        skipped_any += int(got[1].sum())
        if ss and en_kind == "dead" and dens > 0:
            dense = fused_snn.partial_contraction_plain(
                x, en, wp, n_valid=n_out, sparse_skip=False)[0]
            dead_zeroed += int(((got[0] == 0) & (dense != 0)).sum())
        log(f"[K3-vs-plain] B={B} {n_in}->{n_out} density {dens:.2f}"
            f" enables {en_kind:4s} sparse_skip={ss!s:5s} codes {codes}: "
            f"current and skipped equal (skipped tile pairs "
            f"{int(got[1].sum())})")
    if not (skipped_any and dead_zeroed):
        raise AssertionError("the K3 cases never exercised the tile skip")
    log(f"[K3-vs-plain] {len(K3_CASES)} cases equal; {dead_zeroed} raw "
        f"currents of dead tiles are 0 where the dense product is not; "
        f"{time.perf_counter() - t0:.2f} s")
    return len(K3_CASES), err


def _k6_case(rng, B, K, N, density, dev, codes="9-bit", spikes="0/1"):
    """K6 operands: spikes non-zero at ``density``, of value 1 or (with
    ``spikes="0/1/2/255"``) 1, 2 or 255; codes signed 9-bit, over all of
    int16, or (``"int16 extremes"``) with every column holding -32768 and
    32767.  Returns them with the density as the op computes it."""
    on = rng.random((B, K)) < density
    if spikes == "0/1":
        s = on.astype(np.uint8)
    else:
        s = np.where(on, rng.choice(np.array([1, 2, 255], np.uint8), (B, K)),
                     0).astype(np.uint8)
    lo, hi = (-256, 256) if codes == "9-bit" else (-(1 << 15), 1 << 15)
    w = rng.integers(lo, hi, (K, N)).astype(np.int16)
    if codes == "int16 extremes":
        w[0::3], w[1::3] = -(1 << 15), (1 << 15) - 1
    count = np.float32(int(np.count_nonzero(s)))
    density_f32 = count * (np.float32(1) / np.float32(B * K))
    return (torch.from_numpy(s).to(dev), torch.from_numpy(w).to(dev),
            density_f32)


# (B, K, N, spike density, codes, spike bytes).  1,021, 1,000 and 24 lanes
# are not multiples of the kernel's 128-lane tile; 784 pads to 896 and
# N = 10 to 128; with bytes of 2 and 255 the realisations differ (dot
# multiplies by the byte, masked counts 1), and sums past int32 wrap.
K6_CASES = [
    (1024, 2048, 2048, 0.058, "9-bit", "0/1"),
    (1024, 2048, 2048, 0.104, "9-bit", "0/1"),
    (CHECK_BATCH, 784, 10, 0.2, "9-bit", "0/1"),
    (1024, 2048, 2048, 0.058, "int16 extremes", "0/1"),
    (1024, 2048, 512, 0.2, "int16", "0/1/2/255"),
    (1000, 2048, 512, 0.058, "int16 extremes", "0/1/2/255"),
    (24, 784, 10, 0.2, "int16", "0/1"),
    (CHECK_BATCH, 4096, 512, 0.058, "int16 extremes", "0/1/2/255"),
    (1024, 2048, 2048, 0.0, "int16", "0/1"),
    (1024, 2048, 2048, 0.001, "int16", "0/1"),
    (1024, 2048, 2048, 1.0, "int16 extremes", "0/1"),
    (24, 4096, 128, 1.0, "int16", "0/1/2/255"),
]


def phase_k6_vs_plain(dev) -> tuple[int, int]:
    """K6 through ``spike_matmul_op`` in every mode against the plain
    version on the same padded operands; the telemetry against the
    density computed on the host; on 0/1 spikes the realisations against
    each other."""
    rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    n_cases, err = 0, 0
    bB, bK, bN = spike_matmul.BLOCK
    for B, K, N, dens, codes, spikes in K6_CASES:
        s, w, d = _k6_case(rng, B, K, N, dens, dev, codes, spikes)
        above = float(d) * 2 if d > 0 else 0.5     # auto runs masked
        outs = {}
        for mode, thr in (("masked", None), ("dot", None),
                          ("auto", above), ("auto", float(d) / 2)):
            out, tel = ops.spike_matmul_op(s, w, mode=mode,
                                           density_threshold=thr,
                                           with_telemetry=True)
            torch.cuda.synchronize()
            masked = mode == "masked" or (mode == "auto" and
                                          d < np.float32(thr))
            plain = spike_matmul.spike_matmul_plain(
                _pad(s, bB, bK), _pad(w, bK, bN),
                torch.tensor(masked, device=dev))[:B, :N]
            e = _max_abs_err(out, plain)
            if e or bool(tel.used_masked) != masked or \
                    float(tel.density) != float(d):
                raise AssertionError(
                    f"K6 {mode} (threshold {thr}) at ({B}, {K}->{N}) "
                    f"density {dens} codes {codes} spikes {spikes}: max "
                    f"|err| {e}, telemetry ({float(tel.density)}, "
                    f"{bool(tel.used_masked)}) vs ({float(d)}, {masked})")
            if masked in outs and _max_abs_err(out, outs[masked]):
                raise AssertionError("K6's auto differs from its forced "
                                     "realisation")
            outs[masked] = out
            err = max(err, e)
            n_cases += 1
        if spikes == "0/1" and _max_abs_err(outs[True], outs[False]):
            raise AssertionError("K6's realisations differ on 0/1 spikes")
        log(f"[K6-vs-plain] ({B}, {K}->{N}) density {float(d):.4f} codes "
            f"{codes} spikes {spikes}: masked, dot, auto above and below "
            f"the threshold equal to the plain version and in telemetry")
    log(f"[K6-vs-plain] {n_cases} checks on {len(K6_CASES)} cases equal; "
        f"{time.perf_counter() - t0:.2f} s")
    return n_cases, err


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def _serve_params(rng):
    w = np.clip(np.round(rng.normal(0.0, 24.0, (784, 10))), -256, 255)
    return {"layers": [{"w_q": w.astype(np.int16), "scale": 1.0 / 128}]}


def _wide_params(rng):
    """Seeded codes for SNN_CONFIG_WIDE, scaled to fan-in as
    ``_fan_in_weights`` scales them, as numpy arrays."""
    sizes = cfgs.SNN_CONFIG_WIDE.layer_sizes
    return {"layers": [
        {"w_q": np.clip(np.round(rng.normal(0.0, 170 / np.sqrt(i), (i, o))),
                        -256, 255).astype(np.int16), "scale": 1.0 / 128}
        for i, o in zip(sizes[:-1], sizes[1:])]}


def _on(params, dev):
    return {"layers": [{"w_q": torch.from_numpy(l["w_q"]).to(dev),
                        "scale": l["scale"]} for l in params["layers"]]}


def _engine(params, cfg, backend):
    return SNNStreamEngine(params, cfg, batch_size=SERVE_BATCH,
                           chunk_steps=SERVE_CHUNK, patience=SERVE_PATIENCE,
                           seed=SEED, backend=backend)


# Engine methods whose host time the serve phase reports: compaction
# (and its parts: the active-mask readback, which also waits for the
# previous chunk, the tile download, harvest, admission, upload) and the
# chunk dispatch (padding, the wrapper's checks, the launch).
_TIMED = ("_admit_and_compact", "_needs_compaction", "_host_tile",
          "_harvest", "_admit_into", "_upload", "_dispatch_versions")


def _time_methods(eng, names) -> dict:
    """Wrap ``eng``'s methods with host-clock accumulators."""
    spent = {n: [0.0, 0] for n in names}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter() - t
                spent[name][1] += 1
        return run

    for n in names:
        setattr(eng, n, timed(n, getattr(eng, n)))
    return spent


def _record_telemetry(eng) -> list:
    """Keep every chunk's ChunkTelemetry the engine's dispatch returns."""
    tels, dispatch = [], eng._dispatch_versions

    def run(lanes):
        out = dispatch(lanes)
        tels.append(out[1])
        return out

    eng._dispatch_versions = run
    return tels


def _densities(tels, sizes) -> list[float]:
    """Mean input spike density of every layer over the lane-steps that ran
    (a frozen or empty lane's telemetry row is zero)."""
    n_spk = torch.cat([t.n_spk for t in tels]).double()
    ran = (torch.cat([t.n_en for t in tels])[:, 0, :] > 0).double()
    return [float((n_spk[:, l, :] * ran).sum() / (ran.sum() * k))
            for l, k in enumerate(sizes[:-1])]


def _kernel_trace(run, name) -> tuple[dict, dict]:
    """``run()`` under ``torch.profiler``: its result, and the trace's kernel
    events whose name holds ``name`` as the trace's own JSON (Chrome
    format, written under ``build/`` and removed) records them: how many,
    their summed device time in ms and their grid sizes."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    path = ROOT / "build" / f"trace-{name}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and name in e.get("name", "")]
    path.unlink()
    return out, {"launches": len(events),
                 "ms": sum(float(e["dur"]) for e in events) / 1e3,
                 "grids": sorted({tuple(e.get("args", {}).get("grid", []))
                                  for e in events})}


def phase_serve(imgs, params, cfg, tag, backend) -> dict:
    """Serve ``imgs`` with ``backend=None`` (it must resolve to
    ``backend``, the main path of kernel ``tag``), then again on the
    reference backend; the results must be equal id for id.  For K2 the
    same serve runs once more under ``torch.profiler`` for K2's own device
    time over its launches and the clusters it launched."""
    name = "SNN_CONFIG_WIDE" if cfg is cfgs.SNN_CONFIG_WIDE else "SNN_CONFIG"
    eng = _engine(params, cfg, None)
    if eng.backend != backend:
        raise AssertionError(f"auto backend resolved to {eng.backend!r}")
    for im in imgs:
        eng.submit(im)
    tels = _record_telemetry(eng)
    spent = _time_methods(eng, _TIMED)
    torch.cuda.synchronize()
    reset_counts()                                # the main path starts
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()                           # the main path ended
    if sorted(results) != list(range(len(imgs))):
        raise AssertionError(f"{len(results)} results for {len(imgs)} "
                             f"requests")
    if not (launched[tag] > 0 and launched[tag] == eng.dispatches):
        raise AssertionError(f"{launched[tag]} {tag} launches for "
                             f"{eng.dispatches} chunk dispatches")
    if any(n for k, n in launched.items() if k != tag):
        raise AssertionError(f"the {name} serve run launched {launched}")
    dens = _densities(tels, cfg.layer_sizes)
    out_spikes = int(sum(int(r.spike_counts.sum()) for r in results.values()))
    ref = _engine(params, cfg, "reference")
    for im in imgs:
        ref.submit(im)
    t1 = time.perf_counter()
    want = ref.run()
    ref_wall = time.perf_counter() - t1
    if counts() != launched:
        raise AssertionError("the reference backend launched a kernel")
    for rid, w in want.items():
        g = results[rid]
        if (g.pred, g.steps, g.adds, g.early_exit, g.weight_version) != \
                (w.pred, w.steps, w.adds, w.early_exit, w.weight_version) \
                or not np.array_equal(g.spike_counts, w.spike_counts):
            raise AssertionError(f"request {rid}: {backend} {g} != "
                                 f"reference {w}")
    steps = np.array([r.steps for r in results.values()])
    preds = np.bincount([r.pred for r in results.values()], minlength=10)
    sizes = "->".join(str(n) for n in cfg.layer_sizes)
    log(f"[serve] {name} {sizes} T=20 batch={SERVE_BATCH} "
        f"chunk={SERVE_CHUNK} patience={SERVE_PATIENCE} backend={backend}: "
        f"{len(results)} requests in {wall:.3f} s = "
        f"{len(results) / wall:.1f} requests/s, {eng.dispatches} chunks, "
        f"{launched[tag]} {tag} launches")
    log(f"[serve] {name} host time by engine method (ms, calls): " + ", ".join(
        f"{n} {sec * 1e3:.2f} ({calls})" for n, (sec, calls) in spent.items()))
    log(f"[serve] {name} input spike density per layer "
        + " ".join(f"{d:.4f}" for d in dens)
        + f"; output spikes {out_spikes}; early exits "
        f"{int((steps < 20).sum())}, mean steps {steps.mean():.2f}, "
        f"predictions per class {preds.tolist()}")
    if len(dens) > 1 and not all(0.01 <= d <= 0.5 for d in dens[1:]):
        raise AssertionError(f"hidden spike densities {dens[1:]} outside "
                             f"[1%, 50%]")
    if out_spikes == 0:
        raise AssertionError("the output layer never spiked")
    log(f"[serve] {name} reference backend on the card: {ref_wall:.3f} s = "
        f"{len(want) / ref_wall:.1f} requests/s; results equal id for id")
    out = {"launches": launched[tag], "chunks": eng.dispatches,
           "requests_per_s": len(results) / wall, "results": results}
    if tag == "K1":
        again = _engine(params, cfg, None)
        for im in imgs:
            again.submit(im)
        got, _, events = _cuda_events(again.run)
        _same_results(got, results, f"{name} profiled serve")
        own = sum(ms for k, ms, _ in events if "fused_snn_stack_kernel" in k)
        copies = sum(ms for k, ms, _ in events
                     if k.startswith(("Memcpy", "Memset")))
        glue = sum(ms for _, ms, _ in events) - own - copies
        n = again.dispatches
        log(f"[serve] {name} profiled once more (torch.profiler, CUDA "
            f"events): K1 {own:.4f} ms, the other kernels (glue) "
            f"{glue:.4f} ms, copies {copies:.4f} ms of device time over "
            f"{n} chunks: per chunk K1 {own / n * 1e3:.2f} us, glue "
            f"{glue / n * 1e3:.2f} us, copies {copies / n * 1e3:.2f} us; "
            f"results equal")
        out.update(serve_device_ms=own, glue_device_ms=glue,
                   copy_device_ms=copies)
        return out
    again = _engine(params, cfg, None)
    for im in imgs:
        again.submit(im)
    got, k2 = _kernel_trace(again.run, "fused_snn_streamed_kernel")
    _same_results(got, results, f"{name} profiled serve")
    clusters = -(-SERVE_BATCH // fused_snn.STREAM_LANES)
    log(f"[serve] {name} profiled once more (torch.profiler trace): "
        f"{k2['launches']} K2 kernel events taking {k2['ms']:.3f} ms of "
        f"device time, grids {k2['grids']} (CTAs; {clusters} clusters of 64 "
        f"lanes at B={SERVE_BATCH}); results equal")
    if k2["launches"] != again.dispatches:
        raise AssertionError(f"the trace holds {k2['launches']} K2 launches "
                             f"of {again.dispatches}")
    out["serve_device_ms"] = k2["ms"]
    out["grids"] = k2["grids"]
    return out


def _same_results(got, want, what) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: {len(got)} results for {len(want)}")
    for rid, w in want.items():
        g = got[rid]
        if (g.pred, g.steps, g.adds, g.early_exit, g.weight_version) != \
                (w.pred, w.steps, w.adds, w.early_exit, w.weight_version) \
                or not np.array_equal(g.spike_counts, w.spike_counts):
            raise AssertionError(f"{what}: request {rid}: {g} != {w}")


def _cuda_events(run) -> tuple:
    """``run()`` under ``torch.profiler``: its result, the wall time in ms
    of that profiled run, and the CUDA events of ``key_averages()`` as
    (name, device ms, calls): kernels, copies and fills, each counted once
    (the operators that launch them carry the same time again, so they are
    left out: F-s)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    return out, wall_ms, events


def _device_busy_ms(run) -> tuple[float, float, list]:
    """Device time of every kernel and copy ``run()`` launches (0.0 when
    the trace holds no device time), the wall time of that same profiled
    ``run()`` in ms, and the eight events with the most device time:
    (name, ms, calls)."""
    _, wall_ms, events = _cuda_events(run)
    events.sort(key=lambda o: -o[1])
    return sum(ms for _, ms, _ in events), wall_ms, events[:8]


def phase_mesh_serve(imgs, params, cfg, mesh, lanes, want, dev,
                     profile=False) -> dict:
    """Serve ``imgs`` with ``ShardedSNNStreamEngine`` on a (data × model)
    mesh of the one card, ``backend=None``: every contraction must run
    through K3, no stack kernel may launch, and the results must equal the
    single-device run's ``want`` id for id.  With ``profile`` the same
    serve then runs four more times, speculation off, on, on, off (each
    equal to ``want``), and once more under ``torch.profiler`` for the
    device busy share of that profiled run's own wall time."""
    nd, md = mesh
    name = "SNN_CONFIG_WIDE" if cfg is cfgs.SNN_CONFIG_WIDE else "SNN_CONFIG"
    knobs = cfgs.SNNStreamMeshConfig(num_devices=nd, model_devices=md,
                                     lanes_per_device=lanes,
                                     chunk_steps=SERVE_CHUNK)

    def engine(**kw):
        return cfgs.make_stream_engine(params, cfg,
                                       dataclasses.replace(knobs, **kw),
                                       devices=[dev] * (nd * md),
                                       patience=SERVE_PATIENCE, seed=SEED)

    eng = engine()
    if eng.backend not in ("fused", "fused_streamed"):
        raise AssertionError(f"auto backend resolved to {eng.backend!r}")
    for im in imgs:
        eng.submit(im)
    spent = _time_methods(eng, _TIMED + ("_advance",))
    torch.cuda.synchronize()
    reset_counts()                                # the main path starts
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()                           # the main path ended
    if launched["K3"] == 0 or any(n for k, n in launched.items()
                                  if k != "K3"):
        raise AssertionError(f"the {nd}x{md} mesh serve launched {launched}")
    _same_results(results, {rid: want[rid] for rid in results},
                  f"{nd}x{md} mesh vs single device")
    if len(results) != len(imgs):
        raise AssertionError(f"{len(results)} results for {len(imgs)}")
    sizes = "->".join(str(n) for n in cfg.layer_sizes)
    log(f"[mesh] {name} {sizes} on a {nd}x{md} (data x model) mesh of one "
        f"card, {lanes} lanes per data shard, chunk={SERVE_CHUNK} "
        f"patience={SERVE_PATIENCE} backend={eng.backend} (K3 per step, "
        f"layer and shard; layer ways {eng.model_ways}): {len(results)} "
        f"requests in {wall:.3f} s = {len(results) / wall:.1f} requests/s, "
        f"{eng.stats['chunks']} chunks, {eng.dispatches} chunk dispatches "
        f"(spec_used {eng.stats['spec_used']}, spec_wasted "
        f"{eng.stats['spec_wasted']}), {launched['K3']} K3 launches; "
        f"results equal to the single-device run id for id")
    log(f"[mesh] {name} {nd}x{md} host time by engine method (ms, calls): "
        + ", ".join(f"{n} {sec * 1e3:.2f} ({calls})"
                    for n, (sec, calls) in spent.items()))
    out = {"launches": launched["K3"], "chunks": eng.stats["chunks"],
           "requests_per_s": len(results) / wall}
    if not profile:
        return out
    out["overlap"] = []
    for overlap in (False, True, True, False):
        again = engine(overlap=overlap)
        for im in imgs:
            again.submit(im)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = again.run()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        _same_results(got, want, f"{nd}x{md} mesh, overlap={overlap}")
        k3 = counts()["K3"]
        out["overlap"].append({"overlap": overlap, "s": sec,
                               "requests_per_s": len(got) / sec,
                               "K3": k3, **again.stats})
        log(f"[mesh] {name} {nd}x{md} overlap={overlap}: {len(got)} "
            f"requests in {sec:.6f} s = {len(got) / sec:.1f} requests/s, "
            f"{again.stats['chunks']} chunks (spec_used "
            f"{again.stats['spec_used']}, spec_wasted "
            f"{again.stats['spec_wasted']}), {k3} K3 launches; results "
            f"equal")
    again = engine()
    for im in imgs:
        again.submit(im)
    busy, prof_ms, top = _device_busy_ms(again.run)
    log(f"[mesh] {name} {nd}x{md} device time summed from a torch.profiler "
        f"trace of one more identical run (overlap={knobs.overlap}): "
        f"{busy:.3f} ms of that profiled run's {prof_ms:.3f} ms wall time "
        f"= {busy / prof_ms * 100:.2f}% busy; most device time (ms, "
        f"calls): " + "; ".join(f"{k[:60]} {ms:.3f} ({n})"
                                for k, ms, n in top))
    out["device_busy_ms"] = busy
    out["profiled_wall_ms"] = prof_ms
    return out


# ---------------------------------------------------------------------------
# 4b. the serving tier, the fault harness and the degradation ladder
# ---------------------------------------------------------------------------

# engine 0: its first chunk's telemetry corrupted; consults 1-4 fault on
# both fused rungs, so two faults a rung (demote_after) walk it down to
# the reference rung within one round, and two clean chunks a rung
# (promote_after) walk it back up to K1.  Engine 1: request 1 (its first
# tile) is poison, quarantined at its first fault; it hangs from its
# third consult on, mid-window, until the watchdog (4 stalls) fails it.
TIER_POISON = 1
TIER_FT = FaultToleranceConfig(demote_after=2, promote_after=2,
                               quarantine_after=1)


def _tier_plan() -> FaultPlan:
    return FaultPlan(events=(
        FaultEvent(kind="dispatch", engine=0, first_chunk=1, last_chunk=4,
                   backends=("fused", "fused_streamed")),
        FaultEvent(kind="telemetry", engine=0, first_chunk=0, last_chunk=0),
        FaultEvent(kind="poison", request_id=TIER_POISON),
        FaultEvent(kind="hang", engine=1, first_chunk=2)))


def _rung_log(engines) -> list:
    """Wrap each engine's ``_advance`` (one call per chunk it runs) to
    record ``(engine, rung, kernel launches of that chunk)``."""
    chunks = []
    for i, eng in enumerate(engines):
        def run(lanes, weights, i=i, eng=eng, advance=eng._advance):
            before = counts()
            out = advance(lanes, weights)
            chunks.append((i, eng.backend_effective,
                           {k: n - before[k] for k, n in counts().items()}))
            return out
        eng._advance = run
    return chunks


def _by_rung(chunks) -> dict:
    """{rung: [chunks, {kernel: launches}]} over a ``_rung_log``."""
    out = {}
    for _, rung, launched in chunks:
        n, tot = out.setdefault(rung, [0, dict.fromkeys(KERNELS, 0)])
        out[rung][0] = n + 1
        for k, v in launched.items():
            tot[k] += v
    return out


def _timed_steps(tier) -> list:
    """Wrap ``tier.step`` with a host-clock accumulator: [seconds, steps]."""
    spent, step = [0.0, 0], tier.step

    def run():
        t = time.perf_counter()
        try:
            return step()
        finally:
            spent[0] += time.perf_counter() - t
            spent[1] += 1

    tier.step = run
    return spent


def _tier(params, cfg, plan, **kw):
    return SNNServingTier(params, cfg, num_engines=2,
                          lanes_per_engine=SERVE_BATCH,
                          chunk_steps=SERVE_CHUNK, patience=SERVE_PATIENCE,
                          seed=SEED, shedding=False, fault_plan=plan, **kw)


def _run_tier(tier, imgs) -> tuple:
    """Submit ``imgs`` (ids 0..n-1), run the tier with the launch counts
    set to 0 just before, and return its results, the counts, the wall
    time and the host time per tier step."""
    for im in imgs:
        tier.submit(im)
    spent = _timed_steps(tier)
    torch.cuda.synchronize()
    reset_counts()                                # the tier's run starts
    t0 = time.perf_counter()
    results = tier.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()                           # the tier's run ended
    return results, launched, wall, spent


def _partition(tier, n) -> None:
    res, shed, faulted = set(tier.results), set(tier.shed), set(tier.faulted)
    if res | shed | faulted != set(range(n)) or (res & shed) or (
            res & faulted) or (shed & faulted):
        raise AssertionError(f"results {len(res)}, shed {len(shed)} and "
                             f"faulted {len(faulted)} do not partition the "
                             f"{n} ids")


def phase_tier(imgs, params, want, single_rate) -> dict:
    """The serving tier on 784→10 through K1, K2 and the reference rung,
    with failover (``_tier_plan``), then the same tier with no plan."""
    tier = _tier(params, cfgs.SNN_CONFIG, _tier_plan(), fault_cfg=TIER_FT)
    ladders = [e._ladder for e in tier.engines]
    if ladders != [("fused", "fused_streamed", "reference")] * 2:
        raise AssertionError(f"tier ladders {ladders}")
    chunks = _rung_log(tier.engines)
    results, launched, wall, spent = _run_tier(tier, imgs)
    _partition(tier, len(imgs))
    rec = tier.faulted.get(TIER_POISON)
    if set(tier.faulted) != {TIER_POISON} or rec.reason != "quarantined" \
            or rec.replay_seed != SEED + TIER_POISON:
        raise AssertionError(f"faulted {tier.faulted}")
    _same_results(results, {rid: want[rid] for rid in results},
                  "tier under the fault plan vs the single-engine K1 serve")
    e0, e1 = tier.engines
    moves = [(ev["event"], ev["from"], ev["to"]) for ev in e0.health.events
             if ev["event"] in ("demote", "promote")]
    walk = [("demote", "fused", "fused_streamed"),
            ("demote", "fused_streamed", "reference"),
            ("promote", "reference", "fused_streamed"),
            ("promote", "fused_streamed", "fused")]
    if moves != walk or e0.backend_effective != "fused":
        raise AssertionError(f"engine 0 ladder moves {moves}, ends on "
                             f"{e0.backend_effective!r}")
    if e0.health.telemetry_faults != 1:
        raise AssertionError(f"{e0.health.telemetry_faults} telemetry "
                             f"faults on engine 0")
    fails = [ev for ev in e1.health.events
             if ev["event"] == "engine_failure"]
    if [ev["reason"] for ev in fails] != ["hang"] or \
            tier.stats["evacuated"] < 1 or tier._dead != {1}:
        raise AssertionError(f"engine 1 failures {fails}, stats "
                             f"{tier.stats}")
    if not (launched["K1"] > 0 and launched["K2"] > 0) or any(
            launched[k] for k in ("K3", "K4", "K5", "K6")):
        raise AssertionError(f"the tier run launched {launched}")
    rungs = _by_rung(chunks)
    for rung, tag in (("fused", "K1"), ("fused_streamed", "K2"),
                      ("reference", None)):
        n, tot = rungs.get(rung, [0, {}])
        if n == 0 or any(v for k, v in tot.items() if k != tag) or (
                tag and tot[tag] != n):
            raise AssertionError(f"{rung} rung: {n} chunks, launches {tot}")
    log(f"[tier] SNN_CONFIG 784->10, 2 engines x {SERVE_BATCH} lanes, "
        f"chunk={SERVE_CHUNK} patience={SERVE_PATIENCE}, the fault plan: "
        f"{len(results)} results in {wall:.3f} s = "
        f"{len(results) / wall:.1f} requests/s; {spent[1]} tier steps, "
        f"{spent[0] / spent[1] * 1e3:.3f} ms host each; routed per engine "
        f"{tier.stats['routed_per_engine']}; chunks by rung "
        + ", ".join(f"{r} {n} ({tot})" for r, (n, tot) in rungs.items())
        + f"; launches K1 {launched['K1']}, K2 {launched['K2']}; engine 0 "
        f"{' -> '.join(m[1] for m in moves)} -> fused, consults "
        f"{e0.injector.consults}; engine 1 failed (hang) at consult "
        f"{e1.injector.consults - 1}, {tier.stats['evacuated']} lanes "
        f"evacuated, {tier.stats['requeued']} requeued; request "
        f"{TIER_POISON} quarantined (replay seed {rec.replay_seed}); "
        f"results equal the K1 serve's id for id")
    clean = _tier(params, cfgs.SNN_CONFIG, None)
    got, clean_launched, clean_wall, clean_spent = _run_tier(clean, imgs)
    _same_results(got, want, "tier with no plan vs the K1 serve")
    if any(clean_launched[k] for k in KERNELS if k != "K1"):
        raise AssertionError(f"the unfaulted tier launched {clean_launched}")
    log(f"[tier] the same tier with no plan: {len(got)} requests in "
        f"{clean_wall:.3f} s = {len(got) / clean_wall:.1f} requests/s, "
        f"{clean_spent[1]} tier steps, "
        f"{clean_spent[0] / clean_spent[1] * 1e3:.3f} ms host each, "
        f"{clean_launched['K1']} K1 launches, routed per engine "
        f"{clean.stats['routed_per_engine']}; the single-engine K1 serve "
        f"{single_rate:.1f} requests/s (host clock); results equal")
    return {"K1": launched["K1"], "K2": launched["K2"],
            "requests_per_s": len(results) / wall,
            "clean_requests_per_s": len(got) / clean_wall,
            "chunks_by_rung": {r: n for r, (n, _) in rungs.items()}}


def phase_sharded_tier(imgs, params, want, dev) -> dict:
    """A data-sharded tier (2 engines over four names of the card, two
    data shards each) on 784→10 loses engine 1 mid-window with its lane
    state kept; its lanes evacuate and every result equals the K1
    serve's."""
    plan = FaultPlan(events=(FaultEvent(kind="device_loss", engine=1,
                                        first_chunk=1),))
    tier = _tier(params, cfgs.SNN_CONFIG, plan, sharded=True,
                 devices=[dev] * 4)
    if [(e.n_devices, e.backend) for e in tier.engines] != [(2, "fused")] * 2:
        raise AssertionError("sharded tier engines "
                             f"{[(e.n_devices, e.backend) for e in tier.engines]}")
    results, launched, wall, _ = _run_tier(tier, imgs)
    _partition(tier, len(imgs))
    _same_results(results, {rid: want[rid] for rid in range(len(imgs))},
                  "sharded tier vs the K1 serve")
    if tier.stats["evacuated"] < 1 or tier._dead != {1} or tier.faulted:
        raise AssertionError(f"sharded tier stats {tier.stats}")
    if launched["K1"] == 0 or any(launched[k] for k in KERNELS if k != "K1"):
        raise AssertionError(f"the sharded tier launched {launched}")
    log(f"[tier] data-sharded tier, 2 engines x 2 data shards of the card, "
        f"{SERVE_BATCH} lanes each: {len(results)} requests in {wall:.3f} s "
        f"= {len(results) / wall:.1f} requests/s, {launched['K1']} K1 "
        f"launches; engine 1 lost at consult 1, {tier.stats['evacuated']} "
        f"lanes evacuated; results equal the K1 serve's id for id")
    return {"K1": launched["K1"], "requests_per_s": len(results) / wall}


def phase_model_axis_ladder(imgs, params, want, dev) -> dict:
    """F-u on the card: the 1×4 mesh's engine on WIDE resolves ``fused``
    and builds the three-rung ladder by the shared-memory model on one
    peer's shard; dispatch faults on ``fused`` demote it once, and both
    rungs run K3 alone."""
    knobs = cfgs.SNNStreamMeshConfig(num_devices=MESH_WIDE[0],
                                     model_devices=MESH_WIDE[1],
                                     lanes_per_device=SERVE_BATCH,
                                     chunk_steps=SERVE_CHUNK)
    plan = FaultPlan(events=(FaultEvent(kind="dispatch", first_chunk=1,
                                        last_chunk=2, backends=("fused",)),))
    eng = cfgs.make_stream_engine(
        params, cfgs.SNN_CONFIG_WIDE, knobs, devices=[dev] * 4,
        patience=SERVE_PATIENCE, seed=SEED, injector=FaultInjector(plan, 0),
        fault_cfg=FaultToleranceConfig(demote_after=2, promote_after=1000))
    if eng.backend != "fused" or \
            eng._ladder != ("fused", "fused_streamed", "reference"):
        raise AssertionError(f"model-axis engine: {eng.backend!r}, ladder "
                             f"{eng._ladder}")
    for im in imgs:
        eng.submit(im)
    chunks = _rung_log([eng])
    torch.cuda.synchronize()
    reset_counts()                                # the mesh run starts
    results = eng.run()
    torch.cuda.synchronize()
    launched = counts()                           # the mesh run ended
    _same_results(results, {rid: want[rid] for rid in range(len(imgs))},
                  "1x4 mesh under dispatch faults vs the K2 WIDE serve")
    demotes = [(ev["from"], ev["to"]) for ev in eng.health.events
               if ev["event"] == "demote"]
    rungs = _by_rung(chunks)
    if demotes != [("fused", "fused_streamed")] or \
            set(rungs) != {"fused", "fused_streamed"} or any(
                tot["K3"] == 0 or any(v for k, v in tot.items() if k != "K3")
                for _, tot in rungs.values()):
        raise AssertionError(f"model-axis ladder: demotions {demotes}, "
                             f"rungs {rungs}")
    if launched["K3"] == 0 or any(launched[k] for k in KERNELS if k != "K3"):
        raise AssertionError(f"the model-axis ladder run launched {launched}")
    log(f"[tier] WIDE on the 1x4 mesh, dispatch faults on 'fused': ladder "
        f"{eng._ladder}, one demotion fused -> fused_streamed; chunks by "
        f"rung " + ", ".join(f"{r} {n} ({tot['K3']} K3)"
                             for r, (n, tot) in rungs.items())
        + f"; {launched['K3']} K3 launches, no other kernel; results equal "
        f"the K2 WIDE serve's id for id")
    return {"K3": launched["K3"],
            "chunks_by_rung": {r: n for r, (n, _) in rungs.items()}}


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def _bytes_of(xs) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(xs))


def _function_bytes(batch, sizes, chunk, gated) -> int:
    """Bytes the chunk function must move at its true (unpadded) shapes:
    each input read once, each output written once, the weights once."""
    n_in, outs, n_out = sizes[0], sizes[1:], sizes[-1]
    L = len(outs)
    state = batch * (n_in * 4                  # PRNG state
                     + sum(outs) * 9           # v, v_peak (i32), en (u8)
                     + n_out * 8               # counts, first-spike latch
                     + 4 + (12 if gated else 0))   # steps, gate
    records = chunk * batch * (n_out * 4       # v_trace
                               + 4             # executed adds
                               + L * 8)        # n_spk, n_en
    tiles = chunk * L * (batch // fused_snn.BLOCK_B) * 4
    weights = sum(i * o * 2 for i, o in zip(sizes[:-1], sizes[1:]))
    return batch * n_in + 2 * state + records + tiles + weights


def _device_ms(fn, n) -> float:
    """Device time per call of ``fn``: the stream is held by a sleep kernel
    while the host enqueues every call, so the events bracket back-to-back
    kernels and not the wrapper's host work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _plain_ms(fn, m) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(m):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / m


def _bound(tag, fn_bytes, n_ops, ms, plain_ms, what,
           library_ms=None, tc_ops=None) -> dict:
    """The least time the card could take: the larger of the bytes at
    3.35 TB/s and the operations, the executed int32 operations at the
    INT32 rate or, where the function is a contraction of the two int8
    planes (``tc_ops``, 2 * B * K * N * 2), those at the int8 tensor-core
    rate, whichever is shorter."""
    t_bytes = fn_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    t_tc = None if tc_ops is None else tc_ops / INT8_TC_OPS_PER_S * 1e3
    t_op_min = t_ops if t_tc is None else min(t_ops, t_tc)
    bound_ms = max(t_bytes, t_op_min)
    log(f"[times] {tag} {what}: {ms * 1e3:.2f} us/launch on the device; "
        f"plain version {plain_ms * 1e3:.1f} us")
    lib = ("no single PyTorch call computes this function, so there is no "
           "library time" if library_ms is None else
           f"torch.matmul in float32 (TF32 off) on the same operands "
           f"{library_ms * 1e3:.2f} us")
    tc = ("" if t_tc is None else
          f"; {tc_ops} int8 tensor-core ops at "
          f"{INT8_TC_OPS_PER_S / 1e12:.0f} T/s -> {t_tc * 1e3:.3f} us")
    log(f"[times] {tag} bound: the function moves {fn_bytes} B "
        f"({fn_bytes / 1e6:.3f} MB, unpadded) at 3.35 TB/s -> "
        f"{t_bytes * 1e3:.3f} us; {n_ops} int32 ops at "
        f"{INT32_OPS_PER_S / 1e12:.2f} T/s -> {t_ops * 1e3:.3f} us{tc}; "
        f"bound {bound_ms * 1e3:.3f} us ({bound_ms / ms * 100:.2f}% of the "
        f"kernel's time); {lib}")
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_op_min else "operations",
           "library_ms": library_ms}
    if t_tc is not None:     # the bound without the tensor cores, beside it
        out["add_bound_ms"] = max(t_bytes, t_ops)
    return out


def _time_stack(tag, cfg, imgs, params, dev, kernel, n, m,
                planes=False) -> dict:
    """A stack kernel at its serving shape: B lanes, one gated chunk; with
    ``planes`` the weights are packed once, as the engine places them for
    the streamed kernel, and the bound counts its two-plane product at the
    int8 tensor-core rate beside the adds."""
    px = torch.from_numpy(imgs[:SERVE_BATCH]).to(dev)
    st = seed_state(SEED, (SERVE_BATCH, cfg.n_in), device=dev)
    ws = tuple(torch.from_numpy(l["w_q"]).to(dev) for l in params["layers"])
    gate = {"active": torch.ones(SERVE_BATCH, dtype=torch.bool, device=dev),
            "prev": torch.full((SERVE_BATCH,), -1, dtype=torch.int32,
                               device=dev),
            "streak": torch.zeros(SERVE_BATCH, dtype=torch.int32, device=dev)}
    args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                    gate=gate, streamed=planes)
    kw = dict(_lif_kw(cfg, cfg.readout, True), chunk_steps=SERVE_CHUNK,
              block_b=meta["block_b"])
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    err = _max_abs_err(out, fused_snn.fused_snn_stack_plain(*args, **kw))
    if err:
        raise AssertionError(f"{tag} != plain at the serving shape ({err})")
    ms = _device_ms(lambda: kernel(*args, **kw), n)
    t0 = time.perf_counter()
    for _ in range(n):
        kernel(*args, **kw)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / n
    plain_ms = _plain_ms(
        lambda: fused_snn.fused_snn_stack_plain(*args, **kw), m)
    adds = int(ops.stack_results(out, meta)["active_adds"].sum())
    n_in, n_neurons = cfg.layer_sizes[0], sum(cfg.layer_sizes[1:])
    # executed synaptic adds (this data) + xorshift (6) and compare (1) per
    # pixel per step + ~10 LIF ops per neuron per step, all int32
    n_ops = (adds + 7 * SERVE_BATCH * n_in * SERVE_CHUNK
             + 10 * SERVE_BATCH * n_neurons * SERVE_CHUNK)
    fn_bytes = _function_bytes(SERVE_BATCH, cfg.layer_sizes, SERVE_CHUNK,
                               gated=True)
    moved = _bytes_of(args) + _bytes_of(out)
    # the op as the engine calls it: the carried state of that first launch
    res0 = ops.stack_results(out, meta)
    init = {k: res0[k] for k in ("v", "en", "v_peak", "steps")}
    init.update(counts=res0["spike_counts"], first=res0["first_spike_t"])
    ws_op = args[2] if planes else ws
    lif = cfg.lif

    def op():
        return ops.fused_snn_stack_op(
            px, st, ws_op, num_steps=cfg.num_steps, chunk_steps=SERVE_CHUNK,
            decay_shift=lif.decay_shift, v_threshold=lif.v_threshold,
            v_rest=lif.v_rest, v_min=lif.v_min, v_max=lif.v_max,
            active_pruning=cfg.active_pruning, init=init, gate=gate,
            patience=SERVE_PATIENCE, readout=cfg.readout, sparse_skip=True,
            streamed=planes, layer_sizes=cfg.layer_sizes)

    op()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        op()
    torch.cuda.synchronize()
    op_ms = (time.perf_counter() - t0) * 1e3 / n
    log(f"[times] {tag} {call_ms * 1e3:.2f} us per wrapper call and "
        f"{op_ms * 1e3:.2f} us per fused_snn_stack_op call (the engine's "
        f"carried state) on the host clock; the launch's operands in and "
        f"out are {moved} B")
    sizes = cfg.layer_sizes
    tc_ops = None
    if planes:
        tc_ops = (2 * SERVE_BATCH * 2 * SERVE_CHUNK
                  * sum(i * o for i, o in zip(sizes[:-1], sizes[1:])))
    res = _bound(tag, fn_bytes, n_ops, ms, plain_ms,
                 f"B={SERVE_BATCH} chunk={SERVE_CHUNK} gated "
                 f"{'->'.join(str(k) for k in sizes)}", tc_ops=tc_ops)
    return dict(res, call_ms=call_ms, op_call_ms=op_ms, launch_bytes=moved)


def _deep_params():
    """Seeded codes for SNN_CONFIG_DEEP, normal(0, 170 / sqrt(fan-in)), as
    numpy arrays: K1's second timed shape."""
    ws = _fan_in_weights(np.random.default_rng(SEED + 31),
                         cfgs.SNN_CONFIG_DEEP.layer_sizes, "cpu")
    return {"layers": [{"w_q": w.numpy(), "scale": 1.0 / 128} for w in ws]}


def _encoded(imgs, dev):
    """The encoder's operands for the first 1,024 images as its op pads
    them (784 -> 896 columns) and their (T_STAGED, 1,024, 896) train."""
    B = SERVE_BATCH
    pxp = torch.zeros((B, 896), dtype=torch.uint8, device=dev)
    pxp[:, :784] = torch.from_numpy(imgs[:B])
    stp = torch.zeros((B, 896), dtype=torch.int32, device=dev)
    stp[:, :784] = seed_state(SEED, (B, 784), device=dev).view(torch.int32)
    stp = stp.view(torch.uint32)
    return pxp, stp, poisson_encode.poisson_encode(pxp, stp, T_STAGED)[0]


def phase_times(imgs, params, wide_params, dev) -> dict:
    times = {
        "K1": _time_stack("K1", cfgs.SNN_CONFIG, imgs, params, dev,
                          fused_snn.fused_snn_stack, 200, 10),
        "K2": _time_stack("K2", cfgs.SNN_CONFIG_WIDE, imgs, wide_params, dev,
                          fused_snn.fused_snn_stack_streamed, 50, 3,
                          planes=True)}
    times["K1"]["deep"] = _time_stack("K1", cfgs.SNN_CONFIG_DEEP, imgs,
                                      _deep_params(), dev,
                                      fused_snn.fused_snn_stack, 200, 3)
    # K4 at (T, 1024, 784): the operands its op hands it, padded to 896
    B, T = SERVE_BATCH, T_STAGED
    pxp, stp, spikes = _encoded(imgs, dev)
    ms = _device_ms(lambda: poisson_encode.poisson_encode(pxp, stp, T), 200)
    plain = _plain_ms(
        lambda: poisson_encode.poisson_encode_plain(pxp, stp, T), 10)
    times["K4"] = _bound("K4", B * 784 * (1 + 4 + 4) + T * B * 784,
                         7 * T * B * 784, ms, plain, f"T={T} B={B} N=784")
    # K5 at (T, 1024, 2048 -> 2048), the second hidden layer of the wide
    # stack, and at the head of 784 -> 16384 -> 10
    times["K5"], x, w1 = _time_k5(spikes[:, :, :784], wide_params, dev)
    times["K6_path"] = phase_k6_path(x, w1)
    times["K3"] = _time_k3(dev)
    times["K6"] = _time_k6(dev)
    return times


def _k5_bound(x, w, n_out, ms, plain_ms, what) -> dict:
    """K5's bound on the unpadded function: each input read once (spikes,
    codes), each output written once (spikes, trace, final membrane); the
    executed adds of this data plus ~10 LIF operations per neuron and
    step at the INT32 rate, or the two-plane product on the int8 tensor
    cores, 2 * T * B * K * N * 2 operations, whichever is shorter."""
    T, B, K = x.shape
    adds = int(x.sum(dtype=torch.int64)) * n_out  # no pruning: all enabled
    return _bound("K5", T * B * K + K * n_out * 2 + T * B * n_out * 5
                  + B * n_out * 4, adds + 10 * T * B * n_out, ms, plain_ms,
                  what, tc_ops=2 * T * B * K * n_out * 2)


def _time_k5(spikes, wide_params, dev) -> tuple[dict, torch.Tensor,
                                                torch.Tensor]:
    """K5 at (T, 1,024, 2048 -> 2048), fed the wide stack's first hidden
    layer's spike train, and at the head of 784 -> 16384 -> 10 (K = 16,384
    over one padded 128-column tile, fed a 16,384-wide hidden layer's
    train), both trains made by the plain version from ``spikes``, the
    encoder's (T, 1,024, 784) train.  Returns the times, the 2048-wide
    train and the second layer's codes."""
    T, B = spikes.shape[:2]
    lif = cfgs.SNN_CONFIG_WIDE.lif
    kw = dict(decay_shift=lif.decay_shift, v_threshold=lif.v_threshold,
              v_rest=lif.v_rest, v_min=lif.v_min, v_max=lif.v_max)
    w0, w1 = (torch.from_numpy(l["w_q"]).to(dev)
              for l in wide_params["layers"][:2])
    x = lif_step.lif_forward_plain(spikes, w0, **kw)[0]
    K, N = w1.shape
    ms = _device_ms(lambda: lif_step.lif_forward(x, w1, **kw), 20)
    plain = _plain_ms(lambda: lif_step.lif_forward_plain(x, w1, **kw), 3)
    out = _k5_bound(x, w1, N, ms, plain,
                    f"T={T} B={B} {K}->{N} (input density "
                    f"{float(x.float().mean()):.4f})")
    # its contraction alone (not its function: the LIF recurrence follows)
    # is one float32 product over the whole spike train
    xf, wf = x.reshape(T * B, K).float(), w1.float()
    out["contraction_library_ms"] = _device_ms(lambda: torch.matmul(xf, wf),
                                               20)
    log(f"[times] K5 its contraction alone, one torch.matmul in float32 "
        f"({T * B}, {K}) x ({K}, {N}): "
        f"{out['contraction_library_ms'] * 1e3:.2f} us")
    del xf
    # the head: 784 -> 16384 with fan-in codes, then 16384 -> 10 (padded to
    # 128 columns, as lif_forward_op pads it)
    rng = np.random.default_rng(SEED + 29)
    wa, wb = _fan_in_weights(rng, (784, HEAD_WIDTH, 10), dev)
    h = lif_step.lif_forward_plain(spikes, wa, **kw)[0]
    wbp = ops._pad_to(wb, 1, lif_step.BLOCK[1])
    got = lif_step.lif_forward(h, wbp, **kw)
    torch.cuda.synchronize()
    if _max_abs_err(got, lif_step.lif_forward_plain(h, wbp, **kw)):
        raise AssertionError("K5 != plain at the head shape")
    ms = _device_ms(lambda: lif_step.lif_forward(h, wbp, **kw), 5)
    plain = _plain_ms(lambda: lif_step.lif_forward_plain(h, wbp, **kw), 2)
    head = _k5_bound(h, wb, 10, ms, plain,
                     f"head T={T} B={B} {HEAD_WIDTH}->10 (padded to 128; "
                     f"input density {float(h.float().mean()):.4f})")
    out["head"] = head
    return out, x, w1


def phase_k6_path(x, w) -> dict:
    """The K6 path: a wide hidden layer's contraction of each step of a
    20-step spike train through ``spike_matmul_op``'s density dispatch
    (``auto``, the default threshold), held against one float64 product."""
    T = x.shape[0]
    reset_counts()                                # the K6 path starts
    outs = [ops.spike_matmul_op(x[t], w, with_telemetry=True)
            for t in range(T)]
    torch.cuda.synchronize()
    launched = counts()                           # the K6 path ended
    if launched["K6"] != T or any(n for k, n in launched.items()
                                  if k != "K6"):
        raise AssertionError(f"the K6 path launched {launched}")
    want = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    got = torch.stack([o for o, _ in outs])
    err = _max_abs_err(got, want.to(torch.int32))
    if err:
        raise AssertionError(f"K6 path != plain (max |err| {err})")
    dens = [float(t.density) for _, t in outs]
    masked = sum(bool(t.used_masked) for _, t in outs)
    log(f"[K6-path] {T} steps of ({x.shape[1]}, {x.shape[2]}->{w.shape[1]}) "
        f"through spike_matmul_op(mode='auto'): {launched['K6']} K6 "
        f"launches, equal to one float64 product; densities "
        f"{min(dens):.4f}-{max(dens):.4f}, masked in {masked} of {T}")
    return {"launches": launched["K6"], "max_abs_err": err}


def _time_k3(dev) -> dict:
    """K3 at the 1x4 wide serve's three per-launch shapes: 1,024 lanes of
    784->512 and 2048->512 shards and the replicated 2048->10 head, at
    the wide stack's per-layer input densities, every neuron enabled."""
    rng = np.random.default_rng(SEED + 19)
    out = {}
    for n_in, n_out, dens in ((784, 512, 0.1367), (2048, 512, 0.1042),
                              (2048, 10, 0.0576)):
        x, en, wp, w = _k3_operands(rng, SERVE_BATCH, n_in, n_out, dens,
                                    "all", dev)

        def k3():
            return fused_snn.partial_contraction(x, en, wp, n_valid=n_out)

        ms = _device_ms(k3, 200)
        plain = _plain_ms(lambda: fused_snn.partial_contraction_plain(
            x, en, wp, n_valid=n_out), 10)
        xf = x[:, :n_in].float()
        wf = w[:n_in, :n_out].float()
        lib = _device_ms(lambda: torch.matmul(xf, wf), 200)
        if _max_abs_err(torch.matmul(xf, wf).to(torch.int32),
                        k3()[0][:, :n_out]):
            raise AssertionError("the float32 product is not exact here")
        nnz = int(x.sum())
        fn_bytes = (SERVE_BATCH * (n_in + n_out * 5) + n_in * n_out * 2
                    + SERVE_BATCH // fused_snn.BLOCK_B * 4)
        out[f"{n_in}->{n_out}"] = _bound(
            "K3", fn_bytes, nnz * n_out, ms, plain,
            f"B={SERVE_BATCH} {n_in}->{n_out} (input density "
            f"{nnz / (SERVE_BATCH * n_in):.4f}, every neuron enabled)", lib,
            tc_ops=2 * SERVE_BATCH * n_in * n_out * 2)
    return out


def _time_k6(dev) -> dict:
    """K6 in both realisations at (1,024, 2048->2048), 5.8% density."""
    rng = np.random.default_rng(SEED + 23)
    B, K, N = SERVE_BATCH, 2048, 2048
    s, w, _ = _k6_case(rng, B, K, N, 0.058, dev)
    xf, wf = s.float(), w.float()
    lib = _device_ms(lambda: torch.matmul(xf, wf), 50)
    nnz = int(s.count_nonzero())
    out = {}
    for mode in ("masked", "dot"):
        flag = torch.tensor(mode == "masked", device=dev)
        ms = _device_ms(lambda: spike_matmul.spike_matmul(s, w, flag), 50)
        plain = _plain_ms(
            lambda: spike_matmul.spike_matmul_plain(s, w, flag), 5)
        out[mode] = _bound(
            "K6", B * K + K * N * 2 + B * N * 4, nnz * N, ms, plain,
            f"{mode} B={B} {K}->{N} (density {nnz / (B * K):.4f})", lib,
            tc_ops=2 * B * K * N * 2)
    return out


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    checks = {"K1": phase_kernel_vs_plain(dev),
              "K2": phase_streamed_vs_plain(dev),
              "K3": phase_k3_vs_plain(dev),
              "K6": phase_k6_vs_plain(dev)}
    rng = np.random.default_rng(SEED + 1)
    params = _serve_params(rng)
    imgs = _images(rng, SERVE_REQUESTS)
    wide_params = _wide_params(rng)
    staged = phase_staged(dev, _on(wide_params, dev))
    serve = {"K1": phase_serve(imgs, params, cfgs.SNN_CONFIG, "K1", "fused"),
             "K2": phase_serve(imgs, wide_params, cfgs.SNN_CONFIG_WIDE, "K2",
                               "fused_streamed")}
    wide_want = serve["K2"].pop("results")
    k1_want = serve["K1"]["results"]
    serve["K3"] = phase_mesh_serve(imgs, wide_params, cfgs.SNN_CONFIG_WIDE,
                                   MESH_WIDE, SERVE_BATCH, wide_want, dev,
                                   profile=True)
    phase_mesh_serve(imgs[:SERVE_BATCH], wide_params, cfgs.SNN_CONFIG_WIDE,
                     (2, 2), SERVE_BATCH // 2, wide_want, dev)
    phase_mesh_serve(imgs, params, cfgs.SNN_CONFIG, (1, 2), SERVE_BATCH,
                     serve["K1"].pop("results"), dev)
    tier = {"tier": phase_tier(imgs, params, k1_want,
                               serve["K1"]["requests_per_s"]),
            "sharded": phase_sharded_tier(imgs[:SERVE_BATCH], params,
                                          k1_want, dev),
            "model_axis": phase_model_axis_ladder(
                imgs[:SERVE_BATCH], wide_params, wide_want, dev)}
    times = phase_times(imgs, params, wide_params, dev)
    staged["K6"] = times.pop("K6_path")
    # the per-launch time a kernel's row reports: K3 at its most frequent
    # serve shape (the 2048->512 shard), K6 masked (what auto picks at the
    # wide stack's densities); the others are kept beside it
    k3_shapes, k6_modes = times["K3"], times["K6"]
    times["K3"], times["K6"] = k3_shapes["2048->512"], k6_modes["masked"]
    record = []
    for tag, (name, source, replaces, _) in KERNELS.items():
        if tag in serve:
            cases, err = checks[tag]
            extra = {"launches": serve[tag]["launches"], "max_abs_err": err,
                     "cases": cases,
                     "requests_per_s": serve[tag]["requests_per_s"],
                     "chunks": serve[tag]["chunks"]}
        else:
            extra = dict(staged[tag])
        if tag == "K1":
            for k in ("serve_device_ms", "glue_device_ms", "copy_device_ms"):
                extra[k] = serve["K1"][k]
            extra["tier_launches"] = tier["tier"]["K1"]
            extra["sharded_tier_launches"] = tier["sharded"]["K1"]
            extra["tier_requests_per_s"] = tier["tier"]["requests_per_s"]
            extra["tier_clean_requests_per_s"] = \
                tier["tier"]["clean_requests_per_s"]
            extra["tier_chunks_by_rung"] = tier["tier"]["chunks_by_rung"]
        if tag == "K2":
            extra["serve_device_ms"] = serve["K2"]["serve_device_ms"]
            extra["grids"] = serve["K2"]["grids"]
            extra["tier_launches"] = tier["tier"]["K2"]
        if tag == "K3":
            extra["device_busy_ms"] = serve["K3"]["device_busy_ms"]
            extra["profiled_wall_ms"] = serve["K3"]["profiled_wall_ms"]
            extra["overlap_runs"] = serve["K3"]["overlap"]
            extra["shapes"] = k3_shapes
            extra["ladder_launches"] = tier["model_axis"]["K3"]
            extra["ladder_chunks_by_rung"] = \
                tier["model_axis"]["chunks_by_rung"]
        if tag == "K6":
            extra["cases"], extra["max_abs_err"] = checks["K6"][0], max(
                checks["K6"][1], extra["max_abs_err"])
            extra["dot"] = k6_modes["dot"]
        t = dict(times[tag])
        record.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": extra.pop("launches"),
            "max_abs_err": extra.pop("max_abs_err"), "ms": t.pop("ms"),
            "plain_ms": t.pop("plain_ms"), "bound_ms": t.pop("bound_ms"),
            "bound_by": t.pop("bound_by"), "library_ms": t.pop("library_ms"),
            "match": True, **t, **extra})
    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
