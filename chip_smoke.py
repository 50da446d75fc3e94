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
   off, int16 codes beyond the 9-bit range); the staged backend (K4 with
   its tallies and one K5 readout launch per layer, the telemetry and
   peaks from their epilogues) equal to the reference backend on the wide
   stack, and once more under ``torch.profiler`` for K5's own device time
   over its three launches; ``auto`` resolving to the staged kernels for a
   stack no stack kernel holds.
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
   5 + 5), each equal to the single-device run.  Then the same mesh as
   one process per rank (``phase_snn_ranks``): the script starts four
   rank processes of itself (``--snn-rank``), under ``nccl`` one a card
   where four cards are visible, else under ``gloo`` on the one card
   with the exchange staged through pinned host memory (a line says
   which and why); each serves the 4,096 WIDE requests on a 1×4 process
   mesh and 1,024 of them on a 2×2, through ``make_stream_engine`` with
   ``backend=None``: each rank's results equal the K2 run's id for id,
   and each rank launches K3 alone, one launch a layer and a step (3 at
   1×4).  A rank that fails or outlives ``RANK_TIMEOUT_S`` fails the
   run.  It prints each rank's K3 launches, rank 0's wall, rate and
   (traced once more) device busy share, the exchange's host ms a step,
   and the one-process 1×4 wall beside them.  The K6 path routes a
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
   Then the process-level cluster (``serve.cluster``): ``make_cluster``
   with 2 worker processes × 1,024 lanes, each its own CUDA context on
   the card, loading the built kernels, and each worker's promotion
   probe must report ``fused`` (K1); it serves the 4,096 784→10 requests
   with no plan, then under ``CLUSTER_PLAN`` (worker 1 killed at round 1,
   the coordinator at round 2, both while the workers hold active lanes)
   and ``ClusterCoordinator.recover`` on the same ledger; each run's
   results equal the K1 serve's id for id, none faulted or shed.  It
   prints the rounds, the failover stats, the wall time and rate, the
   host ms per round and the bytes of each ``step`` reply.  The workers'
   K1 launches happen in their processes and are not counted here.
   Then the tuner (``tune``): ``autotune_engine`` on ``SNN_CONFIG`` with
   ``backend=None`` on the card over ``TUNE_GRIDS`` (4,096 seeded
   requests, 1,024 a round), every candidate on K1 and bit-identical to
   the default shapes; its winner written with ``write_cache`` under a
   key naming the card, and a fresh ``SNNStreamEngine`` with that file
   hits it and serves the 4,096 requests with results equal to the K1
   serve's.
   Then training (``core.train_snn``): the port trains ``SNN_CONFIG`` on
   the card from the procedural digits (``data.digits.make_dataset``,
   6,000 training and 1,000 test images) by surrogate-gradient BPTT with
   QAT for 1,500 steps, the JAX package's budget (ms per step, the logged
   losses, and a ``torch.profiler`` trace of 20 more steps for the device
   busy share and the three device ops that take the most time);
   ``quantize_params`` must give int16 codes in [-256, 255];
   ``int_accuracy`` at T = 1, 5, 10 and 20 must run on K1 and reach 0.85
   at T=10 with T=20 >= T=1; K1 must equal the reference backend bit for
   bit on the trained codes; the pruned config on 200 test images must
   keep every neuron to one spike, make fewer adds and reach 0.6; the
   ANN→SNN route (1,500 steps) must reach 0.75 at T=20; and the test
   images, cycled to 4,096 requests, are served through K1 by
   ``make_stream_engine`` with results equal to a reference engine's id
   for id (served accuracy, mean steps, early-exit share, rate).  It
   prints one ``{"train": {...}}`` line.
   Then the LM serving path (``phase_lm``; the JAX package's LM path runs
   no Pallas kernel, so it launches none of K1-K6, which is checked):
   (a) the ten LM archs at ``get_reduced``, each built once by ``lm_init``
   on the card from a seeded generator and copied to the CPU: prefill
   logits, three teacher-forced decode steps and the prefill cache, card
   against CPU, and decode after prefill against the full forward, within
   ``LM_F32_REL_MAX``; (b) qwen3-4b at its published config and full depth
   (36 × 2560, 32q/8kv heads of 80, d_ff 9,728, vocab 151,936 padded to
   152,064; 16.23 GB of float32 weights computed in bfloat16) served by
   ``generate`` with the launcher's traffic (8 requests, prompt 32, 24
   generated, ``stability_gate(patience=3)``, ``max_len`` 57): the
   loop's tokens and active counts equal ``generate``'s, retired lanes
   stay frozen bit for bit, the active count never rises, every decode
   step's logits (gated, and once more with no early exit) match
   ``lm_apply(mode="train")`` over the tokens they fed, the same in
   float32, and a 2-layer cut at full width in bfloat16 matches its
   float32 twin (TF32 off), which matches float64 under a bound that
   TF32 and float16 runs of the twin are shown to fail.  It records
   prefill ms and decode ms a step (CUDA events) beside the step's bound
   (float32 weights cast to bf16 at each use; bf16 weights alone), peak
   memory, and a ``torch.profiler`` trace of one more ``generate`` (busy
   share, top device ops), and prints one ``{"lm": {...}}`` line.
   Then the LM training path (``phase_lm_train``; it launches none of
   K1-K6 either, which is checked): (a) one train step of each of the ten
   reduced archs (their own optimizer: AdamW, or Adafactor for five) on
   the card and on the CPU from the same parameters: loss, grad norm and
   the updated parameters within ``LM_TRAIN_REL_MAX``; (b) reduced
   qwen3-4b trained 6 steps straight against a run that crashes after
   step 4, restores its checkpoint (``CheckpointManager``) and replays 2
   steps, equal bit for bit under deterministic algorithms; (c) qwen3-4b
   at its published config and full depth trained by
   ``launch.train.train(..., reduced=False)``: AdamW, 8 sequences of
   1,024 tokens a step in 2 microbatches, lr 1e-3, token stream seed 0,
   10 steps, the loss finite and lower at step 10 than at step 1.  It
   records the step time (CUDA events between the steps' ends, steps
   3-10), tokens/s, peak memory, the step's bound (matmul work at the
   bf16 rate against the AdamW update's bytes) and a ``torch.profiler``
   trace of 2 more steps (busy share, top device ops), and prints one
   ``{"lm_train": {...}}`` line; its microbatch count comes from
   ``launch.specs.num_microbatches`` at one data shard.
   Then the placed LM path (``phase_lm_partition``; it launches none of
   K1-K6): a one-rank ``nccl`` process group and a 1×1 mesh with its
   process mesh, the parameters, prompts, cache and train state placed
   as DTensors by the production rules (``distributed.partition.place``).
   qwen3-4b at 36 × 2560 serves ``phase_lm``'s traffic through
   ``generate``, placed and unplaced from the same seed: the same tokens
   and active counts, every decode step's logits within
   ``LM_PART_REL_MAX`` of the unplaced ones; then one train step at full
   width with ``LM_PART_LAYERS`` layers, placed and unplaced from the same
   seed and batch, at the full learning rate (no warmup): loss, grad
   norm and both AdamW moments leaf by leaf within ``LM_TRAIN_REL_MAX``
   of the unplaced step's, each parameter's move within it of AdamW's
   first step from the placed moments (so a missing or wrong update on
   the local shards fails); the parameters' distance from the unplaced
   ones is printed in learning rates, not gated (AdamW's first step
   turns gradient noise that flips a sign into up to 2 lr).  It prints one ``{"lm_partition": {...}}`` line
   with the placed decode and train ms a step, peak memory and the c10d
   calls by kind of a ``torch.profiler`` trace.  No fallback: a process
   group or a placement that fails raises.  One card is one rank (NCCL
   refuses two ranks on one card), so nothing here is a multi-rank figure.
   Then the dry-run tooling (``phase_dryrun``; it launches none of K1-K6
   and allocates nothing on the card, which is checked around every
   dry-run): the training step ``phase_lm_train`` ran, run again on
   ``meta`` tensors placed on a 1×1 mesh under a one-rank ``fake``
   process group, as rank 0 of the placed program, under
   ``launch.op_cost``, must predict that phase's
   measured peak memory within ``DRYRUN_PEAK_REL`` and the step's
   products, reckoned from the model's shapes, within
   ``DRYRUN_FLOPS_REL``; ``phase_lm``'s decode step likewise its peak; and
   ``launch.dryrun.run_cell`` writes the record of qwen3-4b × decode_32k
   on the single-pod production mesh (rank 0 of 256 under a ``fake``
   group).  It prints one ``{"dryrun": {...}}``
   line with each prediction, measurement and ratio.
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
   add-only bound is kept beside it).  K4 and K5 are timed as the staged
   call launches them, with their tallies, each against its plain twin
   and with a bound from its own bytes: K4 at (20, 1,024, 784), its
   train-only launch beside it; K5's readout launch at (20, 1,024,
   2048→2048) as a hidden layer and at the 16384→10 head (padded to 128
   columns) as the last, its trace launch on the same operands beside
   each (``trace``).  K2 is
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

import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import io
import json
import re
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS reads its workspace setting once, at its first use: fixed here so
# that the training phase's resume check may run with deterministic
# algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch import train as lmtrain  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import snn_mnist as cfgs  # noqa: E402
from repro_torch.core import snn, train_snn  # noqa: E402
from repro_torch.core.prng import seed_state  # noqa: E402
from repro_torch.core.telemetry import tile_any  # noqa: E402
from repro_torch.data import digits  # noqa: E402
from repro_torch.kernels import (_build, fused_snn, lif_step, ops,  # noqa: E402
                                 poisson_encode, spike_matmul)
from repro_torch.distributed.partition import (  # noqa: E402
    batch_specs, cache_specs, param_specs, place, to_shardings,
    train_state_specs)
from repro_torch.distributed.sharding import (make_device_mesh,  # noqa: E402
                                              make_rules, use_rules)
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.launch import train as lm_launch  # noqa: E402
from repro_torch.launch.op_cost import op_cost  # noqa: E402
from repro_torch.optim import optimizer as lm_optim  # noqa: E402
from repro_torch.serve import (ClusterCoordinator,  # noqa: E402
                                CoordinatorCrash, FaultEvent, FaultInjector,
                                FaultPlan, FaultToleranceConfig,
                                RequestResult, SNNServingTier,
                                SNNStreamEngine, generate,
                                make_decode_step, make_prefill, pad_cache_to,
                                stability_gate)
from repro_torch.tune import (ArrivalSchedule, AutotuneConfig,  # noqa: E402
                              autotune_engine, write_cache)

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


# the staged call's launches of K5 (its readout instantiation; K4 has one
# kernel, counted in KERNELS)
READOUTS = {"K5": lif_step.lif_forward_readout}


def reset_counts() -> None:
    for fn in [fn for _, _, _, fn in KERNELS.values()] + list(
            READOUTS.values()):
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, (_, _, _, fn) in KERNELS.items()}


def readout_counts() -> dict:
    return {k: fn.launches for k, fn in READOUTS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


_LAP = [time.perf_counter()]


def _lap(what: str) -> None:
    """Log the seconds since the previous lap: each phase's share of the
    script's time limit."""
    now = time.perf_counter()
    log(f"[time] {what}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


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
    # and as the staged op hands it (1,024 x 784), its tallies as well
    tal = ops.staged_tallies(T_STAGED, 3, CHECK_BATCH, dev)
    got = ops.poisson_encode_readout_op(px, st, T_STAGED, tal)
    torch.cuda.synchronize()
    err_k4 = max(err_k4, _max_abs_err(
        (got[0][:, :CHECK_BATCH], got[1], tal.n_spk[:, 0, :CHECK_BATCH],
         tal.live_k[:, 0]), _k4_plain(px, st, T_STAGED)))
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
    staged_counts = {"K4": counts()["K4"],        # the staged path ended
                     "K5": readout_counts()["K5"]}
    if (staged_counts["K4"], staged_counts["K5"]) != (1, 3) \
            or counts()["K5"]:
        raise AssertionError(f"staged run launched {staged_counts}, "
                             f"{counts()}")
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
    before, before_r = counts(), readout_counts()
    res = snn.snn_apply_int(p, px[:, :64].contiguous(),
                            st[:, :64].contiguous(), narrow)
    torch.cuda.synchronize()
    after, after_r = counts(), readout_counts()
    if (after["K4"] - before["K4"], after_r["K5"] - before_r["K5"]) \
            != (1, 9) or dict(after, K4=0) != dict(before, K4=0):
        raise AssertionError(f"auto on 9 x 64 launched {before} -> {after}, "
                             f"readouts {before_r} -> {after_r}")
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
           "requests_per_s": len(results) / wall, "wall_s": wall}
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
# 4a. the SNN lane mesh as one process per rank
# ---------------------------------------------------------------------------

# (data, model, requests) of each rank serve, in order; the first is timed
# again under torch.profiler on rank 0
RANK_MESHES = ((1, 4, SERVE_REQUESTS), (2, 2, SERVE_BATCH))
RANK_TIMEOUT_S = 300


def _rank_form() -> tuple[str, str]:
    """The process group the ranks run under, and why."""
    n = torch.cuda.device_count()
    if n >= 4:
        return "nccl", f"{n} cards visible: one nccl rank a card"
    return "gloo", (f"{n} card(s) visible and nccl refuses two ranks on "
                    f"one card: four gloo ranks on cuda:0, the exchange "
                    f"staged through pinned host buffers")


def phase_snn_ranks(want, one_process) -> dict:
    """``SNN_CONFIG_WIDE`` served by four rank processes of this script,
    each one rank of the SPMD program (``make_stream_engine`` under a
    group of four: its own lane rows and weight shards, the spike
    exchange as collectives), on the ``RANK_MESHES``: every rank's
    results must equal ``want`` (the K2 serve's) id for id, and every
    rank must launch K3 alone, one launch a layer and a step.  A rank
    that fails or outlives ``RANK_TIMEOUT_S`` fails the phase."""
    form, why = _rank_form()
    log(f"[ranks] form {form}: {why}")
    out = ROOT / "build" / "snn_ranks"
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs, spawned = [], time.time()
    for r in range(4):
        with open(out / f"r{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--snn-rank",
                 str(r), str(port), form, str(out)],
                stdout=f, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1")))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > RANK_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:       # one failed rank leaves the rest waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        # the log of the first rank that was not killed here
        r = next((r for r, c in enumerate(codes) if c > 0), codes.index(
            next(c for c in codes if c)))
        raise AssertionError(
            f"rank exit codes {codes} after {time.perf_counter() - t0:.1f} "
            f"s (timeout {RANK_TIMEOUT_S} s); rank {r}:\n"
            + (out / f"r{r}.log").read_text()[-3000:])
    got = [json.loads((out / f"r{r}.json").read_text()) for r in range(4)]
    # each rank's timeline, in s after the spawn (wall clock): imported,
    # its first engine built, done
    marks = [[round(g["marks"][k] - spawned, 1) for k in
              ("imported", "built", "done")] for g in got]
    log(f"[ranks] the phase {time.perf_counter() - t0:.1f} s; by rank "
        f"[imported, first engine built, done] s after the spawn: {marks}")
    record = {"form": form, "marks": marks}
    for nd, md, n in RANK_MESHES:
        tag = f"{nd}x{md}"
        for r, g in enumerate(got):
            run = g[tag]
            res = {rid: RequestResult(rid, p, np.asarray(c), s, a, bool(e),
                                      v)
                   for rid, p, c, s, a, e, v in zip(
                       run["ids"], run["pred"], run["counts"], run["served"],
                       run["adds"], run["early"], run["version"])}
            if len(res) != n:
                raise AssertionError(f"rank {r}, {tag}: {len(res)} results "
                                     f"for {n}")
            _same_results(res, {rid: want[rid] for rid in res},
                          f"rank {r} on the {tag} process mesh vs K2")
        r0 = got[0][tag]
        ex_ms = [g[tag]["exchange_s"] * 1e3 / g[tag]["steps"] for g in got]
        log(f"[ranks] SNN_CONFIG_WIDE on a {tag} process mesh, {form}: "
            f"{n} requests, results equal to the K2 serve's id for id on "
            f"every rank; K3 launches by rank "
            f"{[g[tag]['launches']['K3'] for g in got]} "
            f"({r0['layers']} a step over {[g[tag]['steps'] for g in got]} "
            f"dispatched steps), no other kernel; rank 0: "
            f"{r0['wall_s']:.6f} s = {n / r0['wall_s']:.1f} requests/s, "
            f"{r0['stats']['chunks']} chunks (spec_used "
            f"{r0['stats']['spec_used']}, spec_wasted "
            f"{r0['stats']['spec_wasted']}); exchange host ms a step by "
            f"rank {[round(x, 4) for x in ex_ms]} over "
            f"{r0['exchanges']} exchanges")
        record[tag] = {
            "launches": [g[tag]["launches"] for g in got],
            "steps": [g[tag]["steps"] for g in got],
            "wall_s": r0["wall_s"], "requests_per_s": n / r0["wall_s"],
            "exchange_ms_per_step": ex_ms, "stats": r0["stats"]}
        if "busy_ms" in r0:
            record[tag].update(busy_ms=r0["busy_ms"],
                               profiled_wall_ms=r0["profiled_wall_ms"])
            log(f"[ranks] {tag} rank 0 device time from a torch.profiler "
                f"trace of one more identical serve: {r0['busy_ms']:.3f} ms "
                f"of its {r0['profiled_wall_ms']:.3f} ms wall = "
                f"{r0['busy_ms'] / r0['profiled_wall_ms'] * 100:.2f}% busy; "
                f"most device time (ms, calls): " + "; ".join(
                    f"{k[:60]} {ms:.3f} ({c})" for k, ms, c in r0["top"]))
    log(f"[ranks] the one-process 1x4 mesh of this run (one Python thread "
        f"driving the four shards): {one_process['wall_s']:.6f} s = "
        f"{one_process['requests_per_s']:.1f} requests/s for "
        f"{SERVE_REQUESTS} requests")
    return record


def _rank_serve(params, cfg, imgs, nd, md, devices, rank,
                profile) -> dict:
    """One rank's serve of ``imgs`` on an ``nd``×``md`` process mesh."""
    import torch.distributed as dist

    knobs = cfgs.SNNStreamMeshConfig(
        num_devices=nd, model_devices=md,
        lanes_per_device=SERVE_BATCH // nd, chunk_steps=SERVE_CHUNK)

    def engine():
        eng = cfgs.make_stream_engine(params, cfg, knobs, devices=devices,
                                      patience=SERVE_PATIENCE, seed=SEED)
        for im in imgs:
            eng.submit(im)
        return eng

    eng = engine()
    built = time.time()
    if eng.mesh.torch_mesh is None or eng.backend not in (
            "fused", "fused_streamed"):
        raise AssertionError(f"rank {rank}: torch mesh "
                             f"{eng.mesh.torch_mesh}, backend {eng.backend}")
    steps, ex = [0], [0.0, 0]
    advance, exchange = eng._advance, snn.exchange

    def counted(lanes, w):
        steps[0] += eng.controller.chunk_steps
        return advance(lanes, w)

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return exchange(*a, **kw)
        finally:
            ex[0] += time.perf_counter() - t
            ex[1] += 1

    eng._advance, snn.exchange = counted, timed
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()                                # the main path starts
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()                           # the main path ended
    snn.exchange = exchange
    layers = len(cfg.layer_sizes) - 1
    if launched["K3"] != layers * steps[0] or any(
            n for k, n in launched.items() if k != "K3"):
        raise AssertionError(f"rank {rank}: {launched} over {steps[0]} "
                             f"steps of {layers} layers")
    order = sorted(results)
    out = {"ids": order, "launches": launched, "steps": steps[0],
           "built": built,
           "layers": layers, "wall_s": wall, "exchange_s": ex[0],
           "exchanges": ex[1], "stats": eng.stats}
    for k, f in (("pred", "pred"), ("served", "steps"), ("adds", "adds"),
                 ("early", "early_exit"), ("version", "weight_version")):
        out[k] = [int(getattr(results[i], f)) for i in order]
    out["counts"] = [np.asarray(results[i].spike_counts).tolist()
                     for i in order]
    if profile:
        again = engine()
        dist.barrier()
        if rank == 0:
            busy, prof_ms, top = _device_busy_ms(again.run)
            out.update(busy_ms=busy, profiled_wall_ms=prof_ms, top=top)
        else:
            again.run()
            torch.cuda.synchronize()
    return out


def _snn_rank_main(argv) -> int:
    """A rank of ``phase_snn_ranks``: ``chip_smoke.py --snn-rank RANK
    PORT FORM OUT``."""
    import torch.distributed as dist

    imported = time.time()
    rank, port, form, out = int(argv[0]), int(argv[1]), argv[2], \
        Path(argv[3])
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    if form == "nccl":
        # as torchrun sets them: make_stream_mesh starts the nccl group
        # on card LOCAL_RANK
        os.environ.update(RANK=str(rank), WORLD_SIZE="4",
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        devices = None
    else:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=rank, world_size=4)
        devices = ["cuda:0"] * 4
    rng = np.random.default_rng(SEED + 1)      # main()'s draws, in order
    _serve_params(rng)
    imgs = _images(rng, SERVE_REQUESTS)
    wide = _wide_params(rng)
    got = {f"{nd}x{md}": _rank_serve(wide, cfgs.SNN_CONFIG_WIDE, imgs[:n],
                                     nd, md, devices, rank, profile=i == 0)
           for i, (nd, md, n) in enumerate(RANK_MESHES)}
    got["marks"] = {"imported": imported, "done": time.time(),
                    "built": got[f"{RANK_MESHES[0][0]}x"
                                 f"{RANK_MESHES[0][1]}"]["built"]}
    (out / f"r{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()
    return 0


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


# The cluster's faulted run: worker 1 dies at round 1, while both workers
# hold 1,024 active lanes, and the coordinator at round 2, while both hold
# lanes again (the rounds are deterministic: a CPU run at these sizes
# takes the same ones).  The recovery runs under the same plan, as the
# JAX package's contract test does, so it loses worker 1 at its round 1
# too.
CLUSTER_PLAN = "seed=0,worker_kill=1@1,coordinator_kill=2"
CLUSTER_KILL_ROUNDS = (1, 2)


def _cluster_kw(plan) -> dict:
    return dict(num_workers=2, lanes_per_worker=SERVE_BATCH,
                chunk_steps=SERVE_CHUNK, patience=SERVE_PATIENCE, seed=SEED,
                backend=None, fault_plan=plan)


def _run_cluster(co, imgs, crash=False) -> tuple[float, float]:
    """Submit ``imgs`` (ids 0..n-1; None for a recovered coordinator,
    whose ids are already submitted) and run; returns the wall seconds of
    the whole and of the submits.  With ``crash`` the plan's coordinator
    kill must end the run."""
    t0 = time.perf_counter()
    for im in () if imgs is None else imgs:
        co.submit(im)
    submit_s = time.perf_counter() - t0
    try:
        co.run()
    except CoordinatorCrash:
        if crash:
            return time.perf_counter() - t0, submit_s
        raise
    if crash:
        raise AssertionError("the plan's coordinator_kill did not fire")
    return time.perf_counter() - t0, submit_s


def _check_workers(co, what) -> list:
    backends = [h.backend if h.alive else f"dead ({h.error})"
                for h in co.workers]
    if backends != ["fused"] * len(co.workers):
        raise AssertionError(f"{what}: worker probes {backends}")
    return backends


def _per_round_ms(*tels) -> float:
    """Host ms per round over coordinators' ``telemetry``."""
    return sum(t["host_s"] for t in tels) / sum(
        t["rounds"] for t in tels) * 1e3


def _mean_reply_bytes(*tels) -> float:
    return sum(t["step_reply_bytes"] for t in tels) / sum(
        t["step_replies"] for t in tels)


def phase_cluster(imgs, params, want) -> dict:
    """``make_cluster``: 2 worker processes × 1,024 lanes on the card,
    each on K1; a clean run, then a worker kill and a coordinator kill
    recovered from the ledger, every result equal to the K1 serve's.
    The rounds' host time and the step replies' bytes and RPC time are
    the coordinators' own ``telemetry``."""
    with tempfile.TemporaryDirectory() as tmp:
        knobs = cfgs.SNNClusterConfig(
            num_workers=2, lanes_per_worker=SERVE_BATCH,
            chunk_steps=SERVE_CHUNK, backend=None,
            ledger_dir=os.path.join(tmp, "clean"))
        t0 = time.perf_counter()
        with cfgs.make_cluster(params, cfgs.SNN_CONFIG, knobs,
                               patience=SERVE_PATIENCE, seed=SEED) as co:
            spawn_s = time.perf_counter() - t0
            backends = _check_workers(co, "clean cluster")
            wall, submit_s = _run_cluster(co, imgs)
            results, stats = dict(co.results), dict(co.stats)
            clean = co.telemetry
            if co.faulted or co.shed or stats["workers_failed"]:
                raise AssertionError(f"clean cluster: {stats}")
        _same_results(results, want, "clean cluster vs the K1 serve")

        led = os.path.join(tmp, "faulted")
        with ClusterCoordinator(params, cfgs.SNN_CONFIG, ledger_dir=led,
                                **_cluster_kw(CLUSTER_PLAN)) as co:
            _check_workers(co, "faulted cluster")
            wall1, _ = _run_cluster(co, imgs, crash=True)
            stats1, done1 = dict(co.stats), len(co.results)
            crashed = co.telemetry
        at = dict(crashed["active_lanes"])
        if any(not all(at.get(r) or [0]) for r in CLUSTER_KILL_ROUNDS):
            raise AssertionError(f"the kills did not land while both "
                                 f"workers held lanes: {at}")
        if (stats1["workers_failed"], stats1["respawned"]) != (1, 1) \
                or stats1["evacuated"] == 0:
            raise AssertionError(f"faulted cluster: {stats1}")
        t0 = time.perf_counter()
        with ClusterCoordinator.recover(
                params, cfgs.SNN_CONFIG, ledger_dir=led,
                **_cluster_kw(CLUSTER_PLAN)) as co:
            recover_s = time.perf_counter() - t0
            _check_workers(co, "recovered cluster")
            folded = len(co.results)
            wall2, _ = _run_cluster(co, None)
            got, stats2 = dict(co.results), dict(co.stats)
            rec = co.telemetry
            _partition(co, len(imgs))
            if co.faulted or co.shed:
                raise AssertionError(f"recovered cluster: faulted "
                                     f"{len(co.faulted)}, shed "
                                     f"{len(co.shed)}")
        _same_results(got, want, "faulted + recovered cluster vs the "
                                 "K1 serve")
    rounds = clean["rounds"]
    log(f"[cluster] SNN_CONFIG 784->10, 2 worker processes x {SERVE_BATCH} "
        f"lanes on the card, chunk={SERVE_CHUNK} patience={SERVE_PATIENCE}: "
        f"worker probes {backends} (spawn + init + probe {spawn_s:.3f} s); "
        f"no plan: {len(results)} requests in {wall:.3f} s = "
        f"{len(results) / wall:.1f} requests/s: {len(results)} submit "
        f"RPCs {submit_s:.3f} s, then {rounds} rounds, "
        f"{_per_round_ms(clean):.3f} ms host per round; "
        f"{clean['step_replies']} step replies, mean "
        f"{_mean_reply_bytes(clean):.0f} B, largest "
        f"{clean['step_reply_max_bytes']} B; the step RPCs (worker chunk, "
        f"compaction, checkpoint encode, pipe, coordinator decode) take "
        f"{clean['step_rpc_s'] * 1e3:.3f} ms of the rounds' "
        f"{clean['host_s'] * 1e3:.3f}, the slowest "
        f"{clean['step_rpc_max_s'] * 1e3:.3f} ms against the "
        f"{FaultToleranceConfig().heartbeat_deadline_s} s heartbeat "
        f"deadline; routed per worker "
        f"{stats['routed_per_worker']}; results equal the K1 serve's id "
        f"for id")
    faulted_wall = wall1 + recover_s + wall2
    log(f"[cluster] the same under {CLUSTER_PLAN!r}: active lanes per "
        f"worker at the start of each round "
        f"{list(crashed['active_lanes'])}; crashed with {done1} results "
        f"in {wall1:.3f} s, stats {stats1}; recover "
        f"(ledger fold, spawn + init + probe) {recover_s:.3f} s from "
        f"{folded} results, then {rec['rounds']} rounds in "
        f"{wall2:.3f} s, stats {stats2}; {len(got)} results, none faulted "
        f"or shed, in {faulted_wall:.3f} s = "
        f"{len(got) / faulted_wall:.1f} requests/s end to end; "
        f"{_per_round_ms(crashed, rec):.3f} ms host per round; "
        f"{crashed['step_replies'] + rec['step_replies']} step replies, "
        f"mean {_mean_reply_bytes(crashed, rec):.0f} B; results "
        f"equal the K1 serve's id for id")
    return {"requests_per_s": len(results) / wall,
            "faulted_requests_per_s": len(got) / faulted_wall,
            "rounds": rounds,
            "faulted_rounds": crashed["rounds"] + rec["rounds"],
            "step_reply_mean_bytes": _mean_reply_bytes(clean),
            "round_host_ms": _per_round_ms(clean),
            "submit_s": submit_s,
            "slowest_step_ms": max(t["step_rpc_max_s"] for t in
                                   (clean, crashed, rec)) * 1e3,
            "workers_failed": stats1["workers_failed"]
            + stats2["workers_failed"],
            "evacuated": stats1["evacuated"] + stats2["evacuated"]}


# Tuner grids: lanes and chunk lengths around the serve cells' 1,024 and
# 4, the one batch block, the JAX package's threshold grid; every
# candidate the probe's pruning leaves is measured.
TUNE_GRIDS = dict(lanes_grid=(256, 1024, 4096), chunk_steps_grid=(2, 4, 8),
                  block_b_grid=(8,), threshold_grid=(0.1, 0.25, 0.4),
                  repeats=3, warmup=1, max_candidates=19)


def phase_tune(imgs, params, want, dev) -> dict:
    """``autotune_engine`` on the card through K1, its cache written and
    hit by a fresh engine that serves the 4,096 requests."""
    tc = AutotuneConfig(schedule=ArrivalSchedule(
        n_requests=SERVE_REQUESTS, per_round=SERVE_BATCH, seed=SEED),
        **TUNE_GRIDS)
    torch.cuda.synchronize()
    reset_counts()                                # the tuner's run starts
    t0 = time.perf_counter()
    result = autotune_engine(params, cfgs.SNN_CONFIG, tune_cfg=tc,
                             backend=None, patience=SERVE_PATIENCE,
                             seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()                           # the tuner's run ended
    if not result.bit_identical:
        raise AssertionError("a tuner candidate's results differ from the "
                             "default shapes'")
    if {r["backend"] for r in result.records} != {"fused"} or \
            result.probe["backend"] != "fused":
        raise AssertionError(f"tuner backends "
                             f"{[r['backend'] for r in result.records]}")
    if launched["K1"] == 0 or any(launched[k] for k in KERNELS if k != "K1"):
        raise AssertionError(f"the tuner launched {launched}")
    name = torch.cuda.get_device_name(0)
    for r in result.records:
        c = r["candidate"]
        log(f"[tune] lanes {c['lanes_per_device']} chunk {c['chunk_steps']} "
            f"block_b {c['block_b']} threshold {c['threshold']}: "
            f"{r['seconds_per_retired_request'] * 1e6:.3f} us per retired "
            f"request (median of {r['timing']['repeats']}, stddev "
            f"{r['timing']['stddev_s'] * 1e3:.3f} ms a serve)")
    t = result.tuned
    log(f"[tune] {len(result.records)} candidates in {wall:.3f} s, "
        f"{launched['K1']} K1 launches; probe {result.probe}; pruned "
        f"{result.pruned}; winner lanes {t.lanes_per_device} chunk "
        f"{t.chunk_steps} threshold {t.spike_density_threshold} on "
        f"{t.backend}: {t.seconds_per_retired_request * 1e6:.3f} us per "
        f"retired request against the default's "
        f"{result.baseline_spr * 1e6:.3f}; every candidate bit-identical")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dispatch_cache.json")
        keys = list(write_cache(result, path).entries)
        if result.device_kind != name or any(f"|{name}|" not in k
                                             for k in keys):
            raise AssertionError(f"cache keys {keys} for the card {name!r}")
        eng = SNNStreamEngine(params, cfgs.SNN_CONFIG,
                              patience=SERVE_PATIENCE, seed=SEED,
                              dispatch_cache=path)
    d = eng.cache_decision
    if not d.hit or eng.backend != t.backend or (
            eng.batch_size, eng.chunk_steps) != (t.lanes_per_device,
                                                 t.chunk_steps):
        raise AssertionError(f"tuned engine: {d}, backend {eng.backend}, "
                             f"{eng.batch_size} lanes, chunk "
                             f"{eng.chunk_steps}")
    for im in imgs:
        eng.submit(im)
    torch.cuda.synchronize()
    reset_counts()                                # the tuned serve starts
    t1 = time.perf_counter()
    got = eng.run()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t1
    served = counts()                             # the tuned serve ended
    _same_results(got, want, "the cache-armed engine vs the K1 serve")
    if served["K1"] == 0 or any(served[k] for k in KERNELS if k != "K1"):
        raise AssertionError(f"the tuned serve launched {served}")
    log(f"[tune] cache key {keys[0]!r}; a fresh SNNStreamEngine with "
        f"dispatch_cache= that file: hit, {eng.batch_size} lanes, chunk "
        f"{eng.chunk_steps}, {eng.backend}; served the {len(got)} requests "
        f"in {serve_wall:.3f} s = {len(got) / serve_wall:.1f} requests/s, "
        f"{served['K1']} K1 launches; results equal the K1 serve's id for "
        f"id")
    return {"launches": launched["K1"], "wall_s": wall,
            "candidates": len(result.records),
            "winner": {"lanes_per_device": t.lanes_per_device,
                       "chunk_steps": t.chunk_steps,
                       "threshold": t.spike_density_threshold},
            "winner_us_per_request": t.seconds_per_retired_request * 1e6,
            "default_us_per_request": result.baseline_spr * 1e6,
            "tuned_serve_launches": served["K1"],
            "tuned_requests_per_s": len(got) / serve_wall}


# ---------------------------------------------------------------------------
# 4c. training: the port trains its own 784->10 weights and serves them
# ---------------------------------------------------------------------------

TRAIN_STEPS = 1500            # the JAX package's fit_or_load budget
TRAIN_LOG_EVERY = 100
TRAIN_PROFILE_STEPS = 20
TRAIN_EVAL_T = (1, 5, 10, 20)
TRAIN_EVAL_SEED = 1234        # int_accuracy's PRNG seed of batch 0
TRAIN_PRUNED_IMAGES = 200


def _train_logged(cfg, ds, dev) -> tuple[dict, float, list]:
    """``train_bptt`` at the full budget with its log lines captured:
    the float params, the wall seconds (host clock after a synchronise)
    and the logged losses."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        params = train_snn.train_bptt(cfg, ds, steps=TRAIN_STEPS, seed=SEED,
                                      log_every=TRAIN_LOG_EVERY, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[train] {line.strip()}")
    losses = [float(re.search(r"loss ([0-9.]+)", line).group(1))
              for line in lines]
    if len(losses) != TRAIN_STEPS // TRAIN_LOG_EVERY:
        raise AssertionError(f"{len(losses)} logged losses")
    return params, wall, losses


def _k1_vs_reference(params_q, cfg, x, dev) -> int:
    """``int_accuracy``'s batches (the same pixels and PRNG seeds) through
    K1 and through the reference backend on the card: every output must
    be equal.  Returns the number of images compared."""
    keys = ("pred", "spike_counts", "active_adds", "first_spike_t",
            "v_final", "v_trace", "v_peak", "prng_state")
    for i in range(0, len(x), 500):
        px = torch.from_numpy((x[i:i + 500] * 255).astype(np.uint8)).to(dev)
        st = seed_state(TRAIN_EVAL_SEED + i, tuple(px.shape), device=dev)
        k = snn.snn_apply_int(params_q, px, st, cfg, backend="fused")
        r = snn.snn_apply_int(params_q, px, st, cfg, backend="reference")
        if _max_abs_err([k[n] for n in keys], [r[n] for n in keys]):
            raise AssertionError(f"K1 differs from the reference backend on "
                                 f"the trained codes, images {i}..")
    return len(x)


def _trained_engine(params_q, backend, dev):
    knobs = cfgs.SNNStreamMeshConfig(lanes_per_device=SERVE_BATCH,
                                     chunk_steps=SERVE_CHUNK)
    return cfgs.make_stream_engine(params_q, cfgs.SNN_CONFIG, knobs,
                                   devices=[dev], patience=SERVE_PATIENCE,
                                   seed=SEED, backend=backend)


def phase_train(dev, smi) -> dict:
    """Train ``SNN_CONFIG`` on the card by BPTT (and by conversion),
    quantize, score the codes through K1 (equal to the reference backend
    bit for bit), check the pruned engine, and serve the test images
    through K1.  Every gate raises."""
    cfg = cfgs.SNN_CONFIG
    t0 = time.perf_counter()
    ds = digits.make_dataset(seed=SEED)
    data_s = time.perf_counter() - t0
    log(f"[train] make_dataset(seed={SEED}): {ds.n_train} training and "
        f"{len(ds.y_test)} test images in {data_s:.2f} s (host)")
    params, wall, losses = _train_logged(cfg, ds, dev)
    ms_step = wall / TRAIN_STEPS * 1e3
    busy, prof_ms, top = _device_busy_ms(lambda: train_snn.train_bptt(
        cfg, ds, steps=TRAIN_PROFILE_STEPS, seed=SEED + 1, device=dev))
    log(f"[train] train_bptt {cfg.layer_sizes} T={cfg.num_steps} batch 128 "
        f"qat={cfg.qat}: {TRAIN_STEPS} steps in {wall:.3f} s = "
        f"{ms_step:.3f} ms/step (host clock); loss {losses[0]:.4f} at step "
        f"{TRAIN_LOG_EVERY} -> {losses[-1]:.4f} at {TRAIN_STEPS}; "
        f"{TRAIN_PROFILE_STEPS} more steps under torch.profiler: device "
        f"busy {busy:.3f} ms of {prof_ms:.3f} ms = "
        f"{busy / prof_ms * 100:.2f}%; most device time (ms, calls): "
        + "; ".join(f"{k[:60]} {ms:.3f} ({n})" for k, ms, n in top[:3]))

    params_q = snn.quantize_params(params, cfg)
    w_q = params_q["layers"][0]["w_q"]
    lo, hi = int(w_q.min()), int(w_q.max())
    if w_q.dtype != torch.int16 or lo < -256 or hi > 255:
        raise AssertionError(f"codes {w_q.dtype} in [{lo}, {hi}]")
    backend = snn.resolve_backend(cfg, None, 1, layer_sizes=cfg.layer_sizes,
                                  local_batch=500, device=dev)
    if backend != "fused":
        raise AssertionError(f"int_accuracy resolves to {backend!r}")
    torch.cuda.synchronize()
    reset_counts()                                # the scoring run starts
    acc = {t: train_snn.int_accuracy(params_q, cfg, ds.x_test, ds.y_test,
                                     num_steps=t, seed=TRAIN_EVAL_SEED,
                                     device=dev)
           for t in TRAIN_EVAL_T}
    scored = counts()                             # the scoring run ended
    if scored["K1"] == 0 or any(n for k, n in scored.items() if k != "K1"):
        raise AssertionError(f"int_accuracy launched {scored}")
    log(f"[train] int_accuracy on {len(ds.y_test)} test images through K1 "
        f"({scored['K1']} launches), codes in [{lo}, {hi}]: " + ", ".join(
            f"T={t} {a:.4f} ({aux['adds_per_img']:.1f} adds/image)"
            for t, (a, aux) in acc.items()))
    if acc[10][0] < 0.85 or acc[20][0] < acc[1][0]:
        raise AssertionError(f"accuracy {acc} below the band (0.85 at "
                             f"T=10, T=20 >= T=1)")
    n_eq = _k1_vs_reference(params_q, cfg, ds.x_test, dev)
    log(f"[train] K1 == reference backend on the trained codes, bit for "
        f"bit (pred, counts, adds, first spike, membranes, peaks, PRNG), "
        f"{n_eq} images at T={cfg.num_steps}")

    px = torch.from_numpy((ds.x_test[:TRAIN_PRUNED_IMAGES] * 255)
                          .astype(np.uint8)).to(dev)
    st = seed_state(5, tuple(px.shape), device=dev)
    reset_counts()
    on = snn.snn_apply_int(params_q, px, st, cfgs.SNN_CONFIG_PRUNED)
    off = snn.snn_apply_int(params_q, px, st, cfg)
    pruned_k1 = counts()["K1"]
    adds_on, adds_off = int(on["active_adds"].sum()), \
        int(off["active_adds"].sum())
    acc_on = float((on["pred"].cpu().numpy()
                    == ds.y_test[:TRAIN_PRUNED_IMAGES]).mean())
    max_count = int(on["spike_counts"].max())
    log(f"[train] SNN_CONFIG_PRUNED on {TRAIN_PRUNED_IMAGES} test images "
        f"through K1 ({pruned_k1} launches): accuracy {acc_on:.4f}, at most "
        f"{max_count} spike a neuron, {adds_on} adds against {adds_off} "
        f"unpruned")
    if pruned_k1 != 2 or max_count > 1 or adds_on >= adds_off \
            or acc_on < 0.6:
        raise AssertionError(f"pruned engine: K1 {pruned_k1}, max count "
                             f"{max_count}, adds {adds_on} vs {adds_off}, "
                             f"accuracy {acc_on}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = train_snn.train_converted(cfg, ds, steps=TRAIN_STEPS, seed=SEED,
                                     device=dev)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    conv_acc, _ = train_snn.int_accuracy(snn.quantize_params(conv, cfg), cfg,
                                         ds.x_test, ds.y_test, num_steps=20,
                                         device=dev)
    log(f"[train] train_converted: {TRAIN_STEPS} ANN steps and Diehl "
        f"normalisation in {conv_s:.3f} s = "
        f"{conv_s / TRAIN_STEPS * 1e3:.3f} ms/step; accuracy at T=20 "
        f"through K1 {conv_acc:.4f}")
    if conv_acc < 0.75:
        raise AssertionError(f"converted accuracy {conv_acc} < 0.75")

    imgs = (ds.x_test * 255).astype(np.uint8)
    labels = np.resize(ds.y_test, SERVE_REQUESTS)
    requests = np.resize(imgs, (SERVE_REQUESTS, imgs.shape[1]))
    eng = _trained_engine(params_q, "fused", dev)
    for im in requests:
        eng.submit(im)
    torch.cuda.synchronize()
    reset_counts()                                # the trained serve starts
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = counts()                             # the trained serve ended
    if served["K1"] == 0 or any(n for k, n in served.items() if k != "K1"):
        raise AssertionError(f"the trained serve launched {served}")
    ref = _trained_engine(params_q, "reference", dev)
    for im in requests:
        ref.submit(im)
    _same_results(results, ref.run(), "trained serve, K1 vs reference")
    if len(results) != SERVE_REQUESTS:
        raise AssertionError(f"{len(results)} results")
    preds = np.array([results[i].pred for i in range(SERVE_REQUESTS)])
    steps = np.array([results[i].steps for i in range(SERVE_REQUESTS)])
    early = np.array([results[i].early_exit for i in range(SERVE_REQUESTS)])
    serve = {"requests": SERVE_REQUESTS, "accuracy": float(
        (preds == labels).mean()), "mean_steps": float(steps.mean()),
        "early_exit_share": float(early.mean()), "K1_launches": served["K1"],
        "chunks": eng.stats["chunks"],
        "requests_per_s": SERVE_REQUESTS / serve_s}
    log(f"[train] trained serve: the {len(ds.y_test)} test images cycled to "
        f"{SERVE_REQUESTS} requests, make_stream_engine backend=fused batch "
        f"{SERVE_BATCH} chunk {SERVE_CHUNK} patience {SERVE_PATIENCE}: "
        f"accuracy {serve['accuracy']:.4f}, mean steps "
        f"{serve['mean_steps']:.2f}, early exits "
        f"{serve['early_exit_share'] * 100:.2f}%, {served['K1']} K1 "
        f"launches, {serve['requests_per_s']:.1f} requests/s (host clock); "
        f"results equal to the reference engine's id for id")
    out = {"card": smi, "dataset_s": data_s, "bptt_steps": TRAIN_STEPS,
           "ms_per_step": ms_step, "first_logged_loss": losses[0],
           "last_logged_loss": losses[-1], "profiled_steps":
           TRAIN_PROFILE_STEPS, "device_busy_ms": busy,
           "profiled_wall_ms": prof_ms, "device_busy_share": busy / prof_ms,
           "top_device_ops": [{"name": k, "ms": ms, "calls": n}
                              for k, ms, n in top[:3]],
           "codes_range": [lo, hi],
           "accuracy": {str(t): a for t, (a, _) in acc.items()},
           "adds_per_img": {str(t): aux["adds_per_img"]
                            for t, (_, aux) in acc.items()},
           "scoring_K1_launches": scored["K1"],
           "k1_equals_reference_images": n_eq,
           "pruned": {"accuracy": acc_on, "max_spike_count": max_count,
                      "adds": adds_on, "adds_unpruned": adds_off,
                      "K1_launches": pruned_k1},
           "converted": {"accuracy_T20": conv_acc, "seconds": conv_s},
           "serve": serve}
    print(json.dumps({"train": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 4b. the LM serving path
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-4b"          # the launcher's default arch
# the launcher's traffic: 8 requests, prompt 32, 24 generated, patience 3
LM_REQUESTS, LM_PROMPT, LM_GEN, LM_PATIENCE = 8, 32, 24, 3
LM_MAX_LEN = LM_PROMPT + LM_GEN + 1
LM_B, LM_S, LM_DEC = 2, 12, 3  # the reduced archs' batch, length, decodes
# Tolerances.  Each "rel max" is max|Δ| over the reference's max|logit|;
# each "rel RMS" is ‖Δ‖ / ‖reference‖.
# Card against CPU, and decode against the full forward, in float32
# (the reduced configs): an attention operand within an ulp of a bf16
# rounding boundary can round the other way (tests/test_torch_models.py).
LM_F32_REL_MAX = 1e-2
# qwen3-4b in bfloat16, decode against the full forward: the two compute
# the same sums in GEMMs of different shapes and round each sublayer's
# output and residual sum to bf16 (2^-8) at different points, 72 times
# over 36 layers; a random walk of those roundings is ~2e-2 of the RMS.
LM_BF16_REL_RMS = 5e-2
LM_BF16_REL_MAX = 1.5e-1
# The same 36 layers computed in float32, decode against the full forward:
# float32 sums, but bf16-rounded attention operands (as above), whose
# rounding flips the depth amplifies.
LM_F32_REL_RMS = 1e-2
# The 2-layer cut: bf16 against its float32 twin (two layers' bf16
# roundings: 8.3e-3 measured on the CPU at d_model 1,024), and the twin
# against float64 under 1e-3.  The twin sits above float64's 1e-7 only by
# the bf16-rounded attention operands' flips (5.0e-4 in that measurement);
# products with their operands rounded to 11 bits sit higher (TF32-rounded
# weights 2.5e-3, float16 3.2e-3 there), so a "float32" twin whose
# products ran in TF32 or float16 fails the bound: both are run to show it.
LM_CUT_BF16_REL_RMS = 2e-2
LM_CUT_F32_REL_RMS = 1e-3


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().to(want.device), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().to(want.device), want.double()
    return float((got - want).norm() / want.norm())


def _lm_inputs(cfg, rng, b, s) -> dict:
    """Seeded numpy inputs: tokens, and the vlm patches / whisper frames the
    stub frontends provide."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, s // 2)
        out["patches"] = rng.normal(0, 0.5, (b, p, cfg.d_model)) \
            .astype(np.float32)
        out["tokens"] = out["tokens"][:, :s - p]
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 0.5, (b, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return out


@torch.no_grad()
def _lm_reduced_run(model, cfg, nb) -> tuple:
    """Full forward, prefill on all but the last LM_DEC tokens, and LM_DEC
    teacher-forced decode steps."""
    d = model.embed.device
    b = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
    full = models.lm_apply(model, b, cfg, mode="train")[0]
    pre = dict(b, tokens=b["tokens"][:, :-LM_DEC])
    plog, cache, _ = models.lm_apply(model, pre, cfg, mode="prefill")
    kv = pad_cache_to(cache, plog.shape[1] + LM_DEC + 1)
    dec = []
    for i in range(LM_DEC):
        cur = torch.full((LM_B,), plog.shape[1] + i, dtype=torch.int32,
                         device=d)
        tok = b["tokens"][:, b["tokens"].shape[1] - LM_DEC + i][:, None]
        lg, kv, _ = models.lm_apply(model, {"tokens": tok}, cfg,
                                    mode="decode", cache=kv, cur_len=cur)
        dec.append(lg[:, 0])
    return full, plog, cache, dec


def _lm_reduced(dev) -> dict:
    """(a) Every arch at ``get_reduced`` on the card against the same model
    on the CPU, and decode after prefill against the full forward."""
    out = {}
    for arch in [a for a in lm_configs.list_archs() if a != "snn-mnist"]:
        cfg = lm_configs.get_reduced(arch)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        card = models.lm_init(cfg, generator=gen, device=dev)
        cpu = copy.deepcopy(card).to("cpu")
        nb = _lm_inputs(cfg, np.random.default_rng(SEED), LM_B, LM_S)
        c_full, c_pre, c_cache, c_dec = _lm_reduced_run(card, cfg, nb)
        h_full, h_pre, h_cache, h_dec = _lm_reduced_run(cpu, cfg, nb)
        err = {"prefill": _rel_max(c_pre, h_pre),
               "decode": max(_rel_max(c, h) for c, h in zip(c_dec, h_dec)),
               "cache": max(_rel_max(c, h)
                            for ce, he in zip(c_cache, h_cache)
                            for part in he
                            for c, h in zip(ce[part], he[part])),
               "decode_vs_full": max(
                   _rel_max(c, c_full[:, c_pre.shape[1] + i])
                   for i, c in enumerate(c_dec))}
        out[arch] = err
        log(f"[lm] {cfg.name}: card vs CPU rel max |Δ| prefill "
            f"{err['prefill']:.3e}, {LM_DEC} decode steps "
            f"{err['decode']:.3e}, prefill cache {err['cache']:.3e}; "
            f"decode vs full forward on the card {err['decode_vs_full']:.3e}"
            f" (bound {LM_F32_REL_MAX})")
        if max(err.values()) > LM_F32_REL_MAX or not all(
                torch.isfinite(x).all() for x in (c_full, c_pre, *c_dec)):
            raise AssertionError(f"{arch} reduced: {err}")
    return out


@torch.no_grad()
def _lm_loop(model, cfg, batch, gate, keep=True) -> dict:
    """``generate``'s loop on ``make_prefill`` / ``make_decode_step``, with
    a CUDA event after the prefill and after every step and no host sync
    in the loop.  ``keep`` keeps every step's state and logits (for the
    checks); the timed run keeps only the last, as ``generate`` does, so
    the allocator reuses each step's cache.  ``gate=None``: no early exit,
    so every step feeds a new position."""
    prefill = make_prefill(cfg, max_len=LM_MAX_LEN)
    decode = make_decode_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_GEN + 2)]
    ev[0].record()
    state, plog = prefill(model, batch)
    ev[1].record()
    states, logits = [state], []
    for t in range(LM_GEN):
        state, lg = decode(model, state)
        ev[t + 2].record()
        if gate is not None:
            state = state._replace(done=state.done
                                   | gate(state.last_token, lg))
        if keep:
            states.append(state)
            logits.append(lg)
    torch.cuda.synchronize()
    return {"prefill_logits": plog[:, -1], "states": states,
            "logits": logits, "last": state,
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "step_ms": [ev[t + 1].elapsed_time(ev[t + 2])
                        for t in range(LM_GEN)]}


@torch.no_grad()
def _lm_vs_full(model, cfg, prompt, run) -> tuple[float, float]:
    """Every decode step's logits against ``lm_apply(mode="train")`` over
    the token sequence the steps fed (a retired lane re-feeds its last
    token at its frozen length): (rel RMS, rel max) over all steps."""
    b = prompt.shape[0]
    seq = torch.zeros((b, LM_PROMPT + LM_GEN), dtype=torch.int32,
                      device=prompt.device)
    seq[:, :LM_PROMPT] = prompt
    lanes = torch.arange(b, device=prompt.device)
    for st in run["states"][:-1]:
        seq[lanes, st.cur_len.long()] = st.last_token
    full = models.lm_apply(model, {"tokens": seq}, cfg, mode="train")[0]
    got = torch.stack([run["prefill_logits"]] + run["logits"])
    want = torch.stack([full[:, LM_PROMPT - 1]] + [
        full[lanes, st.cur_len.long()] for st in run["states"][:-1]])
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{cfg.name}: logits are not finite")
    return _rel_rms(got, want), _rel_max(got, want)


def _lm_frozen(run) -> int:
    """Every retired lane keeps its cache rows, length and token bit for bit
    through each later step, and the active count never rises; returns
    the lane-steps checked."""
    checked = 0
    states = run["states"]
    for old, new in zip(states[:-1], states[1:]):
        d = old.done
        if not d.any():
            continue
        checked += int(d.sum())
        same = torch.equal(new.cur_len[d], old.cur_len[d]) and \
            torch.equal(new.last_token[d], old.last_token[d]) and all(
                torch.equal(n[d], o[d]) for ne, oe in zip(new.cache,
                                                          old.cache)
                for part in ne for n, o in zip(ne[part], oe[part]))
        if not same:
            raise AssertionError("a retired lane changed")
    active = [int((~s.done).sum()) for s in states[1:]]
    if any(b > a for a, b in zip(active, active[1:])):
        raise AssertionError(f"active rose: {active}")
    return checked


@torch.no_grad()
def _lm_cut(cfg, dev) -> dict:
    """(b2) A 2-layer cut of ``cfg`` at full width: bfloat16 against its
    float32 twin (TF32 off), the twin against float64, and float16 and
    TF32 runs against float64, on the same tokens."""
    cut = dataclasses.replace(cfg, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = models.lm_init(cut, generator=gen, device=dev)
    tokens = torch.randint(0, cut.vocab_size, (LM_REQUESTS, LM_MAX_LEN),
                           generator=gen, device=dev, dtype=torch.int32)

    def run(dtype, tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            c = dataclasses.replace(cut, compute_dtype=dtype)
            return models.lm_apply(model, {"tokens": tokens}, c)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 products")
    f64 = run("float64")
    f32 = run("float32")
    out = {"bf16_vs_f32": _rel_rms(run("bfloat16"), f32),
           "f32_vs_f64": _rel_rms(f32, f64),
           "tf32_vs_f64": _rel_rms(run("float32", tf32=True), f64),
           "f16_vs_f64": _rel_rms(run("float16"), f64)}
    log(f"[lm] {cut.name} cut to 2 layers at full width, {LM_REQUESTS} x "
        f"{LM_MAX_LEN} tokens, rel RMS: bf16 vs float32 twin "
        f"{out['bf16_vs_f32']:.3e} (bound {LM_CUT_BF16_REL_RMS}); float32 "
        f"(TF32 off) vs float64 {out['f32_vs_f64']:.3e} (bound "
        f"{LM_CUT_F32_REL_RMS}); the same bound fails TF32 "
        f"({out['tf32_vs_f64']:.3e}) and float16 ({out['f16_vs_f64']:.3e})")
    if out["bf16_vs_f32"] > LM_CUT_BF16_REL_RMS \
            or out["f32_vs_f64"] > LM_CUT_F32_REL_RMS \
            or out["tf32_vs_f64"] <= LM_CUT_F32_REL_RMS \
            or out["f16_vs_f64"] <= LM_CUT_F32_REL_RMS:
        raise AssertionError(f"2-layer cut: {out}")
    del model, f64, f32
    return out


def phase_lm(dev, smi) -> dict:
    """(a) The ten archs at ``get_reduced`` on the card against the CPU;
    (b) qwen3-4b at its published config, full depth, served by
    ``generate`` with the launcher's traffic, its decode steps held to the
    full forward, and a 2-layer cut held to float32 and float64.  Launches
    none of K1-K6.  Every gate raises."""
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    reduced = _lm_reduced(dev)

    cfg = lm_configs.get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = models.lm_init(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": prompt}
    kw = dict(steps=LM_GEN, max_len=LM_MAX_LEN)
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}q/{cfg.num_kv_heads}kv heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {n_params:,} parameters in "
        f"{cfg.param_dtype} ({n_params * 4 / 1e9:.2f} GB), computed in "
        f"{cfg.compute_dtype}; lm_init on the card {init_s:.2f} s")

    generate(model, batch, cfg, steps=2, max_len=LM_MAX_LEN,
             early_exit_fn=stability_gate(LM_REQUESTS, LM_PATIENCE,
                                          device=dev))       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks, active = generate(model, batch, cfg, **kw,
                            early_exit_fn=stability_gate(
                                LM_REQUESTS, LM_PATIENCE, device=dev))
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    active = active.tolist()
    if toks.shape != (LM_REQUESTS, LM_GEN) or \
            not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"generate: {toks.shape}, {toks.min()}, "
                             f"{toks.max()}")

    timed = _lm_loop(model, cfg, batch, stability_gate(
        LM_REQUESTS, LM_PATIENCE, device=dev), keep=False)
    run = _lm_loop(model, cfg, batch, stability_gate(
        LM_REQUESTS, LM_PATIENCE, device=dev))
    loop_toks = torch.stack([s.last_token for s in run["states"][1:]], 1)
    loop_active = [int((~s.done).sum()) for s in run["states"][1:]]
    if not torch.equal(loop_toks, toks) or loop_active != active or \
            not torch.equal(timed["last"].last_token, toks[:, -1]):
        raise AssertionError("the checked loop is not generate's run")
    frozen = _lm_frozen(run)
    rms_g, rmax_g = _lm_vs_full(model, cfg, prompt, run)
    del run
    # the same without early exit: every step feeds a new position
    run = _lm_loop(model, cfg, batch, None)
    rms, rmax = _lm_vs_full(model, cfg, prompt, run)
    step_ms = float(np.mean(timed["step_ms"]))
    log(f"[lm] generate: {LM_REQUESTS} requests x prompt {LM_PROMPT}, "
        f"{LM_GEN} generated, stability_gate(patience={LM_PATIENCE}), "
        f"max_len {LM_MAX_LEN}: {gen_ms:.1f} ms (host clock), active per "
        f"step {active} ({sum(active)}/{LM_REQUESTS * LM_GEN} lane-steps); "
        f"{frozen} retired lane-steps frozen bit for bit; decode vs full "
        f"forward (bf16), gated: rel RMS {rms_g:.3e}, rel max "
        f"{rmax_g:.3e}; ungated (positions {LM_PROMPT}-"
        f"{LM_PROMPT + LM_GEN - 1}): rel RMS {rms:.3e} (bound "
        f"{LM_BF16_REL_RMS}), rel max {rmax:.3e} (bound {LM_BF16_REL_MAX})")
    if max(rms, rms_g) > LM_BF16_REL_RMS or \
            max(rmax, rmax_g) > LM_BF16_REL_MAX:
        raise AssertionError(f"decode vs full forward: {rms}, {rmax}, "
                             f"{rms_g}, {rmax_g}")

    # per decode step: every weight but the embedding table (which is
    # gathered) read as float32, written and read again as bf16
    w_numel = n_params - model.embed.numel()
    cast_bytes, bf16_bytes = w_numel * (4 + 2 + 2), w_numel * 2
    bound_ms = cast_bytes / HBM_BYTES_PER_S * 1e3
    bf16_bound_ms = bf16_bytes / HBM_BYTES_PER_S * 1e3
    busy, prof_ms, top = _device_busy_ms(lambda: generate(
        model, batch, cfg, **kw, early_exit_fn=stability_gate(
            LM_REQUESTS, LM_PATIENCE, device=dev)))
    log(f"[lm] prefill {timed['prefill_ms']:.3f} ms, decode "
        f"{step_ms:.3f} ms a step (CUDA events, mean of {LM_GEN}; min "
        f"{min(timed['step_ms']):.3f}, max {max(timed['step_ms']):.3f}); "
        f"bound "
        f"{bound_ms:.3f} ms a step ({cast_bytes / 1e9:.2f} GB: float32 "
        f"weights cast to bf16 at each use), {bf16_bound_ms:.3f} ms for "
        f"bf16 weights alone ({bf16_bytes / 1e9:.2f} GB); peak memory "
        f"{peak_gb:.2f} GB; one more generate under torch.profiler: device "
        f"busy {busy:.3f} ms of {prof_ms:.3f} ms = "
        f"{busy / prof_ms * 100:.2f}%; most device time (ms, calls): "
        + "; ".join(f"{k[:60]} {ms:.3f} ({n})" for k, ms, n in top[:3]))

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    run32 = _lm_loop(model, cfg32, batch, None)
    rms32, rmax32 = _lm_vs_full(model, cfg32, prompt, run32)
    timed32 = _lm_loop(model, cfg32, batch, None, keep=False)
    log(f"[lm] the same {cfg.num_layers} layers computed in float32, no "
        f"early exit: decode vs full forward rel RMS {rms32:.3e} (bound "
        f"{LM_F32_REL_RMS}), rel max {rmax32:.3e}; decode "
        f"{np.mean(timed32['step_ms']):.3f} ms a step (CUDA events)")
    if rms32 > LM_F32_REL_RMS:
        raise AssertionError(f"float32 decode vs full forward: {rms32}")
    prefill_ms, timed_steps = timed["prefill_ms"], timed["step_ms"]
    step32_ms = float(np.mean(timed32["step_ms"]))
    del model, run, run32, timed, timed32, toks
    gc.collect()
    torch.cuda.empty_cache()
    cut = _lm_cut(cfg, dev)
    launched = counts()
    if any(launched.values()):
        raise AssertionError(f"the LM path launched {launched}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi, "reduced": reduced, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "padded_vocab": cfg.padded_vocab, "params": n_params,
           "requests": LM_REQUESTS, "prompt": LM_PROMPT, "gen": LM_GEN,
           "patience": LM_PATIENCE, "active": active,
           "generate_ms": gen_ms, "prefill_ms": prefill_ms,
           "decode_ms_per_step": step_ms,
           "decode_ms_per_step_f32": step32_ms,
           "bound_ms_per_step": bound_ms,
           "bf16_weights_bound_ms_per_step": bf16_bound_ms,
           "peak_memory_gb": peak_gb, "device_busy_ms": busy,
           "profiled_wall_ms": prof_ms, "device_busy_share": busy / prof_ms,
           "top_device_ops": [{"name": k, "ms": ms, "calls": n}
                              for k, ms, n in top[:3]],
           "step_ms": timed_steps,
           "frozen_lane_steps": frozen, "decode_vs_full_rel_rms": rms,
           "decode_vs_full_rel_max": rmax,
           "decode_vs_full_gated_rel_rms": rms_g,
           "decode_vs_full_gated_rel_max": rmax_g,
           "decode_vs_full_rel_rms_f32": rms32,
           "decode_vs_full_rel_max_f32": rmax32, "cut": cut}
    print(json.dumps({"lm": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 4c. the LM training path
# ---------------------------------------------------------------------------

# qwen3-4b's training traffic: 8 sequences of 1,024 tokens a step in the
# microbatches launch.specs.num_microbatches gives at one data shard (2 of
# 4), AdamW, lr 1e-3, token stream seed 0, 10 steps, no checkpoint (a full
# state is 65 GB of disk)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 1024
LM_TRAIN_SHAPE = lm_configs.ShapeConfig("lm_train", LM_TRAIN_SEQ,
                                        LM_TRAIN_BATCH, "train")
LM_TRAIN_STEPS, LM_TRAIN_LR = 10, 1e-3
LM_TRAIN_TIMED = (3, 10)      # the steps whose CUDA-event times are kept
LM_TRAIN_PROFILED = 2         # steps traced by torch.profiler after them
LM_RESUME_STEPS, LM_RESUME_CRASH = 6, 4
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores (data sheet)
# Card against CPU after one step of each reduced arch: loss, grad norm and
# the updated parameters' max |Δ| over the CPU's max |p|, as phase_lm's
# bound (bf16-rounded attention operands can flip in one package).
LM_TRAIN_REL_MAX = 1e-2


def _lm_train_settings(micro: int):
    """``launch.train.train``'s settings for phase_lm_train's run."""
    return lmtrain.TrainSettings(
        learning_rate=LM_TRAIN_LR, warmup_steps=max(LM_TRAIN_STEPS // 10, 1),
        total_steps=LM_TRAIN_STEPS, num_microbatches=micro)


def _lm_train_inputs(cfg, rng, b, s) -> dict:
    """Seeded numpy tokens and next-token labels, plus the vlm patches /
    whisper frames the stub frontends provide."""
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, s // 2)
        out["patches"] = rng.normal(0, 0.5, (b, p, cfg.d_model)) \
            .astype(np.float32)
        out["tokens"] = out["tokens"][:, :s - p]
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 0.5, (b, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return out


def _lm_train_reduced(dev) -> dict:
    """(a) One train step of every arch at ``get_reduced`` on the card and
    on the CPU from the same parameters (drawn on the card, copied), with
    the arch's optimizer (Adafactor for five)."""
    out = {}
    s = lmtrain.TrainSettings(learning_rate=LM_TRAIN_LR, warmup_steps=0)
    for arch in [a for a in lm_configs.list_archs() if a != "snn-mnist"]:
        cfg = lm_configs.get_reduced(arch)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        card = lmtrain.init_state(gen, cfg, s, device=dev)
        host_model = copy.deepcopy(card.params).to("cpu")
        host = lmtrain.init_state(None, cfg, s, lambda g: host_model,
                                  device="cpu")
        nb = _lm_train_inputs(cfg, np.random.default_rng(SEED), LM_B, LM_S)
        step = lmtrain.make_train_step(cfg, s)
        card, cm = step(card, nb)
        host, hm = step(host, nb)
        cp = dict(card.params.named_parameters())
        hp = dict(host.params.named_parameters())
        scale = max(float(p.detach().abs().max()) for p in hp.values())
        err = {"loss": abs(float(cm["loss"]) / float(hm["loss"]) - 1),
               "grad_norm": abs(float(cm["grad_norm"])
                                / float(hm["grad_norm"]) - 1),
               "params": max(float((cp[n].detach().cpu() - p.detach())
                                   .abs().max()) for n, p in hp.items())
               / scale}
        out[arch] = dict(err, optimizer=cfg.optimizer)
        log(f"[lm-train] {cfg.name} ({cfg.optimizer}): one step card vs "
            f"CPU, rel |Δ| loss {err['loss']:.3e}, grad norm "
            f"{err['grad_norm']:.3e}, updated params max "
            f"{err['params']:.3e} (bound {LM_TRAIN_REL_MAX})")
        if max(err.values()) > LM_TRAIN_REL_MAX or not all(
                torch.isfinite(p).all() for p in cp.values()):
            raise AssertionError(f"{arch} reduced train step: {err}")
    return out


def _lm_train_resume(dev) -> dict:
    """(b) Reduced qwen3-4b: 6 steps straight against a run that crashes
    after step 4 (``fail_at_step``), restores its step-4 checkpoint and
    replays 2 steps; every parameter and optimizer state equal bit for bit.
    Deterministic algorithms on (the card's atomics would otherwise be
    free to reorder sums)."""
    cfg = lm_configs.get_reduced(LM_ARCH)
    s = lmtrain.TrainSettings(learning_rate=LM_TRAIN_LR)
    step = lmtrain.make_train_step(cfg, s)

    def fresh():
        return lmtrain.init_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, s,
            device=dev)

    def batches():
        return lm_launch.make_batches(cfg, LM_B, 2 * LM_S)

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            loop = lmtrain.TrainLoop(step, fresh(), ckpt_manager=mgr,
                                     ckpt_every=2)
            try:
                loop.run(batches(), 2 * LM_RESUME_STEPS,
                         fail_at_step=LM_RESUME_CRASH)
            except RuntimeError as e:         # the injected failure
                if "injected failure" not in str(e):
                    raise
            else:
                raise AssertionError("fail_at_step raised nothing")
            mgr.wait()
            ref, gen = fresh(), batches()
            for _ in range(LM_RESUME_STEPS):
                ref, _ = step(ref, next(gen))
            restored, at = mgr.restore(fresh(), device=dev)
            gen = batches()
            for _ in range(at):
                next(gen)           # the data pipeline skips replayed steps
            final = lmtrain.TrainLoop(step, restored).run(
                gen, LM_RESUME_STEPS - at)
    finally:
        torch.use_deterministic_algorithms(prev)
    rp, fp = dict(ref.params.named_parameters()), \
        dict(final.params.named_parameters())
    trees = [(f"{k}.{n}", t, getattr(final.opt_state, k)[n])
             for k in ref.opt_state._fields[1:]
             for n, t in getattr(ref.opt_state, k).items()]
    differ = [n for n in rp if not torch.equal(rp[n], fp[n])] + \
        [n for n, a, b in trees if not torch.equal(a, b)]
    log(f"[lm-train] resume: {LM_RESUME_STEPS} steps straight vs a crash "
        f"after step {LM_RESUME_CRASH}, restore of step {at} and "
        f"{LM_RESUME_STEPS - at} replayed: {len(rp)} parameters and "
        f"{len(trees)} optimizer leaves, {len(differ)} differ (bit for bit, "
        f"deterministic algorithms)")
    if differ or at != LM_RESUME_CRASH or final.step != LM_RESUME_STEPS \
            or final.opt_state.step != ref.opt_state.step:
        raise AssertionError(f"resume: step {at}, differ {differ[:5]}")
    return {"restored_step": at, "leaves": len(rp) + len(trees)}


def _lm_train_bound(model, cfg, tokens) -> dict:
    """The step's least time on the card: the larger of (i) its matmul
    work, 8·N·T (forward, backward and the remat forward over N matmul
    parameters, the tied head included, and T tokens) plus causal
    attention's 8·B·H·S²·hd per layer, at the bf16 tensor cores' rate, and
    (ii) the AdamW update's traffic (read p, g, mu, nu; write p, mu, nu:
    28 bytes a parameter) at the HBM rate.  They run in sequence in this
    step, so their sum is kept beside it, and so are the products the step
    itself runs (``step_flops``), which phase_dryrun's count must meet."""
    named = dict(model.named_parameters())
    n_mm = sum(p.numel() for n, p in named.items()
               if p.dim() >= 2 and n != "embed")
    if cfg.tie_embeddings:
        n_mm += named["embed"].numel()
    attn = 8 * LM_TRAIN_BATCH * cfg.num_heads * LM_TRAIN_SEQ ** 2 \
        * cfg.head_dim * cfg.num_layers
    flops = 8 * n_mm * tokens + attn
    # The products the step runs differ from 8·N·T in three named terms:
    # the head (outside the layers torch.utils.checkpoint wraps) is not
    # recomputed; the recomputation stops at the last tensor the backward
    # needs, so no layer's w2 product (its output) is rerun; and both
    # attention products run over the whole S×S square, the causal mask
    # applied to the scores, twice the causal count above.
    head = n_mm - sum(p.numel() for n, p in named.items()
                      if p.dim() >= 2 and n.startswith("layers."))
    w2 = sum(p.numel() for n, p in named.items() if n.endswith("mlp.w2"))
    terms = {"head_not_recomputed": -2 * head * tokens,
             "w2_not_recomputed": -2 * w2 * tokens,
             "attention_full_square": attn}
    opt_bytes = 28 * sum(p.numel() for p in named.values())
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"matmul_params": n_mm, "flops": flops, "attention_flops": attn,
            "step_flops": flops + sum(terms.values()),
            "step_flops_terms": terms,
            "ops_ms": ops_ms, "optimizer_bytes": opt_bytes,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "serial_ms": ops_ms + bytes_ms}


def phase_lm_train(dev, smi) -> dict:
    """(a) One train step of the ten reduced archs, card against CPU;
    (b) resume after an injected failure, bit for bit on the card;
    (c) qwen3-4b at its published config and full depth trained through
    ``launch.train.train(..., reduced=False)``.  Launches none of K1-K6.
    Every gate raises."""
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    reduced = _lm_train_reduced(dev)
    resume = _lm_train_resume(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = lm_configs.get_config(LM_ARCH)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    micro = launch_specs.num_microbatches(cfg, LM_TRAIN_SHAPE, 1)
    ends = []

    def hook(rec):             # the loop calls it after synchronising
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = lm_launch.train(
        LM_ARCH, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
        seq=LM_TRAIN_SEQ, reduced=False, lr=LM_TRAIN_LR,
        microbatches=micro, metrics_hook=hook, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = state.params
    n_params = sum(p.numel() for p in model.parameters())
    a, b = LM_TRAIN_TIMED
    step_ms = [ends[k - 2].elapsed_time(ends[k - 1])
               for k in range(a, b + 1)]
    med = float(np.median(step_ms))
    losses = [r["loss"] for r in hist]
    if len(hist) != LM_TRAIN_STEPS or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"qwen3-4b training losses {losses}")

    # two more steps under torch.profiler, with train()'s settings
    step = lmtrain.make_train_step(cfg, _lm_train_settings(micro))
    more = lm_launch.make_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                  seed=SEED + 1)
    box = [state]

    def two_steps():
        for _ in range(LM_TRAIN_PROFILED):
            box[0], m = step(box[0], next(more))
        return float(m["loss"])

    _, prof_ms, events = _cuda_events(two_steps)
    events.sort(key=lambda o: -o[1])
    busy, top = sum(ms for _, ms, _ in events), events[:8]
    gemm_ms = sum(ms for k, ms, _ in events if re.search(
        r"gemm|nvjet|cutlass|xmma", k, re.I))
    bound = _lm_train_bound(model, cfg, tokens)
    launched = counts()
    if any(launched.values()):
        raise AssertionError(f"the LM training path launched {launched}")
    log(f"[lm-train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}q/{cfg.num_kv_heads}kv heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {n_params:,} parameters, {cfg.optimizer}; "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens a step in "
        f"{micro} microbatches, lr {LM_TRAIN_LR}, "
        f"{LM_TRAIN_STEPS} steps in {train_s:.2f} s (host clock, lm_init "
        f"included); loss step 1 {losses[0]:.4f}, step "
        f"{LM_TRAIN_STEPS} {losses[-1]:.4f}")
    log(f"[lm-train] step time (CUDA events between steps' ends, steps "
        f"{a}-{b}): median {med:.3f} ms, range {min(step_ms):.3f}-"
        f"{max(step_ms):.3f} ms; {tokens / med * 1e3:,.1f} tokens/s; "
        f"peak memory {peak_gb:.2f} GB; {smi}")
    log(f"[lm-train] bound {bound['bound_ms']:.3f} ms a step "
        f"({bound['bound_by']}: {bound['flops'] / 1e12:.2f} TFLOP at "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 = "
        f"{bound['ops_ms']:.3f} ms, {bound['matmul_params']:,} matmul "
        f"parameters, attention {bound['attention_flops'] / 1e12:.2f} "
        f"TFLOP of it; AdamW traffic {bound['optimizer_bytes'] / 1e9:.2f}"
        f" GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bound['bytes_ms']:.3f} ms; serial sum {bound['serial_ms']:.3f}"
        f" ms): the median step is {bound['bound_ms'] / med * 100:.2f}% "
        f"of it; {smi}")
    log(f"[lm-train] {LM_TRAIN_PROFILED} more steps under torch.profiler: "
        f"device busy {busy:.3f} ms of {prof_ms:.3f} ms = "
        f"{busy / prof_ms * 100:.2f}%, the GEMMs {gemm_ms:.3f} ms of it "
        f"({gemm_ms / busy * 100:.2f}%); most device time (ms, calls): "
        + "; ".join(f"{k[:60]} {ms:.3f} ({n})" for k, ms, n in top[:5]))
    out = {"card": smi, "reduced": reduced, "resume": resume,
           "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "padded_vocab": cfg.padded_vocab,
           "params": n_params, "optimizer": cfg.optimizer,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "microbatches": micro, "steps": LM_TRAIN_STEPS,
           "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": tokens / med * 1e3,
           "wall_s": [r["wall_s"] for r in hist], "train_s": train_s,
           "peak_memory_gb": peak_gb, "device_busy_ms": busy,
           "profiled_wall_ms": prof_ms, "device_busy_share": busy / prof_ms,
           "gemm_device_ms": gemm_ms,
           "top_device_ops": [{"name": k, "ms": ms, "calls": n}
                              for k, ms, n in top],
           "bound": bound, "bound_share": bound["bound_ms"] / med}
    del state, box, model, step
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"lm_train": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 4d. the placed LM path: a one-rank nccl group, a 1×1 process mesh
# ---------------------------------------------------------------------------

# The train step's depth at full width: 12 layers peak at 43.5 GB (the
# dry-run, launch.op_cost on meta), leaving room under 60 GB for the
# placed copy's bookkeeping (the 36-layer step peaks at 79.6 of 80 GB)
LM_PART_LAYERS = 12
LM_PART_TRAIN_STEPS = 4        # placed steps timed after the checked one
# placed against unplaced: phase_lm's bf16 bound on the logits
LM_PART_REL_MAX = 1e-2
# the other families placed at their published widths, cut in depth:
# jamba's first 5 layers hold 4 Mamba-2 layers, the attention layer at 4,
# MoE at 1 and 3 (7.2 G float32 parameters, 28.6 GB); llava's step at 2
# layers (2.1 G, with 4 × (2,880 patches + 256 tokens) in 2 microbatches)
LM_PART_JAMBA_LAYERS = 5
LM_PART_LLAVA_LAYERS = 2
LM_PART_LLAVA_BATCH, LM_PART_LLAVA_TEXT = 4, 256
LM_PART_PEAK_GB = 70.0


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _c10d_calls(run) -> tuple:
    """``run()`` under ``torch.profiler``: its result and the collectives
    of the trace: the functional c10d calls by kind (DTensor's and the
    regions' own; their waits left out) and the NCCL kernels launched."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    calls: dict = {}
    for e in prof.key_averages():
        name = e.key
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in name.lower():
                calls["nccl_kernels"] = calls.get("nccl_kernels", 0) + \
                    e.count
        elif name.startswith("_c10d_functional::") and not any(
                w in name for w in ("wait", "wrap")):
            kind = name.split("::", 1)[1]
            calls[kind] = calls.get(kind, 0) + e.count
    return out, calls


def phase_lm_partition(dev, smi) -> dict:
    """qwen3-4b placed on a 1×1 mesh over a one-rank ``nccl`` group:
    ``generate`` at 36 × 2560 and a full-width train step of
    ``LM_PART_LAYERS`` layers; then jamba (5 layers) and whisper-small
    serving and a llava Adafactor train step, all at their published
    widths; each against the unplaced run of the same seeds.  Launches
    none of K1-K6.  Every gate raises."""
    import torch.distributed as dist

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    dev = torch.device(dev.type, torch.cuda.current_device()
                       if dev.index is None else dev.index)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        out = _lm_partition(dev, smi)
    finally:
        dist.destroy_process_group()
    launched = counts()
    if any(launched.values()):
        raise AssertionError(f"the placed LM path launched {launched}")
    print(json.dumps({"lm_partition": out}), flush=True)
    return out


def _lm_partition(dev, smi) -> dict:
    mesh = make_device_mesh((1, 1), ("data", "model"), devices=[dev])
    if mesh.torch_mesh is None:
        raise AssertionError("no process mesh over the one-rank group")
    cfg = lm_configs.get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = models.lm_init(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    kw = dict(steps=LM_GEN, max_len=LM_MAX_LEN)

    def gate():
        return stability_gate(LM_REQUESTS, LM_PATIENCE, device=dev)

    toks, active = generate(model, {"tokens": prompt}, cfg, **kw,
                            early_exit_fn=gate())
    plain_ms = float(np.mean(_lm_loop(model, cfg, {"tokens": prompt}, None,
                                      keep=False)["step_ms"]))
    plain = _lm_loop(model, cfg, {"tokens": prompt}, None)
    plain_logits = [lg.float() for lg in plain["logits"]]
    plain_toks = torch.stack([st.last_token for st in plain["states"][1:]],
                             1)
    del plain
    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        model = place(model, to_shardings(mesh, rules, param_specs(
            cfg, model), model), mesh)
        batch = {"tokens": prompt}
        batch = place(batch, to_shardings(mesh, rules, batch_specs(batch),
                                          batch), mesh)
        generate(model, batch, cfg, steps=2, max_len=LM_MAX_LEN,
                 early_exit_fn=gate())                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p_toks, p_active = generate(model, batch, cfg, **kw,
                                    early_exit_fn=gate())
        torch.cuda.synchronize()
        serve_peak = torch.cuda.max_memory_allocated() / 1e9
        run = _lm_loop(model, cfg, batch, None)
        timed = _lm_loop(model, cfg, batch, None, keep=False)
        _, serve_calls = _c10d_calls(lambda: generate(
            model, batch, cfg, **kw, early_exit_fn=gate()))
    run_toks = torch.stack([st.last_token.full_tensor()
                            for st in run["states"][1:]], 1)
    err = max(_rel_max(lg.full_tensor().float(), want)
              for lg, want in zip(run["logits"], plain_logits))
    same = torch.equal(p_toks, toks) and torch.equal(p_active, active) \
        and torch.equal(run_toks, plain_toks)
    step_ms, steps_ms = float(np.mean(timed["step_ms"])), timed["step_ms"]
    log(f"[lm-partition] {cfg.name} placed on a 1x1 mesh over a one-rank "
        f"nccl group ({LM_REQUESTS} requests x prompt {LM_PROMPT}, "
        f"{LM_GEN} generated): tokens and active counts "
        f"{'equal' if same else 'DIFFER'} to the unplaced run; decode "
        f"logits rel max |Δ| {err:.3e} (bound {LM_PART_REL_MAX}); decode "
        f"{step_ms:.3f} ms a step placed, {plain_ms:.3f} unplaced (CUDA "
        f"events, mean of {LM_GEN} each, the same call); peak "
        f"{serve_peak:.2f} GB; collectives of one generate {serve_calls}; "
        f"{smi}")
    if not same or err > LM_PART_REL_MAX or not all(
            torch.isfinite(lg.full_tensor()).all() for lg in run["logits"]):
        raise AssertionError(f"placed generate: same={same}, err={err}")
    del model, batch, run, timed, plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    train = _lm_partition_train(dev, mesh)
    jamba = _lm_partition_serve(dev, mesh, dataclasses.replace(
        lm_configs.get_config("jamba-v0.1-52b"),
        num_layers=LM_PART_JAMBA_LAYERS))
    whisper = _lm_partition_serve(dev, mesh,
                                  lm_configs.get_config("whisper-small"))
    llava = _lm_partition_adafactor(dev, mesh)
    return {"card": smi, "arch": cfg.name, "mesh": [1, 1],
            "backend": "nccl", "requests": LM_REQUESTS,
            "prompt": LM_PROMPT, "gen": LM_GEN,
            "decode_ms_per_step": step_ms,
            "decode_step_ms": steps_ms,
            "unplaced_decode_ms_per_step": plain_ms,
            "decode_logits_rel_max": err, "serve_peak_gb": serve_peak,
            "serve_c10d_calls": serve_calls, **train,
            "jamba_decode_ms": jamba["decode_ms_per_step"],
            "whisper_decode_ms": whisper["decode_ms_per_step"],
            "llava_adafactor_step_ms": llava["step_ms"],
            "families_peak_gb": {"jamba": jamba["peak_gb"],
                                 "whisper": whisper["peak_gb"],
                                 "llava": llava["peak_gb"]},
            "families_c10d_calls": {"jamba": jamba["c10d_calls"],
                                    "whisper": whisper["c10d_calls"],
                                    "llava": llava["c10d_calls"]},
            "jamba": jamba, "whisper": whisper, "llava": llava}


def _lm_partition_serve(dev, mesh, cfg) -> dict:
    """``generate`` and the decode loop of ``cfg`` (``LM_REQUESTS``
    prompts of ``LM_PROMPT`` tokens, ``LM_GEN`` generated; whisper's 1,500
    frames from the seeded stand-in for its audio front end), unplaced,
    then with the same model placed on ``mesh``.  Raises unless the
    tokens are equal, the logits within ``LM_PART_REL_MAX`` and the
    placed ``generate``'s peak under ``LM_PART_PEAK_GB``."""
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = models.lm_init(cfg, generator=gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (LM_REQUESTS, LM_PROMPT), generator=gen,
                                     device=dev, dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = (0.5 * torch.randn(
            (LM_REQUESTS, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev)).to(torch.bfloat16)
    kw = dict(steps=LM_GEN, max_len=LM_MAX_LEN)
    toks, _ = generate(model, batch, cfg, **kw)
    plain = _lm_loop(model, cfg, batch, None)
    plain_logits = [lg.float() for lg in plain["logits"]]
    plain_toks = torch.stack([st.last_token for st in plain["states"][1:]],
                             1)
    del plain
    plain_ms = _lm_loop(model, cfg, batch, None, keep=False)["step_ms"]
    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        model = place(model, to_shardings(mesh, rules, param_specs(
            cfg, model), model), mesh)
        batch = place(batch, to_shardings(mesh, rules, batch_specs(batch),
                                          batch), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p_toks, _ = generate(model, batch, cfg, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        run = _lm_loop(model, cfg, batch, None)
        ms = _lm_loop(model, cfg, batch, None, keep=False)["step_ms"]
        _, calls = _c10d_calls(lambda: generate(model, batch, cfg, **kw))
    run_toks = torch.stack([st.last_token.full_tensor()
                            for st in run["states"][1:]], 1)
    logits = [lg.full_tensor().float() for lg in run["logits"]]
    err = max(_rel_max(lg, want) for lg, want in zip(logits, plain_logits))
    same = torch.equal(p_toks, toks) and torch.equal(run_toks, plain_toks)
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    log(f"[lm-partition] {cfg.name} ({cfg.num_layers} layers at full "
        f"width) placed on a 1x1 mesh ({LM_REQUESTS} requests x prompt "
        f"{LM_PROMPT}, {LM_GEN} generated): tokens "
        f"{'equal' if same else 'DIFFER'} to the unplaced run; decode "
        f"logits rel max |Δ| {err:.3e} (bound {LM_PART_REL_MAX}); decode "
        f"{np.mean(ms):.3f} ms a step placed, {np.mean(plain_ms):.3f} "
        f"unplaced (CUDA events, mean of {LM_GEN}); peak {peak:.2f} GB "
        f"(bound {LM_PART_PEAK_GB}); collectives of one generate {calls}")
    del model, batch, run, logits, plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    if not same or err > LM_PART_REL_MAX or not finite or \
            peak > LM_PART_PEAK_GB:
        raise AssertionError(f"{cfg.name} placed generate: same={same}, "
                             f"err={err}, finite={finite}, peak={peak}")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "decode_ms_per_step": float(np.mean(ms)), "decode_step_ms": ms,
            "unplaced_decode_ms_per_step": float(np.mean(plain_ms)),
            "decode_logits_rel_max": err, "peak_gb": peak,
            "c10d_calls": calls}


def _lm_partition_adafactor(dev, mesh) -> dict:
    """One Adafactor train step of llava-next-34b at full width and
    ``LM_PART_LLAVA_LAYERS`` layers (``LM_PART_LLAVA_BATCH`` sequences of
    2,880 patch embeddings and ``LM_PART_LLAVA_TEXT`` tokens, two
    microbatches, no warmup: the checked step runs at the full learning
    rate), unplaced, then placed on ``mesh`` from the same seed; the two
    runs in turn, their parameters compared on the host.  Raises unless
    the loss agrees within ``LM_TRAIN_REL_MAX`` and every parameter's
    placed-minus-unplaced difference is within ``LM_TRAIN_REL_MAX`` of
    that step's own update ``|p_after - p_before|``."""
    cfg = dataclasses.replace(lm_configs.get_config("llava-next-34b"),
                              num_layers=LM_PART_LLAVA_LAYERS)
    s = lmtrain.TrainSettings(learning_rate=LM_TRAIN_LR, warmup_steps=0,
                              total_steps=LM_TRAIN_STEPS, num_microbatches=2)
    rng = np.random.default_rng(SEED)
    b, p, t = LM_PART_LLAVA_BATCH, cfg.num_patches, LM_PART_LLAVA_TEXT
    toks = rng.integers(0, cfg.vocab_size, (b, p + t + 1)).astype(np.int32)
    nb = {"tokens": toks[:, p:p + t], "labels": toks[:, 1:],
          "patches": rng.normal(0, 0.5, (b, p, cfg.d_model)).astype(
              np.float32)}
    step = lmtrain.make_train_step(cfg, s)

    def state():
        return lmtrain.init_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, s,
            device=dev)

    def host(m) -> dict:
        return {n: x.full_tensor() if hasattr(x, "full_tensor") else x
                for n, x in m.named_parameters()}

    def timed(st):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        st, m = step(st, nb)
        ev[1].record()
        torch.cuda.synchronize()
        return st, m, ev[0].elapsed_time(ev[1])

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = state()
    before = {n: x.detach().to("cpu", copy=True)
              for n, x in host(ref.params).items()}
    ref, rm, _ = timed(ref)
    want = {n: x.detach().to("cpu", copy=True)
            for n, x in host(ref.params).items()}
    ref, _, plain_ms = timed(ref)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    rules = make_rules(mesh, fsdp=True)
    with use_rules(rules):
        st = state()
        st = place(st, to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, st), st), mesh)
        st, pm, _ = timed(st)
        err, worst, moved = 0.0, None, 0.0
        for n, x in host(st.params).items():
            upd = float((want[n] - before[n]).abs().max())
            diff = float((x.detach().cpu() - want[n]).abs().max())
            off = diff / upd if upd > 0 else (0.0 if diff == 0 else np.inf)
            moved = max(moved, upd)
            if off > err:
                err, worst = off, n
        del want, before
        loss_err = abs(float(pm["loss"]) / float(rm["loss"]) - 1)
        st, _, ms = timed(st)
        box = [st]

        def one():
            box[0], mm = step(box[0], nb)
            return float(mm["loss"])

        _, calls = _c10d_calls(one)
        peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm-partition] {cfg.name} Adafactor train step at full width, "
        f"{cfg.num_layers} layers, {b} x ({p} patches + {t} tokens) in 2 "
        f"microbatches at lr {LM_TRAIN_LR:g}, placed against unplaced: "
        f"loss rel |Δ| {loss_err:.3e}; parameters' difference over their "
        f"own update, max {err:.3e} (worst {worst}; bound "
        f"{LM_TRAIN_REL_MAX}; largest update {moved:.3e}); step {ms:.3f} ms "
        f"placed, {plain_ms:.3f} unplaced (CUDA events); peak {peak:.2f} "
        f"GB (bound {LM_PART_PEAK_GB}); collectives of one step {calls}")
    del st, box
    gc.collect()
    torch.cuda.empty_cache()
    if loss_err > LM_TRAIN_REL_MAX or err > LM_TRAIN_REL_MAX or \
            not moved > 0 or peak > LM_PART_PEAK_GB:
        raise AssertionError(f"llava placed Adafactor step: loss {loss_err}"
                             f", params {err} ({worst}), moved {moved}, "
                             f"peak {peak}")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "loss_rel": loss_err, "params_over_update": err,
            "max_update": moved, "step_ms": ms, "unplaced_step_ms": plain_ms,
            "peak_gb": peak, "c10d_calls": calls}


def _adamw_first_move(s, mu, nu, p) -> torch.Tensor:
    """The move AdamW's first step (``optim.optimizer.adamw`` at its
    defaults, ``s``'s weight decay and step-0 learning rate) makes on
    ``p``, given the moments it left: ``mu / (1 - b1)`` is the clipped
    gradient and ``nu / (1 - b2)`` its square."""
    d = inspect.signature(lm_optim.adamw).parameters
    b1, b2, eps = (d[k].default for k in ("b1", "b2", "eps"))
    lr = lm_optim.linear_warmup_cosine(s.learning_rate, s.warmup_steps,
                                       s.total_steps)(0)
    return -lr * ((mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + eps)
                  + s.weight_decay * p)


def _lm_partition_train(dev, mesh) -> dict:
    cfg = dataclasses.replace(lm_configs.get_config(LM_ARCH),
                              num_layers=LM_PART_LAYERS)
    micro = launch_specs.num_microbatches(cfg, LM_TRAIN_SHAPE, 1)
    # no warmup: the checked first step runs at the full learning rate
    s = dataclasses.replace(_lm_train_settings(micro), warmup_steps=0)
    nb = _lm_train_inputs(cfg, np.random.default_rng(SEED), LM_TRAIN_BATCH,
                          LM_TRAIN_SEQ)
    step = lmtrain.make_train_step(cfg, s)

    def state():
        return lmtrain.init_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, s,
            device=dev)

    def timed(st):
        """LM_PART_TRAIN_STEPS more steps: the state and their ms."""
        more = lm_launch.make_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                      seed=SEED + 1)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(LM_PART_TRAIN_STEPS + 1)]
        ev[0].record()
        for k in range(LM_PART_TRAIN_STEPS):
            st, m = step(st, next(more))
            ev[k + 1].record()
        torch.cuda.synchronize()
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"train loss {float(m['loss'])}")
        return st, [ev[k].elapsed_time(ev[k + 1])
                    for k in range(LM_PART_TRAIN_STEPS)]

    def host(tree: dict) -> dict:
        return {n: t.detach().to("cpu", torch.float32, copy=True)
                for n, t in tree.items()}

    ref = state()
    before = host(dict(ref.params.named_parameters()))
    ref, rm = step(ref, nb)
    want = host(dict(ref.params.named_parameters()))
    want_mu, want_nu = host(ref.opt_state.mu), host(ref.opt_state.nu)
    rm = {k: float(rm[k]) for k in ("loss", "grad_norm")}
    ref, plain_ms = timed(ref)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rules = make_rules(mesh, fsdp=True)
    with use_rules(rules):
        st = state()
        st = place(st, to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, st), st), mesh)
        st, pm = step(st, nb)
        err = {"loss": abs(float(pm["loss"]) / rm["loss"] - 1),
               "grad_norm": abs(float(pm["grad_norm"]) / rm["grad_norm"]
                                - 1), "moments": 0.0, "update": 0.0}
        moved, off, worst = 0.0, 0.0, {}
        for n, p in st.params.named_parameters():
            p0 = before.pop(n).to(dev)
            mu = st.opt_state.mu[n].full_tensor().float()
            nu = st.opt_state.nu[n].full_tensor().float()
            # the gradient leaf by leaf: both moments against the
            # unplaced step's (√ν, on the gradient's scale)
            e = max(_rel_max(mu, want_mu.pop(n).to(dev)),
                    _rel_max(nu.sqrt(), want_nu.pop(n).to(dev).sqrt()))
            if e > err["moments"]:
                err["moments"], worst["moments"] = e, n
            # the update on local shards: the move each parameter made
            # against AdamW's first step from the placed moments
            move = p.full_tensor().detach().float() - p0
            e = _rel_max(move, _adamw_first_move(s, mu, nu, p0))
            if e > err["update"]:
                err["update"], worst["update"] = e, n
            moved = max(moved, float(move.abs().max()))
            off = max(off, float((p.full_tensor().detach().float()
                                  - want.pop(n).to(dev)).abs().max()))
            del p0, mu, nu, move
        del want, want_mu, want_nu, before
        lr = lm_optim.linear_warmup_cosine(s.learning_rate, s.warmup_steps,
                                           s.total_steps)(0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, ms = timed(st)
        peak = torch.cuda.max_memory_allocated() / 1e9
        box = [st]
        more = lm_launch.make_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                      seed=SEED + 2)

        def one():
            box[0], mm = step(box[0], next(more))
            return float(mm["loss"])

        _, calls = _c10d_calls(one)
    log(f"[lm-partition] train step at full width, {cfg.num_layers} "
        f"layers, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in {micro} "
        f"microbatches at lr {lr:g}: placed against unplaced rel |Δ| loss "
        f"{err['loss']:.3e}, grad norm {err['grad_norm']:.3e}, AdamW "
        f"moments {err['moments']:.3e} (worst {worst.get('moments')}); "
        f"each parameter's move (max {moved:.3e}) against AdamW's first "
        f"step from its moments {err['update']:.3e} (worst "
        f"{worst.get('update')}; bound {LM_TRAIN_REL_MAX}); parameters "
        f"against unplaced max {off / lr:.3f} lr, not gated (AdamW's "
        f"first step moves by lr·g/(|g|+eps): gradient noise that flips a "
        f"sign moves up to 2 lr apart); "
        f"{LM_PART_TRAIN_STEPS} steps each: placed {np.median(ms):.3f} ms "
        f"median ({min(ms):.3f}-{max(ms):.3f}), unplaced "
        f"{np.median(plain_ms):.3f} ({min(plain_ms):.3f}-"
        f"{max(plain_ms):.3f}) (CUDA events, the same call); placed peak "
        f"{peak:.2f} GB; collectives of one step {calls}")
    if max(err.values()) > LM_TRAIN_REL_MAX or not moved > 0:
        raise AssertionError(f"placed train step: {err}, moved {moved}")
    del st, box
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_layers": cfg.num_layers, "train_microbatches": micro,
            "train_vs_unplaced": err, "train_max_move": moved,
            "train_params_vs_unplaced_in_lr": off / lr,
            "train_ms_per_step": float(
                np.median(ms)), "train_step_ms": ms,
            "unplaced_train_ms_per_step": float(np.median(plain_ms)),
            "train_peak_gb": peak, "train_c10d_calls": calls}


# ---------------------------------------------------------------------------
# 4e. the dry-run tooling against the card
# ---------------------------------------------------------------------------

# The dry-run's peak against the card's max_memory_allocated: the meta run
# counts every live storage exactly, but not the caching allocator's
# rounding to 512-byte blocks, the temporaries a CUDA kernel allocates
# inside one op, or the bytes already allocated before the measured run
DRYRUN_PEAK_REL = 5e-2
# Its flops against the step's products reckoned from the model's shapes
DRYRUN_FLOPS_REL = 2e-2


def _dry(what, fn, *args):
    """``fn(*args)``, a dry-run on ``meta`` tensors, and its host seconds;
    raises unless the card's allocated bytes are the same after it as
    before."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args)
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"the {what} dry-run allocated "
                             f"{after - before} bytes on the card")
    return out, sec


def _ratio(what, got, want, rel, against="measured") -> dict:
    r = got / want
    log(f"[dryrun] {what}: predicted {got:,.0f}, {against} {want:,.0f}, "
        f"ratio {r:.4f} (bound |1 - ratio| <= {rel})")
    if abs(r - 1) > rel:
        raise AssertionError(f"{what}: dry-run {got} against {want}")
    return {"predicted": got, against: want, "ratio": r}


def phase_dryrun(smi, lm, lm_train) -> dict:
    """The dry-run tooling (``launch.specs``, ``launch.op_cost``,
    ``launch.dryrun``) held against what phase_lm and phase_lm_train
    measured: the training step they ran (qwen3-4b, 36 x 2560, AdamW, 8 x
    1,024 tokens in launch.specs' microbatches, the launcher's settings)
    on ``meta`` tensors placed on a 1×1 mesh under a one-rank ``fake``
    group (rank 0 of the placed program), its peak within DRYRUN_PEAK_REL
    of the measured
    max_memory_allocated and its flops within DRYRUN_FLOPS_REL of the
    step's products reckoned in ``_lm_train_bound``; phase_lm's decode
    step (float32 weights, 8 lanes, a max_len cache), placed likewise, its
    peak within DRYRUN_PEAK_REL of that phase's peak; and one production
    cell through ``launch.dryrun.run_cell``.  No dry-run allocates on the card.
    Launches none of K1-K6."""
    reset_counts()
    cfg = lm_configs.get_config(LM_ARCH)
    micro = launch_specs.num_microbatches(cfg, LM_TRAIN_SHAPE, 1)
    if micro != lm_train["microbatches"]:
        raise AssertionError(f"{micro} microbatches, trained with "
                             f"{lm_train['microbatches']}")
    settings = _lm_train_settings(micro)

    def placed_cost(fn, fsdp, tree, specs_of):
        """``op_cost`` of ``fn`` on ``tree`` placed on a 1×1 mesh under a
        one-rank ``fake`` group: rank 0 of the placed program, as the
        production cells count it."""
        with lm_dryrun.fake_group(1):
            mesh = make_device_mesh((1, 1), ("data", "model"),
                                    devices=["meta"])
            rules = make_rules(mesh, fsdp=fsdp)
            with use_rules(rules):
                placed = [place(t, to_shardings(mesh, rules, sp(t), t), mesh)
                          for t, sp in zip(tree, specs_of)]
                return op_cost(fn, *placed)

    def train_step():
        state = lmtrain.init_state(
            None, cfg, settings,
            lambda g: launch_specs.abstract_params(cfg), device="meta")
        return placed_cost(
            lmtrain.make_train_step(cfg, settings), True,
            (state, launch_specs.train_inputs(cfg, LM_TRAIN_SHAPE)),
            (lambda t: train_state_specs(cfg, cfg.optimizer, t),
             batch_specs))

    (train, _), train_s = _dry("train", train_step)
    bound = lm_train["bound"]
    out = {"card": smi, "arch": cfg.name, "train_s": train_s,
           "train_peak": _ratio(
               "train step peak bytes", train.peak_bytes,
               lm_train["peak_memory_gb"] * 1e9, DRYRUN_PEAK_REL),
           "train_flops": _ratio(
               "train step flops", train.flops, bound["step_flops"],
               DRYRUN_FLOPS_REL, against="reckoned"),
           "train_flops_over_bound_flops": train.flops / bound["flops"],
           "train_bytes": train.bytes}
    log(f"[dryrun] train step: {train.flops / 1e12:.3f} TFLOP, "
        f"{train.flops / bound['flops']:.4f} of the bound's "
        f"{bound['flops'] / 1e12:.3f} (8·N·T + causal attention) by its "
        f"named terms (TFLOP): " + ", ".join(
            f"{k} {v / 1e12:+.3f}" for k, v in
            bound["step_flops_terms"].items())
        + f"; {train.bytes / 1e12:.3f} TB of eager op traffic; "
        f"{train_s:.2f} s on the host; {smi}")

    dec_shape = lm_configs.ShapeConfig("lm_decode", LM_MAX_LEN, LM_REQUESTS,
                                       "decode")
    vec = ("batch",)
    (dec, _), dec_s = _dry(
        "decode", placed_cost, make_decode_step(cfg), False,
        (launch_specs.abstract_params(cfg),
         launch_specs.decode_state_spec(cfg, dec_shape)),
        (lambda t: param_specs(cfg, t), lambda t: t._replace(
            cache=cache_specs(cfg, t.cache, decode=True), cur_len=vec,
            last_token=vec, done=vec)))
    out["decode_s"] = dec_s
    out["decode_peak"] = _ratio("decode step peak bytes", dec.peak_bytes,
                                lm["peak_memory_gb"] * 1e9, DRYRUN_PEAK_REL)
    out["decode_flops"] = dec.flops

    rec, cell_s = _dry("cell", lm_dryrun.run_cell, LM_ARCH, "decode_32k",
                       False)
    out["cell"] = {"tag": f"{LM_ARCH}.decode_32k.single", "s": cell_s,
                   "memory": rec["memory"],
                   "flops_per_device": rec["cost"]["flops_per_device"]}
    log(f"[dryrun] decode step {dec.flops / 1e9:.3f} GFLOP, {dec_s:.2f} s; "
        f"launch.dryrun cell {LM_ARCH} x decode_32k on the single-pod "
        f"(16, 16) mesh: peak {rec['memory']['peak_bytes'] / 2**30:.2f} "
        f"GiB a device, {rec['cost']['flops_per_device']:.4g} flops a "
        f"device, {cell_s:.2f} s; the card's allocated bytes unchanged "
        f"by every dry-run")
    launched = counts()
    if any(launched.values()):
        raise AssertionError(f"the dry-run launched {launched}")
    print(json.dumps({"dryrun": out}), flush=True)
    return out


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
    # K4 at (T, 1024, 784) as the staged op hands it, with its tallies;
    # beside it the train-only launch of poisson_encode_op (896 pixels)
    B, T = SERVE_BATCH, T_STAGED
    pxp, stp, spikes = _encoded(imgs, dev)
    px, st = pxp[:, :784].contiguous(), stp[:, :784].contiguous()
    tal = ops.staged_tallies(T, 3, B, dev)
    got = poisson_encode.poisson_encode(px, st, T, tal)
    torch.cuda.synchronize()
    err = _max_abs_err((*got, tal.n_spk[:, 0], tal.live_k[:, 0]),
                       _k4_plain(px, st, T))
    if err:
        raise AssertionError(f"K4 with tallies != plain (max |err| {err})")
    ms = _device_ms(lambda: poisson_encode.poisson_encode(px, st, T, tal),
                    200)
    plain = _plain_ms(lambda: _k4_plain(px, st, T), 10)
    times["K4"] = _bound("K4", B * 784 * (1 + 4 + 4) + T * B * 784
                         + T * B * 4 + T * (B // 8) * 4, 7 * T * B * 784, ms,
                         plain, f"T={T} B={B} N=784 with its tallies")
    times["K4"]["max_abs_err"] = err
    times["K4"]["train_only_ms"] = _device_ms(
        lambda: poisson_encode.poisson_encode(pxp, stp, T), 200)
    log(f"[times] K4 train-only launch at 896 pixels (tallies into a zeroed "
        f"scratch): {times['K4']['train_only_ms'] * 1e3:.2f} us")
    # K5 at (T, 1024, 2048 -> 2048), the second hidden layer of the wide
    # stack, and at the head of 784 -> 16384 -> 10
    times["K5"], x, w1 = _time_k5(spikes[:, :, :784], wide_params, dev)
    times["K6_path"] = phase_k6_path(x, w1)
    times["K3"] = _time_k3(dev)
    times["K6"] = _time_k6(dev)
    return times


def _k4_plain(px, st, T):
    """K4's function with its tallies in plain PyTorch: the train, the
    final state, each (step, lane)'s spikes and each (step, 8-lane
    block)'s 128-pixel tiles holding one."""
    spikes, state = poisson_encode.poisson_encode_plain(px, st, T)
    return (spikes, state, spikes.sum(-1, dtype=torch.int32),
            tile_any(spikes, 8).sum(-1, dtype=torch.int32))


def _k5_bound(x, n_out, ms, plain_ms, what, readout=None) -> dict:
    """K5's bound on the unpadded function: each input read once (spikes,
    codes), each output written once.  The trace launch (``readout``
    None) writes spikes, trace and final membrane; a readout launch
    (``"hidden"`` or ``"last"``) the spikes and peaks, the last layer's
    trace, final membrane, counts and first spikes, and its tallies: each
    (step, block)'s live output tiles and, for a hidden layer, the next
    layer's (step, lane) spike counts and live input tiles (no enables
    without pruning).  Operations: the executed adds of this data plus
    ~10 LIF operations per neuron and step at the INT32 rate, or the
    two-plane product on the int8 tensor cores, 2 * T * B * K * N * 2,
    whichever is shorter."""
    T, B, K = x.shape
    adds = int(x.sum(dtype=torch.int64)) * n_out  # no pruning: all enabled
    n_bytes = T * B * K + K * n_out * 2 + T * B * n_out
    if readout is None:
        n_bytes += T * B * n_out * 4 + B * n_out * 4
    else:
        n_bytes += B * n_out * 4 + T * (B // 8) * 4
        if readout == "last":
            n_bytes += T * B * n_out * 4 + 3 * B * n_out * 4
        else:
            n_bytes += T * B * 4 + T * (B // 8) * 4
    return _bound("K5" if readout else "K5 trace", n_bytes,
                  adds + 10 * T * B * n_out, ms, plain_ms, what,
                  tc_ops=2 * T * B * K * n_out * 2)


def _k5_readout(x, w, n_out, kw, n, m, what, last=False) -> dict:
    """K5's readout launch as the staged call hands it (with ``last``, the
    last layer's), held to its plain twin, then timed; its trace launch on
    the same operands beside it."""
    T, B, _ = x.shape
    layer = 1 if last else 0
    tal = ops.staged_tallies(T, 2, B, x.device)
    got = lif_step.lif_forward_readout(x, w, tal, layer=layer, b_valid=B,
                                       n_valid=n_out, **kw)
    torch.cuda.synchronize()
    want = lif_step.lif_forward_readout_plain(x, w, b_valid=B, n_valid=n_out,
                                              last=last, **kw)
    keys = ["spikes", "v_peak"] + (["v_trace", "v_final"] if last else [])
    g, wt = [got[k] for k in keys], [want[k] for k in keys]
    if last:
        g += [got["counts"][:, :n_out], got["first"][:, :n_out],
              tal.live_n[:, 1]]
        wt += [want["counts"][:, :n_out], want["first"][:, :n_out],
               want["live_n"]]
    else:
        g += [tal.n_spk[:, 1], tal.live_k[:, 1], tal.live_n[:, 0]]
        wt += [want["n_spk"], want["live_k"], want["live_n"]]
    err = _max_abs_err(g, wt)
    if err:
        raise AssertionError(f"K5's readout launch != its twin ({what}): "
                             f"{err}")
    ms = _device_ms(lambda: lif_step.lif_forward_readout(
        x, w, tal, layer=layer, b_valid=B, n_valid=n_out, **kw), n)
    plain = _plain_ms(lambda: lif_step.lif_forward_readout_plain(
        x, w, b_valid=B, n_valid=n_out, last=last, **kw), m)
    out = _k5_bound(x, n_out, ms, plain, what,
                    readout="last" if last else "hidden")
    ms = _device_ms(lambda: lif_step.lif_forward(x, w, **kw), n)
    plain = _plain_ms(lambda: lif_step.lif_forward_plain(x, w, **kw), m)
    out["trace"] = _k5_bound(x, n_out, ms, plain, what)
    out["max_abs_err"] = err
    return out


def _time_k5(spikes, wide_params, dev) -> tuple[dict, torch.Tensor,
                                                torch.Tensor]:
    """K5's readout launch (the row) and its trace launch (``trace``) at
    (T, 1,024, 2048 -> 2048), fed the wide stack's first hidden layer's
    spike train, and at the head of 784 -> 16384 -> 10 (K = 16,384 over
    one padded 128-column tile, fed a 16,384-wide hidden layer's train),
    both trains made by the plain version from ``spikes``, the encoder's
    (T, 1,024, 784) train.  Returns the times, the 2048-wide train and
    the second layer's codes."""
    T, B = spikes.shape[:2]
    lif = cfgs.SNN_CONFIG_WIDE.lif
    kw = dict(decay_shift=lif.decay_shift, v_threshold=lif.v_threshold,
              v_rest=lif.v_rest, v_min=lif.v_min, v_max=lif.v_max)
    w0, w1 = (torch.from_numpy(l["w_q"]).to(dev)
              for l in wide_params["layers"][:2])
    x = lif_step.lif_forward_plain(spikes, w0, **kw)[0]
    K, N = w1.shape
    out = _k5_readout(x, w1, N, kw, 20, 3,
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
    # 128 columns, as the ops pad it)
    rng = np.random.default_rng(SEED + 29)
    wa, wb = _fan_in_weights(rng, (784, HEAD_WIDTH, 10), dev)
    h = lif_step.lif_forward_plain(spikes, wa, **kw)[0]
    wbp = ops._pad_to(wb, 1, lif_step.BLOCK[1])
    out["head"] = _k5_readout(h, wbp, 10, kw, 5, 2,
                              f"head T={T} B={B} {HEAD_WIDTH}->10 (padded to "
                              f"128; input density "
                              f"{float(h.float().mean()):.4f})", last=True)
    out["max_abs_err"] = max(out["max_abs_err"],
                             out["head"].pop("max_abs_err"))
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
    _lap("device and build")
    checks = {"K1": phase_kernel_vs_plain(dev),
              "K2": phase_streamed_vs_plain(dev),
              "K3": phase_k3_vs_plain(dev),
              "K6": phase_k6_vs_plain(dev)}
    _lap("kernels vs plain")
    rng = np.random.default_rng(SEED + 1)
    params = _serve_params(rng)
    imgs = _images(rng, SERVE_REQUESTS)
    wide_params = _wide_params(rng)
    staged = phase_staged(dev, _on(wide_params, dev))
    _lap("staged")
    serve = {"K1": phase_serve(imgs, params, cfgs.SNN_CONFIG, "K1", "fused"),
             "K2": phase_serve(imgs, wide_params, cfgs.SNN_CONFIG_WIDE, "K2",
                               "fused_streamed")}
    _lap("serve")
    wide_want = serve["K2"].pop("results")
    k1_want = serve["K1"]["results"]
    serve["K3"] = phase_mesh_serve(imgs, wide_params, cfgs.SNN_CONFIG_WIDE,
                                   MESH_WIDE, SERVE_BATCH, wide_want, dev,
                                   profile=True)
    phase_mesh_serve(imgs[:SERVE_BATCH], wide_params, cfgs.SNN_CONFIG_WIDE,
                     (2, 2), SERVE_BATCH // 2, wide_want, dev)
    phase_mesh_serve(imgs, params, cfgs.SNN_CONFIG, (1, 2), SERVE_BATCH,
                     serve["K1"].pop("results"), dev)
    _lap("mesh serves")
    ranks = phase_snn_ranks(wide_want, serve["K3"])
    _lap("ranks")
    tier = {"tier": phase_tier(imgs, params, k1_want,
                               serve["K1"]["requests_per_s"]),
            "sharded": phase_sharded_tier(imgs[:SERVE_BATCH], params,
                                          k1_want, dev),
            "model_axis": phase_model_axis_ladder(
                imgs[:SERVE_BATCH], wide_params, wide_want, dev)}
    _lap("tier")
    cluster = phase_cluster(imgs, params, k1_want)
    _lap("cluster")
    tune = phase_tune(imgs, params, k1_want, dev)
    _lap("tune")
    train = phase_train(dev, smi)
    _lap("train")
    lm = phase_lm(dev, smi)
    _lap("lm")
    lm_train = phase_lm_train(dev, smi)
    _lap("lm_train")
    phase_lm_partition(dev, smi)
    _lap("lm_partition")
    phase_dryrun(smi, lm, lm_train)
    _lap("dryrun")
    times = phase_times(imgs, params, wide_params, dev)
    _lap("times")
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
            extra.update({f"cluster_{k}": v for k, v in cluster.items()})
            extra.update({f"tune_{k}": v for k, v in tune.items()})
            extra["train_launches"] = {
                "scoring": train["scoring_K1_launches"],
                "pruned": train["pruned"]["K1_launches"],
                "serve": train["serve"]["K1_launches"]}
        if tag == "K2":
            extra["serve_device_ms"] = serve["K2"]["serve_device_ms"]
            extra["grids"] = serve["K2"]["grids"]
            extra["tier_launches"] = tier["tier"]["K2"]
        if tag == "K3":
            extra["device_busy_ms"] = serve["K3"]["device_busy_ms"]
            extra["profiled_wall_ms"] = serve["K3"]["profiled_wall_ms"]
            extra["overlap_runs"] = serve["K3"]["overlap"]
            extra["shapes"] = k3_shapes
            extra["rank_serves"] = ranks
            extra["ladder_launches"] = tier["model_axis"]["K3"]
            extra["ladder_chunks_by_rung"] = \
                tier["model_axis"]["chunks_by_rung"]
        if tag == "K6":
            extra["cases"], extra["max_abs_err"] = checks["K6"][0], max(
                checks["K6"][1], extra["max_abs_err"])
            extra["dot"] = k6_modes["dot"]
        t = dict(times[tag])
        if "max_abs_err" in t:  # K4, K5: the timed launch against its twin
            err = t.pop("max_abs_err")
            if tag == "K5":     # the phase checked the trace launch too
                extra["trace_max_abs_err"] = extra["max_abs_err"]
                extra["max_abs_err"] = err
            else:
                extra["max_abs_err"] = max(extra["max_abs_err"], err)
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
    if sys.argv[1:2] == ["--snn-rank"]:
        sys.exit(_snn_rank_main(sys.argv[2:]))
    sys.exit(main())
