#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. device — a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build — compiles every kernel source under
   ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a and prints the
   build time and ptxas' register / shared-memory / spill report.
3. kernel vs plain — the encode→LIF stack kernel against its plain PyTorch
   version on the same operands on the card, integer-equal on every output
   (counts, trace, first-spike latch, adds, PRNG state, per-layer v / en /
   v_peak, steps, gate and the three telemetry leaves): the paper config,
   the pruned first-spike config, the deep stack and a membrane-readout
   variant; gated and ungated; one 20-step launch and 5 chunks of 4;
   sparse_skip on and off.
4. serve — ``SNNStreamEngine`` on the paper's 784→10 classifier
   (batch 1024, chunk 4, patience 2) serves 4,096 seeded images with
   seeded random weight codes; every launch of the main path is counted,
   and the results must equal the reference backend's on the card, id for
   id.
5. times — the kernel and its plain version at the serving shape, with the
   bound: the larger of the bytes the function must move (unpadded shapes,
   each input read once, each output written once) at 3.35 TB/s and its
   integer operations at the card's INT32 rate.

The second-to-last lines are the ``{"kernels": [...]}`` record and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.core.prng import seed_state  # noqa: E402
from repro_torch.kernels import _build, fused_snn, ops  # noqa: E402
from repro_torch.serve import SNNStreamEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM INT32 rate: the data sheet's 67 TFLOP/s float32 counts an FMA as
# two operations on 128 FP32 lanes per SM; an SM has 64 INT32 lanes and an
# add is one operation, so a quarter of it.
INT32_OPS_PER_S = 67e12 / 4
SEED = 0
SERVE_BATCH, SERVE_CHUNK, SERVE_PATIENCE, SERVE_REQUESTS = 1024, 4, 2, 4096
CHECK_BATCH = 1021            # pads to 1024: exercises the batch padding
SOURCE = "src/repro_torch/kernels/csrc/fused_snn_stack.cu"
REPLACES = "src/repro/kernels/fused_snn.py:554"


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
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in infos.items():
        how = "cached build" if info.cached else f"nvcc {info.seconds:.2f} s"
        log(f"[build] {name}: {how} -> {info.path.relative_to(ROOT)}")
        for line in info.log.splitlines():
            if re.search(r"registers|spill|smem|stack frame|Compiling", line):
                log(f"[build]   {line.strip()}")
    _build.load_library()


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


def _run_window(cfg, px, st, ws, kw, gate, chunk, compare):
    """Run the whole window in ``chunk``-step launches of the kernel,
    holding each launch against the plain version when ``compare``.
    Returns (op-level results per launch, max abs error)."""
    init, results, err = None, [], 0
    for _ in range(cfg.num_steps // chunk):
        args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                        v_rest=cfg.lif.v_rest, init=init,
                                        gate=gate)
        got = fused_snn.fused_snn_stack(*args, chunk_steps=chunk,
                                        block_b=meta["block_b"], **kw)
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


def phase_kernel_vs_plain(dev) -> tuple[int, int]:
    rng = np.random.default_rng(SEED)
    cases = [("SNN_CONFIG", "count"), ("SNN_CONFIG_PRUNED", "first_spike"),
             ("SNN_CONFIG_DEEP", "count"), ("SNN_CONFIG", "membrane")]
    n_cases, err = 0, 0
    t0 = time.perf_counter()
    for name, readout in cases:
        cfg = dataclasses.replace(getattr(cfgs, name), readout=readout)
        ws = _weights(rng, cfg.layer_sizes, dev)
        px = torch.from_numpy(_images(rng, CHECK_BATCH)).to(dev)
        st = seed_state(SEED + n_cases, (CHECK_BATCH, cfg.n_in), device=dev)
        for gated in (False, True):
            for sparse_skip in (True, False):
                gate = None
                if gated:
                    act = torch.ones(CHECK_BATCH, dtype=torch.bool,
                                     device=dev)
                    act[::13] = False             # lanes frozen from t=0
                    gate = {"active": act,
                            "prev": torch.full((CHECK_BATCH,), -1,
                                               dtype=torch.int32, device=dev),
                            "streak": torch.zeros(CHECK_BATCH,
                                                  dtype=torch.int32,
                                                  device=dev)}
                kw = _lif_kw(cfg, readout, sparse_skip)
                one, e1 = _run_window(cfg, px, st, ws, kw, gate,
                                      cfg.num_steps, compare=True)
                chunks, e2 = _run_window(cfg, px, st, ws, kw, gate, 4,
                                         compare=True)
                _same_window(one, chunks)
                spikes = int(one[0]["spike_counts"].sum())
                if spikes == 0:
                    raise AssertionError(f"{name}: no output spikes")
                err = max(err, e1, e2)
                n_cases += 1
                log(f"[kernel-vs-plain] {name:18s} readout={readout:11s} "
                    f"gated={gated!s:5s} sparse_skip={sparse_skip!s:5s} "
                    f"B={CHECK_BATCH} T=20 one-shot + 5x4: equal "
                    f"(output spikes {spikes})")
    log(f"[kernel-vs-plain] {n_cases} cases, every output integer-equal, "
        f"{time.perf_counter() - t0:.2f} s")
    return n_cases, err


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def _serve_params(rng):
    w = np.clip(np.round(rng.normal(0.0, 24.0, (784, 10))), -256, 255)
    return {"layers": [{"w_q": w.astype(np.int16), "scale": 1.0 / 128}]}


def _engine(params, backend):
    return SNNStreamEngine(params, cfgs.SNN_CONFIG, batch_size=SERVE_BATCH,
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


def phase_serve(imgs, params) -> dict:
    eng = _engine(params, None)
    if eng.backend != "fused":
        raise AssertionError(f"auto backend resolved to {eng.backend!r}")
    for im in imgs:
        eng.submit(im)
    spent = _time_methods(eng, _TIMED)
    torch.cuda.synchronize()
    fused_snn.fused_snn_stack.launches = 0          # the main path starts
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_snn.fused_snn_stack.launches   # the main path ended
    if sorted(results) != list(range(len(imgs))):
        raise AssertionError(f"{len(results)} results for {len(imgs)} "
                             f"requests")
    if not (launches > 0 and launches == eng.dispatches):
        raise AssertionError(f"{launches} kernel launches for "
                             f"{eng.dispatches} chunk dispatches")
    ref = _engine(params, "reference")
    for im in imgs:
        ref.submit(im)
    t1 = time.perf_counter()
    want = ref.run()
    ref_wall = time.perf_counter() - t1
    if fused_snn.fused_snn_stack.launches != launches:
        raise AssertionError("the reference backend launched the kernel")
    for rid, w in want.items():
        g = results[rid]
        if (g.pred, g.steps, g.adds, g.early_exit, g.weight_version) != \
                (w.pred, w.steps, w.adds, w.early_exit, w.weight_version) \
                or not np.array_equal(g.spike_counts, w.spike_counts):
            raise AssertionError(f"request {rid}: fused {g} != reference {w}")
    steps = np.array([r.steps for r in results.values()])
    preds = np.bincount([r.pred for r in results.values()], minlength=10)
    log(f"[serve] SNN_CONFIG 784->10 T=20 batch={SERVE_BATCH} "
        f"chunk={SERVE_CHUNK} patience={SERVE_PATIENCE}: "
        f"{len(results)} requests in {wall:.3f} s = "
        f"{len(results) / wall:.1f} requests/s, {eng.dispatches} chunks, "
        f"{launches} kernel launches")
    log("[serve] host time by engine method (ms, calls): " + ", ".join(
        f"{n} {sec * 1e3:.2f} ({calls})" for n, (sec, calls) in spent.items()))
    log(f"[serve] early exits {int((steps < 20).sum())}, mean steps "
        f"{steps.mean():.2f}, predictions per class {preds.tolist()}")
    log(f"[serve] reference backend on the card: {ref_wall:.3f} s = "
        f"{len(want) / ref_wall:.1f} requests/s; results equal id for id")
    return {"launches": launches, "chunks": eng.dispatches,
            "requests_per_s": len(results) / wall}


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


def phase_times(imgs, params, dev) -> dict:
    cfg = cfgs.SNN_CONFIG
    px = torch.from_numpy(imgs[:SERVE_BATCH]).to(dev)
    st = seed_state(SEED, (SERVE_BATCH, cfg.n_in), device=dev)
    ws = tuple(torch.from_numpy(l["w_q"]).to(dev) for l in params["layers"])
    gate = {"active": torch.ones(SERVE_BATCH, dtype=torch.bool, device=dev),
            "prev": torch.full((SERVE_BATCH,), -1, dtype=torch.int32,
                               device=dev),
            "streak": torch.zeros(SERVE_BATCH, dtype=torch.int32, device=dev)}
    args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                    gate=gate)
    kw = dict(_lif_kw(cfg, cfg.readout, True), chunk_steps=SERVE_CHUNK,
              block_b=meta["block_b"])

    def kernel():
        return fused_snn.fused_snn_stack(*args, **kw)

    def plain():
        return fused_snn.fused_snn_stack_plain(*args, **kw)

    out = kernel()
    torch.cuda.synchronize()
    err = _max_abs_err(out, plain())
    if err:
        raise AssertionError(f"kernel != plain at the serving shape ({err})")
    for _ in range(20):
        kernel()
    torch.cuda.synchronize()
    # Device time per launch: the stream is held by a sleep kernel while
    # the host enqueues every launch, so the events bracket back-to-back
    # kernels and not the wrapper's host work.
    n = 200
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(n):
        kernel()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    # host-clock time of one wrapper call, launch included
    t0 = time.perf_counter()
    for _ in range(n):
        kernel()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / n
    for _ in range(2):
        plain()
    torch.cuda.synchronize()
    m = 10
    e0.record()
    for _ in range(m):
        plain()
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1) / m

    launch_bytes = _bytes_of(args) + _bytes_of(out)
    fn_bytes = _function_bytes(SERVE_BATCH, cfg.layer_sizes, SERVE_CHUNK,
                               gated=True)
    res = ops.stack_results(out, meta)
    adds = int(res["active_adds"].sum())
    n_in, n_neurons = cfg.layer_sizes[0], sum(cfg.layer_sizes[1:])
    # executed synaptic adds (this data) + xorshift (6) and compare (1) per
    # pixel per step + ~10 LIF ops per neuron per step, all int32
    n_ops = (adds + 7 * SERVE_BATCH * n_in * SERVE_CHUNK
             + 10 * SERVE_BATCH * n_neurons * SERVE_CHUNK)
    t_bytes = fn_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"[times] stack kernel B={SERVE_BATCH} chunk={SERVE_CHUNK} gated: "
        f"{ms * 1e3:.2f} us/launch on the device ({n} launches), "
        f"{call_ms * 1e3:.2f} us per wrapper call on the host clock; "
        f"plain version {plain_ms * 1e3:.1f} us")
    log(f"[times] bound: the function moves {fn_bytes} B "
        f"({fn_bytes / 1e6:.3f} MB, unpadded) at 3.35 TB/s -> "
        f"{t_bytes * 1e3:.3f} us; {n_ops} int32 ops at "
        f"{INT32_OPS_PER_S / 1e12:.2f} T/s -> {t_ops * 1e3:.3f} us; bound "
        f"{bound_ms * 1e3:.3f} us ({bound_ms / ms * 100:.2f}% of the "
        f"kernel's time); the launch's padded operands are {launch_bytes} B")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "call_ms": call_ms}


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    n_cases, err = phase_kernel_vs_plain(dev)
    rng = np.random.default_rng(SEED + 1)
    params = _serve_params(rng)
    imgs = _images(rng, SERVE_REQUESTS)
    serve = phase_serve(imgs, params)
    times = phase_times(imgs, params, dev)
    record = {"kernels": [{
        "name": "fused_snn_stack", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve["launches"],
        "max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None, "match": True, "cases": n_cases,
        "requests_per_s": serve["requests_per_s"],
        "chunks": serve["chunks"]}]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
