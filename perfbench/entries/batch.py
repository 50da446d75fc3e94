"""The whole-window batch entry: ``core.snn.snn_apply_int`` called back to
back on whole batches, as a bulk classifier calls it: no engine.

Call ``c`` (warm-up calls first) classifies requests ``c · batch`` to
``c · batch + batch - 1``, pool images ``(c · batch + j) mod pool``,
uploaded inside the window from pinned host memory.  Its xorshift lanes
are the lanes the previous call returned (``prng_state``): the program's
``prng.seed_state(seed, (batch, n_in))`` preloads them once in set-up,
as the encoder's LFSRs are preloaded once, and they run on from call to
call.  Each call's predictions are copied into pinned host memory behind
it; the host waits for the oldest call before it queues another beyond
``in_flight``.  The window queues calls until ``--seconds`` have passed
and ends when the last one's predictions are on the host; every image of
every call counts.

Traffic keys: ``batch`` (images a call), ``in_flight``, ``pool``,
``pool_seed``, ``warmup_calls`` (calls before the window, the same path),
``checked_calls`` (window calls drawn from the seed, by a reservoir over
the window, whose every output is kept for the check) and
``reference_block`` (images the reference runs at once).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from perfbench import harness, work
from perfbench.entries import _snn
from perfbench.reference import snn as ref
from perfbench.trace import device_events, profiled, reduce

# the outputs of a call that are checked, and the reference's names
OUTPUTS = {"pred": "pred", "spike_counts": "counts", "first_spike_t": "first",
           "v_final": "v_last", "prng_state": "lanes"}


def run(ctx: harness.Context) -> None:
    from repro_torch.core import prng
    from repro_torch.core import snn as snn_mod
    tr, rec, spans, dev = ctx.traffic, ctx.record, ctx.spans, ctx.device
    sizes = ctx.cfg["layer_sizes"]
    n_in, T = sizes[0], int(ctx.cfg["num_steps"])
    B, depth = int(tr["batch"]), int(tr["in_flight"])
    codes = ctx.inputs["codes"] = _snn.make_codes(ctx.cfg, ctx.seed, dev)
    ctx.sync()
    ctx.mark("weights")
    pool = ctx.inputs["pool"] = _snn.make_pool(ctx.cfg, tr, ctx.seed)
    P = len(pool)
    cuda = dev.type == "cuda"
    # the pool laid out so that every call's images are one slice
    pixels = torch.from_numpy(np.take(pool, np.arange(P + B) % P, axis=0))
    if cuda:
        pixels = pixels.pin_memory()
    ctx.mark("pool")
    lanes = prng.seed_state(ctx.seed, (B, n_in), device=dev)
    ctx.sync()
    ctx.mark("seeding")
    cfg = _snn.program_config(ctx.cfg)
    params = {"layers": [{"w_q": w} for w in codes]}
    host = [torch.empty(B, dtype=torch.int64, pin_memory=cuda)
            for _ in range(depth)]

    def call(c, lanes):
        with spans("upload"):
            o = (c * B) % P
            px = pixels[o:o + B].to(dev, non_blocking=cuda)
        with spans("snn_apply_int"):
            return snn_mod.snn_apply_int(params, px, lanes, cfg)

    warm = int(tr["warmup_calls"])
    for c in range(warm):
        res = call(c, lanes)
        res["pred"].cpu()
        lanes = res["prng_state"]
    ctx.end_setup()
    rec["device"] = {"kind": torch.cuda.get_device_name(dev) if cuda
                     else "cpu"}
    spans.reset()
    spans.keep = ctx.trace
    m = int(tr["checked_calls"])
    rng = np.random.default_rng([ctx.seed, 2])
    kept: dict[int, dict] = {}
    slot_of: list[int] = []          # the call each reservoir slot holds
    inflight: collections.deque = collections.deque()
    ticks = []                       # (seconds into the window, calls)

    def harvest():
        ev = inflight.popleft()
        with spans("readback"):
            if ev is not None:
                ev.synchronize()

    with profiled(ctx.trace) as prof:
        w0 = time.time_ns()
        t0 = time.perf_counter()
        n = 0
        while (now := time.perf_counter() - t0) < ctx.seconds:
            if not ticks or now - ticks[-1][0] >= 1.0:
                ticks.append((now, n))
            if len(inflight) == depth:
                harvest()
            c = warm + n
            res = call(c, lanes)
            lanes = res["prng_state"]
            host[n % depth].copy_(res["pred"], non_blocking=cuda)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            inflight.append(ev)
            j = n if n < m else int(rng.integers(0, n + 1))
            if j < m:
                if j < len(slot_of):
                    del kept[slot_of[j]]
                    slot_of[j] = c
                else:
                    slot_of.append(c)
                # copies: the next call reads this call's lanes
                kept[c] = {f: res[f].clone() for f in OUTPUTS}
            n += 1
        while inflight:
            harvest()
        t1 = time.perf_counter()
        w1 = time.time_ns()
    spans.keep = False
    lane_steps = n * B * T
    rec.update(window_s=t1 - t0, images=n * B, launches=n,
               lane_steps=lane_steps,
               counts={"images": n * B, "launches": n,
                       "lane_steps": lane_steps},
               work={"ops": work.ops_per_lane_step(sizes) * lane_steps,
                     "bytes": work.batch_call_bytes(sizes, B) * n},
               spans={kk: list(v) for kk, v in spans.totals.items()},
               gc=list(spans.gc), ticks=ticks)
    if prof is not None:
        rec["trace"] = reduce(device_events(prof), w0, w1, spans.intervals)
    ctx.read_peak()
    ctx.answers = {"calls": n,
                   "kept": {c: {f: t.cpu() for f, t in out.items()}
                            for c, out in kept.items()}}


def _reference(ctx, calls, codes) -> dict[int, dict]:
    """The reference's outputs for the given calls (in increasing order):
    its own preload of the lanes from the seed, advanced ``num_steps`` a
    call to each call's, the call's images from the pool."""
    B, n_in = int(ctx.traffic["batch"]), ctx.cfg["layer_sizes"][0]
    T, dev = int(ctx.cfg["num_steps"]), ctx.device
    pool = torch.from_numpy(ctx.inputs["pool"]).to(dev)
    block = int(ctx.traffic["reference_block"])
    lanes = ref.seed_states(torch.tensor([ctx.seed], dtype=torch.int64,
                                         device=dev), B * n_in)
    lanes, at = lanes.reshape(B, n_in), 0
    out = {}
    for c in calls:
        lanes, at = ref.advance(lanes, T * (c - at)), c
        px = pool[((c * B + torch.arange(B)) % len(pool)).to(dev)]
        parts = [ref.window(px[sl], lanes[sl], codes, ctx.cfg)
                 for sl in harness.reference_blocks(B, block)]
        out[c] = {k: torch.cat([p[k] for p in parts]).cpu()
                  for k in OUTPUTS.values()}
    return out


def check(ctx: harness.Context, control: bool = False):
    """Every output of the sampled calls against the reference's: each
    number is the count of images whose output differs, with the limit 0;
    at least one call.  ``control`` judges the reference's outputs at
    8-bit codes in the program's place.  Returns ``(checks, attempted,
    failed)``."""
    a = ctx.answers
    calls, kept = a["calls"], a["kept"]
    order = sorted(kept)
    codes = [w.to(torch.int32) for w in ctx.inputs["codes"]]
    want = _reference(ctx, order, codes)
    if control:
        low = _reference(ctx, order, [ref.to_8bit_codes(w) for w in codes])
        kept = {c: {f: low[c][k] for f, k in OUTPUTS.items()} for c in order}
    checks = dict([harness.check("calls", calls, 1, at_least=True)])
    bad = {}
    for f, k in OUTPUTS.items():
        n = 0
        for c in order:
            g, w = kept[c][f], want[c][k]
            if g.dtype == torch.uint32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            diff = (g.to(torch.int64) != w.to(torch.int64)).reshape(
                g.shape[0], -1).any(dim=1)
            bad[c] = diff | bad.get(c, False)
            n += int(diff.sum())
        checks.update([harness.check(f"{f}_mismatch", n, 0)])
    failed = sum(int(b.sum()) for b in bad.values())
    return checks, calls * int(ctx.traffic["batch"]), failed
