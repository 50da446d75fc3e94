"""The LM training entry: the port's training step (``train.step``:
``init_state`` and ``make_train_step``, on one card, unplaced, as
``launch.train.train`` runs it) called back to back.

Set-up draws the weights from the seed (``_lm.make_weights``) and hands
them to the program's model, draws ``pool_batches`` token batches from
the seed into pinned host memory, and builds the one training state the
run uses.  Its first ``checked_steps`` steps, on pool batches 0, 1, …,
go through the window's own call and warm every shape up; the reference
follows them in the check.  Step ``k`` uploads pool batch ``k mod
pool_batches`` inside its call.  The window then runs steps on the same
state until ``--seconds`` have passed, at most ``in_flight`` queued ahead
of the card, and ends when the last step's update is done on the card;
every token of every step counts.  The microbatches are the port's own
rule (``launch.specs.num_microbatches`` on one data way).

Traffic keys: ``batch`` (sequences a step), ``seq_len``, ``in_flight``,
``pool_batches``, ``checked_steps``, ``reference_rows`` (sequences the
reference runs at once) and ``tokens`` (the token stream's statistics).
"""

from __future__ import annotations

import collections
import math
import statistics
import time

import torch

from perfbench import harness
from perfbench.entries import _lm
from perfbench.trace import device_events, profiled, reduce, union

# the references in the program's place that judge the comparison: the
# precision below the configuration's bf16 products, a term left out, and
# half of each batch left out
CONTROLS = {"fp8": {"matmul": "fp8"}, "no_d_skip": {"d_skip": False},
            "half_batch": {"keep_rows": 0.5}}
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under AdamW: its change is not compared
NOUGHT = 1e-3


def _norms(leaves) -> dict[str, float]:
    """Each ``(name, tensor)``'s norm, the tensors taken one at a time."""
    out = {n: torch.linalg.vector_norm(t, dtype=torch.float64)
           for n, t in leaves}
    return dict(zip(out, torch.stack(list(out.values())).cpu().tolist()))


def run(ctx: harness.Context) -> None:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import num_microbatches
    from repro_torch.train.step import init_state, make_train_step
    ctx.mark("port")
    tr, rec, spans, dev, cfg = (ctx.traffic, ctx.record, ctx.spans,
                                ctx.device, ctx.cfg)
    B, S = int(tr["batch"]), int(tr["seq_len"])
    cuda = dev.type == "cuda"
    arch = _lm.program_config(cfg)
    nm = num_microbatches(arch, ShapeConfig("perfbench", S, B, "train"), 1)
    model = _lm.program_model(arch, _lm.make_weights(cfg, ctx.seed, dev))
    ctx.sync()
    ctx.mark("weights")
    pool = ctx.inputs["pool"] = _lm.make_pool(cfg, tr, ctx.seed)
    P = len(pool)
    host = torch.from_numpy(pool)
    if cuda:
        host = host.pin_memory()
    ctx.mark("pool")
    settings = _lm.settings(cfg, nm)
    state = init_state(None, arch, settings, init_fn=lambda _: model,
                       device=dev)
    del model
    step = make_train_step(arch, settings)
    ctx.sync()
    ctx.mark("state")

    def call(k, state):
        with spans("upload"):
            toks = host[k % P].to(dev, non_blocking=cuda)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        with spans("train_step"):
            return step(state, batch)

    checked = int(tr["checked_steps"])
    b1 = float(cfg["optimizer"]["b1"])
    seen = []
    for k in range(checked):
        state, m = call(k, state)
        seen.append((m["loss"], m["grad_norm"]))
        if k == 0:     # the optimizer's first moment is (1 - b1) · g
            first = _norms((n, mu / (1 - b1))
                           for n, mu in state.opt_state.mu.items())
    start = _lm.make_weights(cfg, ctx.seed, dev)
    change = _norms((n, p.detach() - start[n])
                    for n, p in state.params.named_parameters())
    del start
    losses = [float(a) for a, _ in seen]
    gnorms = [float(b) for _, b in seen]
    ctx.end_setup()
    rec["device"] = {"kind": torch.cuda.get_device_name(dev) if cuda
                     else "cpu"}
    spans.reset()
    spans.keep = ctx.trace
    inflight: collections.deque = collections.deque()
    ticks = []

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
            if len(inflight) == int(tr["in_flight"]):
                harvest()
            state, m = call(checked + n, state)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            inflight.append(ev)
            n += 1
        while inflight:
            harvest()
        ctx.sync()
        t1 = time.perf_counter()
        w1 = time.time_ns()
    spans.keep = False
    wk = _lm.work(cfg).step_work(_lm.as_run(cfg), B, S)
    rec.update(window_s=t1 - t0, tokens=n * B * S, steps=n,
               counts={"tokens": n * B * S, "steps": n, "microbatches": nm},
               work={k: v * n for k, v in wk.items()},
               spans={kk: list(v) for kk, v in spans.totals.items()},
               gc=list(spans.gc), ticks=ticks)
    if prof is not None:
        events = device_events(prof)
        rec["trace"] = reduce(events, w0, w1, spans.intervals)
        rec["trace"]["gemm_s"] = sum(e - s for s, e in union(
            (max(s, w0), min(e, w1)) for name, s, e, kind in events
            if kind == "kernel" and e > w0 and s < w1
            and _lm.GEMM_KERNEL.search(name))) / 1e9
    ctx.read_peak()
    ctx.answers = {"steps": n, "loss": losses, "grad_norm": gnorms,
                   "first_grad": first, "change": change}


def _reference(ctx, **kw) -> dict:
    """The reference's readings of the checked steps: the weights drawn
    again from the seed, the same pool batches."""
    tr, cfg = ctx.traffic, ctx.cfg
    keep = kw.pop("keep_rows", None)
    batches = [torch.from_numpy(ctx.inputs["pool"][k]).to(ctx.device)
               for k in range(int(tr["checked_steps"]))]
    return _lm.reference(cfg).train_steps(
        _lm.make_weights(cfg, ctx.seed, ctx.device), batches,
        _lm.as_run(cfg),
        rows=int(tr["reference_rows"]),
        keep_rows=None if keep is None else int(keep * int(tr["batch"])),
        **kw)


def _ppm(gap: float) -> int:
    return int(math.ceil(gap * 1e6))


def _worst_leaf(got: dict, want: dict, names) -> int:
    """The worst leaf's gap of norms, against the larger of its reference
    norm and the median leaf's, in parts per million."""
    floor = statistics.median(want[n] for n in names)
    return _ppm(max(abs(got[n] - want[n]) / max(want[n], floor)
                    for n in names))


def compare(got: dict, want: dict, limits: dict) -> dict:
    """The compared numbers of the checked steps, each beside its limit:
    the worst step's relative gap of the loss and of the global gradient
    norm, and the worst leaf's gap of the first gradient's norm and of
    the change's norm (leaves with a nought reference gradient left out
    of the change)."""
    def step_gap(key):
        return _ppm(max(abs(g - w) / abs(w) for g, w in
                        zip(got[key], want[key])))
    fg = want["first_grad"]
    med = statistics.median(fg.values())
    moved = [n for n in fg if fg[n] >= NOUGHT * med]
    values = {"loss_gap_ppm": step_gap("loss"),
              "grad_norm_gap_ppm": step_gap("grad_norm"),
              "first_grad_leaf_gap_ppm": _worst_leaf(got["first_grad"], fg,
                                                     list(fg)),
              "change_leaf_gap_ppm": _worst_leaf(got["change"],
                                                 want["change"], moved)}
    return dict(harness.check(k, v, int(limits[k]))
                for k, v in values.items())


def check(ctx: harness.Context, control: bool = False):
    """The checked steps' loss, global gradient norm, first gradient and
    change by leaf against the reference's, each a count in parts per
    million against the configuration's ``limits``; at least one window
    step.  ``control`` judges each of :data:`CONTROLS` in the program's
    place instead, its numbers named ``<control>.<number>``.  Returns
    ``(checks, attempted, failed)``."""
    a, limits = ctx.answers, ctx.cfg["limits"]
    if "reference" not in a:
        t0 = time.perf_counter()
        a["reference"] = _reference(ctx)
        ctx.record["reference_s"] = time.perf_counter() - t0
    want = a["reference"]
    checked = int(ctx.traffic["checked_steps"])
    if control:
        checks = {}
        for name, kw in CONTROLS.items():
            checks.update({f"{name}.{k}": c for k, c in compare(
                _reference(ctx, **kw), want, limits).items()})
        return checks, checked, 0
    checks = dict([harness.check("steps", a["steps"], 1, at_least=True)])
    checks.update(compare(a, want, limits))
    failed = 0 if all(c["ok"] for c in checks.values()) else checked
    return checks, checked + a["steps"], failed
