"""One run of one benchmark cell, driven by data.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``,
whose ``entry`` names the driver ``entries/<entry>.py``).  Each metric the
cell reports is read from the run's record by ``metrics/<metric>.py``.
Nothing here names a cell, a configuration or a metric.

The run: set-up (the program's imports; then the entry makes its weights
and inputs from the seed and warms up the cell's own shapes), the measured
window, then, with the window closed and the program's state freed, the
comparison with the plain reference that decides ``correct``.  The entry
writes the window's work (the model's operations and bytes, ``work``)
into the record, so that no reader needs to know the kind of entry, and
the window's counts (``counts``: name to whole number) that ``run.py``
and ``control.py`` print.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .trace import Spans

__all__ = ["HERE", "load_benchmark", "cell_files", "load_module",
           "Context", "run_cell", "result_line", "JAX_MODULES",
           "jax_loaded"]

HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded: JAX and the JAX package
JAX_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """The cell's ``workloads`` entry, its configuration and its traffic."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, cfg, traffic


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (a
    metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_loaded() -> list[str]:
    """The modules of ``sys.modules`` whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in JAX_MODULES)


@dataclass
class Context:
    """What an entry gets: the cell's files and the run's arguments; where
    it keeps the weights and inputs it makes in set-up (``inputs``) and
    what the window produced (``answers``) for its check, and where it
    records what it measured."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    inputs: dict = field(default_factory=dict)
    spans: Spans = field(default_factory=Spans)
    record: dict = field(default_factory=dict)
    answers: dict = field(default_factory=dict)   # what the window produced

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, part: str) -> None:
        """Set-up's seconds since the last mark belong to ``part``."""
        parts = self.record.setdefault("setup_parts", {})
        parts[part] = (time.perf_counter() - self.t_start
                       - sum(parts.values()))

    def end_setup(self) -> None:
        """Set-up ends here: every shape is warm, the window starts."""
        self.sync()
        self.mark("warm-up")
        self.record["setup_s"] = time.perf_counter() - self.t_start

    def read_peak(self) -> None:
        """The window's closed: the device memory peak of the run so far,
        set-up and window, before the reference allocates anything."""
        self.sync()
        self.record["memory_peak_bytes"] = (
            int(torch.cuda.max_memory_allocated(self.device))
            if self.device.type == "cuda" else 0)

    def free(self) -> None:
        """Free the program's state before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, *, control: bool = False,
             traffic: dict | None = None, config: dict | None = None) -> dict:
    """One run of cell ``name``; returns the record its metrics read.

    ``control`` also judges the control (``control_checks``): the
    entry's reference in a lower precision put in the program's place, on
    the same requests.  ``traffic`` and ``config`` replace some of the
    cell's traffic parameters and configuration keys (the CPU tests run
    the same path at a size a test holds)."""
    cell, cfg, tr = cell_files(load_benchmark(root), name)
    ctx = Context(cell=cell, cfg=dict(cfg, **(config or {})),
                  traffic=dict(tr, **(traffic or {})),
                  seed=int(seed), seconds=float(seconds), trace=trace,
                  device=torch.device(device), t_start=t_start)
    ctx.mark("imports")
    entry = load_module("entries", ctx.traffic["entry"])
    gc.callbacks.append(ctx.spans.gc_callback)
    ctx.record.update(cell=name, entry=ctx.traffic["entry"],
                      seed=int(seed), traffic=ctx.traffic)
    try:
        entry.run(ctx)
    finally:
        gc.callbacks.remove(ctx.spans.gc_callback)
    ctx.free()
    checks, attempted, failed = entry.check(ctx)
    ctx.record.update(checks=checks, attempted=attempted, failed=failed)
    if control:
        ctx.record["control_checks"] = entry.check(ctx, control=True)[0]
    if ctx.device.type == "cuda":
        ctx.record["power"] = _power_limit()
    return ctx.record


def _metric_names(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (a metric with a ``workloads`` key in the
    cells it lists; one without in every cell that reports the metric it
    ``moves``)."""
    def reports(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def result_line(root: Path, rec: dict, trace: bool) -> dict:
    """The contract's last line for a run's record: the cell's metrics
    (each read by its reader; a reader that finds nothing is left out),
    the device, ``breakdown`` when traced, and ``checks`` last."""
    bench = load_benchmark(root)
    metrics = {}
    for m in _metric_names(bench, rec["cell"], trace):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = rec.get("device", {})
    device = {"platform": "gpu", "kind": dev.get("kind"),
              "count": dev.get("count", 1),
              "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    if rec.get("power"):
        device["power"] = rec["power"]
    checks = rec["checks"]
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
            "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {kk: vv for kk, vv in c.items() if kk != "ok"}
                      for k, c in checks.items()}
    return line


def reference_blocks(n: int, block: int):
    """Slices of ``range(n)`` of at most ``block`` rows."""
    for a in range(0, n, block):
        yield slice(a, min(n, a + block))


def check(name: str, value: int, limit: int, *, at_least: bool = False):
    """One compared number beside its limit: ``value <= limit``, or with
    ``at_least`` ``value >= limit``."""
    ok = value >= limit if at_least else value <= limit
    return name, {"value": int(value), "limit": int(limit),
                  "kind": "min" if at_least else "max", "ok": bool(ok)}
