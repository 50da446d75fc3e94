"""The benchmark's own spans, and the reduction of a profiler trace.

Spans are host-clock intervals the benchmark records around its calls
into the program (``time.time_ns``, the clock the profiler stamps its
events in).  In a ``--trace 1`` run the window runs under
``torch.profiler`` with CUDA activity only; :func:`reduce` turns the
device's kernels, copies and fills into busy time (the union of their
intervals, so that overlaps count once), kernel and copy time, the
device operations that took most time, and the idle gaps, each labelled
with the innermost benchmark span open on the host meanwhile.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["Spans", "profiled", "device_events", "union", "reduce"]


class Spans:
    """Host-clock spans of one run: their totals by label always, their
    intervals only while ``keep`` is set (the traced window), and the
    interpreter's garbage-collection pauses (count, seconds)."""

    def __init__(self):
        self.totals: dict[str, list] = {}
        self.intervals: list[tuple[str, int, int]] = []
        self.keep = False
        self.gc = [0, 0.0]
        self._gc_t0 = 0

    def gc_callback(self, phase: str, info: dict) -> None:
        """For ``gc.callbacks``: time every collection."""
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        else:
            self.gc[0] += 1
            self.gc[1] += (time.perf_counter_ns() - self._gc_t0) / 1e9

    @contextlib.contextmanager
    def __call__(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            tot = self.totals.setdefault(label, [0.0, 0])
            tot[0] += (t1 - t0) / 1e9
            tot[1] += 1
            if self.keep:
                self.intervals.append((label, t0, t1))

    def reset(self) -> None:
        self.totals.clear()
        self.intervals.clear()
        self.gc = [0, 0.0]


def profiled(on: bool):
    """``torch.profiler`` over the CUDA device when ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext(None)
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def device_events(prof) -> list[tuple[str, int, int, str]]:
    """The device's own events of a finished profile: ``(name, start_ns,
    end_ns, kind)``, kind ``"copy"`` for memcpy and memset, ``"kernel"``
    for every other operation; the CUDA runtime's host calls and the
    annotations' device shadows are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        name = e.name()
        kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
        out.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                    kind))
    return out


def union(intervals) -> list[tuple[int, int]]:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _length(ivs) -> int:
    return sum(e - s for s, e in ivs)


def _segments(spans, w0: int, w1: int) -> list[tuple[int, int, str]]:
    """``[w0, w1]`` cut into disjoint pieces, each labelled with the
    innermost span open over it (``"harness"`` where none is)."""
    points = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    out, stack, t = [], [], w0
    for p, is_start, i in points + [(w1, 0, -1)]:
        p = min(max(p, w0), w1)
        if p > t:
            out.append((t, p, spans[stack[-1]][0] if stack else "harness"))
            t = p
        if i < 0:
            continue
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return out


def reduce(events, w0: int, w1: int, spans, top: int = 10) -> dict:
    """Reduce device events to the traced window ``[w0, w1]`` (ns).

    Returns ``window_s``, ``busy_s`` (the union of every device interval),
    ``kernel_s`` and ``copy_s`` (the union of each kind's), ``device_ops``
    (the ``top`` operation names by summed device seconds) and
    ``idle_gaps`` (the device's idle seconds summed by the innermost span
    open on the host meanwhile, the ``top`` largest)."""
    clipped = [(n, max(s, w0), min(e, w1), k) for n, s, e, k in events
               if e > w0 and s < w1]
    busy = union((s, e) for _, s, e, _ in clipped)
    by_name: dict[str, int] = {}
    for n, s, e, _ in clipped:
        by_name[n] = by_name.get(n, 0) + e - s
    idle, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    gaps: dict[str, int] = {}
    segs, j = _segments(spans, w0, w1), 0
    for a, b in idle:                  # both sorted and disjoint
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, label = segs[k]
            gaps[label] = gaps.get(label, 0) + min(b, e) - max(a, s)
            k += 1

    def top_of(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": _length(busy) / 1e9,
            "kernel_s": _length(union(
                (s, e) for _, s, e, k in clipped if k == "kernel")) / 1e9,
            "copy_s": _length(union(
                (s, e) for _, s, e, k in clipped if k == "copy")) / 1e9,
            "device_ops": top_of(by_name), "idle_gaps": top_of(gaps)}
