"""Host-clock spans and counters inside the port, for a traced run.

The program marks its layers with :func:`span` and counts events with
:func:`count`; both do nothing until :func:`recording` turns recording
on.  Off, ``span`` checks one module flag and returns one shared no-op
object: no clock read, no allocation.  On, each span appends ``(name,
t0_ns, t1_ns)`` to the record's ``intervals`` in the order the spans
opened (a span opened inside another comes after it) and adds its
seconds and one call to ``totals[name]``; ``count`` adds to
``counters[name]``.

Times are ``time.time_ns()``, the clock ``torch.profiler`` stamps its
device events in, so a span can be laid over a device trace: which host
span was open while the device sat idle.

Recording is per process and meant for one thread: spans opened on other
threads while it is on land in the same record, interleaved.  A span or
counter inside a layer that remat recomputes runs again in the backward
and counts again (the recompute runs on the thread that called
``backward``, on the CPU; on CUDA the autograd engine's device thread runs
it, into the same record).

    from repro_torch.core import spans
    with spans.recording() as rec:
        snn_apply_int(params, pixels, lanes, cfg)
    rec.totals["snn.apply_int"]   # [seconds, calls]
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["Record", "span", "count", "recording"]


@dataclass
class Record:
    """What one :func:`recording` collected: ``intervals`` ``(name,
    t0_ns, t1_ns)`` in the order the spans opened, ``totals`` ``name ->
    [seconds, calls]`` and ``counters`` ``name -> n``."""

    intervals: list = field(default_factory=list)
    totals: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)


_record: Record | None = None      # the open recording, None when off
_OFF = contextlib.nullcontext()    # the one span handed out while off


class _Span:
    __slots__ = ("_rec", "_name", "_at", "_t0")

    def __init__(self, rec: Record, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        iv = self._rec.intervals
        self._at = len(iv)
        iv.append(None)                # its place in opening order
        self._t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec, name = self._rec, self._name
        rec.intervals[self._at] = (name, self._t0, t1)
        tot = rec.totals.get(name)
        if tot is None:
            tot = rec.totals[name] = [0.0, 0]
        tot[0] += (t1 - self._t0) / 1e9
        tot[1] += 1
        return False


def span(name: str):
    """A context manager timing the block as ``name`` while recording is
    on; the shared no-op otherwise."""
    rec = _record
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _record
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn recording on for this process; yields the :class:`Record` and
    turns recording off on exit.  Raises if recording is already on."""
    global _record
    if _record is not None:
        raise RuntimeError("span recording is already on in this process")
    rec = _record = Record()
    try:
        yield rec
    finally:
        _record = None
