"""Deterministic wall-clock timing harness (the measured half of ``tune``).

:func:`measure` makes ``warmup`` un-timed calls first (kernel loading and
allocator warm-up never pollute a sample), then ``repeats`` timed calls on
the monotonic clock, reported as the **median** with the stddev beside
it.  What is timed is a whole call as the host sees it — for the tuner a
whole serve, host scheduling included — so the clock is the host's, read
after ``torch.cuda.synchronize()`` has waited for the card's queued work;
CUDA events would time only the kernels.

Every :class:`TimingRecord` is tagged with ``device_kind`` (``"cpu"``, or
the card's name, e.g. ``"NVIDIA H100 80GB HBM3"``) and ``interpret``
(the timed path ran a kernel backend's plain version on the CPU): a CPU
number is a correctness artifact, never a device timing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["TimingRecord", "measure", "device_kind_now"]


def device_kind_now(device: str | torch.device | None = None) -> str:
    """The kind of ``device`` as a dispatch-cache key names it: ``"cpu"``,
    or the CUDA card's name (None = the card; raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _live_kind() -> str:
    """The kind of the device the process has dispatched to: the current
    card once CUDA is initialised, else ``"cpu"``."""
    if torch.cuda.is_initialized():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


@dataclass(frozen=True)
class TimingRecord:
    """One timed measurement: median-of-k wall-clock plus its provenance."""

    median_s: float          # median of the timed samples
    stddev_s: float          # population stddev of the timed samples
    samples_s: tuple         # every timed sample, in call order
    repeats: int
    warmup: int
    device_kind: str         # "cpu" or the card's name
    interpret: bool          # True = a kernel's plain version on the CPU

    @property
    def us(self) -> float:
        """Median in microseconds."""
        return self.median_s * 1e6

    def to_json(self) -> dict:
        return {
            "median_s": self.median_s,
            "stddev_s": self.stddev_s,
            "samples_s": list(self.samples_s),
            "repeats": self.repeats,
            "warmup": self.warmup,
            "device_kind": self.device_kind,
            "interpret": self.interpret,
        }


def _block() -> None:
    """Wait for the card's queued work, where the process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, *args, repeats: int = 3, warmup: int = 1,
            interpret: bool = False,
            device_kind: str | None = None) -> TimingRecord:
    """Median-of-``repeats`` wall-clock of ``fn(*args)`` after ``warmup``.

    ``interpret`` must be set by the caller when the timed path runs a
    kernel backend's plain version on the CPU.  ``device_kind`` defaults
    to the device the process dispatches to (the card once CUDA is
    initialised, else ``"cpu"``).
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    for _ in range(warmup):
        fn(*args)
        _block()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _block()
        samples.append(time.perf_counter() - t0)
    return TimingRecord(
        median_s=float(np.median(samples)),
        stddev_s=float(np.std(samples)),
        samples_s=tuple(float(s) for s in samples),
        repeats=repeats,
        warmup=warmup,
        device_kind=_live_kind() if device_kind is None else device_kind,
        interpret=bool(interpret),
    )
