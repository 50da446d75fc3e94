"""The port's span and counter recorder (``core.spans``) and its sites on
the bulk path's wrapper.

Off, a span is one shared no-op that reads no clock; on, spans keep their
opening order, nesting and totals on ``time.time_ns``, and counters add
up.  ``snn_apply_int`` on the CPU (the stack kernels' plain versions
behind the same wrappers) records its own span around the weight-code
validation and the operand set-up, counts two host syncs a layer, and
returns the same integers with recording on and off.  The card test
lays the launch span over a ``torch.profiler`` trace: the kernel starts
on the device after the span opened on the host, on the same clock.
"""

import dataclasses
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs import snn_mnist as cfgs
from repro_torch.core import snn, spans
from repro_torch.core.prng import seed_state
from repro_torch.kernels import fused_snn


def _no_clock():
    raise AssertionError("a span read the clock with recording off")


def test_off_span_is_one_shared_noop(monkeypatch):
    monkeypatch.setattr(spans.time, "time_ns", _no_clock)
    first = spans.span("a")
    held = [spans.span(f"s{i}") for i in range(100)]
    assert all(s is first for s in held)
    with spans.span("a") as got:
        spans.count("host_syncs", 2)
    assert got is None and spans._record is None
    monkeypatch.undo()
    with spans.recording() as rec:
        pass
    assert rec.intervals == [] and rec.totals == {} and rec.counters == {}


def test_off_span_allocates_nothing_it_keeps():
    """Spans opened and closed with recording off leave no allocation of
    the recorder's alive; with recording on they do (the record)."""
    def traced_bytes(n):
        tracemalloc.start()
        try:
            for _ in range(n):
                with spans.span("x"):
                    spans.count("c")
            snap = tracemalloc.take_snapshot().filter_traces(
                [tracemalloc.Filter(True, spans.__file__)])
            return sum(s.size for s in snap.statistics("filename"))
        finally:
            tracemalloc.stop()

    assert traced_bytes(1000) == 0
    with spans.recording() as rec:
        assert traced_bytes(1000) > 0
    assert rec.totals["x"][1] == 1000 and rec.counters == {"c": 1000}


def test_recording_keeps_order_nesting_and_totals():
    before = time.time_ns()
    with spans.recording() as rec:
        with spans.span("outer"):
            with spans.span("inner"):
                spans.count("n", 2)
            with spans.span("inner"):
                pass
        spans.count("n")
        spans.count("m", 5)
    after = time.time_ns()
    assert [iv[0] for iv in rec.intervals] == ["outer", "inner", "inner"]
    (_, o0, o1), (_, a0, a1), (_, b0, b1) = rec.intervals
    assert before <= o0 <= a0 <= a1 <= b0 <= b1 <= o1 <= after
    assert rec.totals["outer"][1] == 1 and rec.totals["inner"][1] == 2
    assert rec.totals["outer"][0] == pytest.approx((o1 - o0) / 1e9)
    assert rec.totals["inner"][0] == pytest.approx(
        (a1 - a0 + b1 - b0) / 1e9)
    assert rec.counters == {"n": 3, "m": 5}
    # off again: nothing more lands in the record
    with spans.span("late"):
        spans.count("n")
    assert len(rec.intervals) == 3 and rec.counters["n"] == 3


def test_intervals_are_time_ns(monkeypatch):
    ticks = iter(range(100, 1000, 100))
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    with spans.recording() as rec:
        with spans.span("a"):
            with spans.span("b"):
                pass
    assert rec.intervals == [("a", 100, 400), ("b", 200, 300)]
    assert rec.totals == {"a": [300 / 1e9, 1], "b": [100 / 1e9, 1]}


def test_second_recording_raises_and_leaves_the_first_on():
    with spans.recording() as rec:
        with pytest.raises(RuntimeError, match="already on"):
            with spans.recording():
                pass
        with spans.span("still"):
            pass
    assert [iv[0] for iv in rec.intervals] == ["still"]
    assert spans._record is None


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return []


_CASES = {
    "fused": dataclasses.replace(cfgs.SNN_CONFIG, num_steps=6),
    "fused_streamed": dataclasses.replace(
        cfgs.SNN_CONFIG_DEEP, layer_sizes=(200, 96, 64, 10), num_steps=6),
}


@pytest.mark.parametrize("backend", list(_CASES))
def test_snn_apply_int_records_its_wrapper(backend):
    cfg = _CASES[backend]
    sizes = cfg.layer_sizes
    rng = np.random.default_rng(len(sizes))
    params = {"layers": [
        {"w_q": torch.from_numpy(np.clip(np.round(rng.normal(
            6, 60, (i, o))), -256, 255).astype(np.int16))}
        for i, o in zip(sizes[:-1], sizes[1:])]}
    px = torch.from_numpy(rng.integers(0, 256, (5, sizes[0]),
                                       dtype=np.uint8))
    st = seed_state(11, (5, sizes[0]), device="cpu")
    off = snn.snn_apply_int(params, px, st, cfg, backend=backend)
    with spans.recording() as rec:
        on = snn.snn_apply_int(params, px, st, cfg, backend=backend)
    names = [iv[0] for iv in rec.intervals]
    assert names == ["snn.apply_int", "ops.validate_weight_codes",
                     "ops.stack_operands"]
    (_, c0, c1), *inner = rec.intervals
    assert all(c0 <= s <= e <= c1 for _, s, e in inner)
    assert {k: v[1] for k, v in rec.totals.items()} == dict.fromkeys(names, 1)
    assert rec.counters == {"host_syncs": 2 * (len(sizes) - 1),
                            "snn.apply_int." + backend: 1}
    assert sorted(on) == sorted(off)
    assert int(off["spike_counts"].sum()) > 0
    for k in off:
        g, w = _flat(on[k]), _flat(off[k])
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stack kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_span_precedes_its_kernel_on_the_profiler_clock(card):
    cfg = _CASES["fused"]
    g = torch.Generator().manual_seed(3)
    params = {"layers": [{"w_q": torch.randint(
        -200, 200, (784, 10), generator=g, dtype=torch.int16).to(card)}]}
    px = torch.randint(0, 256, (64, 784), generator=g,
                       dtype=torch.uint8).to(card)
    st = seed_state(5, (64, 784), device=card)
    snn.snn_apply_int(params, px, st, cfg, backend="fused")   # builds K1
    torch.cuda.synchronize()
    launches = fused_snn.fused_snn_stack.launches
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        with spans.recording() as rec:
            with spans.span("test.call"):
                snn.snn_apply_int(params, px, st, cfg, backend="fused")
            torch.cuda.synchronize()
    assert fused_snn.fused_snn_stack.launches == launches + 1
    assert rec.totals["fused_snn.launch"][1] == 1
    assert rec.counters == {"host_syncs": 2, "snn.apply_int.fused": 1}
    opened = {name: t0 for name, t0, _ in rec.intervals}
    dev = torch.autograd.DeviceType.CUDA
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == dev and "fused_snn_stack" in e.name()]
    assert len(starts) == 1
    assert opened["test.call"] <= opened["fused_snn.launch"] <= starts[0]
    (_, _, t1), = [iv for iv in rec.intervals if iv[0] == "test.call"]
    assert starts[0] - t1 < 10**9     # the same clock, not another epoch
