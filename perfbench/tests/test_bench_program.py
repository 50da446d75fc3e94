"""The program's own spans (``repro_torch.core.spans``) against the
benchmark: an untraced run of each batch cell, driven on the CPU at the
fault tests' small sizes, never turns the program's recorder on, so the
end-to-end numbers pay only its off-checks; and a recording of
``snn_apply_int`` is what :func:`perfbench.trace.reduce` takes for spans,
each idle nanosecond labelled with the innermost program span open."""

import dataclasses
import time

import pytest
import torch

from perfbench import harness, trace

# the fault tests' small sizes
SMALL = {
    "snn784-batch": {"batch": 32, "warmup_calls": 1, "pool": 16,
                     "checked_calls": 2, "reference_block": 64},
    "wide-batch": {"batch": 8, "warmup_calls": 1, "pool": 8,
                   "checked_calls": 2, "reference_block": 16},
}


@pytest.mark.parametrize("cell", list(SMALL))
def test_untraced_run_leaves_the_recorder_off(cell, monkeypatch):
    from repro_torch.core import spans

    def refuse(*args):
        raise AssertionError("the program recorded a span in an untraced "
                             "benchmark run")
    monkeypatch.setattr(spans._Span, "__init__", refuse)
    rec = harness.run_cell(harness.HERE.parent, cell, 2**31 + 17, 0.3,
                           False, "cpu", time.perf_counter(),
                           traffic=SMALL[cell])
    line = harness.result_line(harness.HERE.parent, rec, False)
    assert line["correct"], line["checks"]
    assert rec["launches"] > 0 and spans._record is None


def test_program_spans_label_the_idle_gaps():
    from repro_torch.configs import snn_mnist as cfgs
    from repro_torch.core import snn, spans
    from repro_torch.core.prng import seed_state
    cfg = dataclasses.replace(cfgs.SNN_CONFIG, num_steps=4)
    g = torch.Generator().manual_seed(1)
    params = {"layers": [{"w_q": torch.randint(
        -256, 256, (784, 10), generator=g, dtype=torch.int16)}]}
    px = torch.randint(0, 256, (3, 784), generator=g, dtype=torch.uint8)
    w0 = time.time_ns()
    with spans.recording() as rec:
        snn.snn_apply_int(params, px, seed_state(2, (3, 784), device="cpu"), cfg,
                          backend="fused")
    w1 = time.time_ns()
    ivs = {name: (s, e) for name, s, e in rec.intervals}
    (a0, a1), (v0, v1), (o0, o1) = (ivs["snn.apply_int"],
                                    ivs["ops.validate_weight_codes"],
                                    ivs["ops.stack_operands"])
    # no device event: the whole window is idle, split by the spans
    gaps = dict(trace.reduce([], w0, w1, rec.intervals)["idle_gaps"])
    assert gaps["ops.validate_weight_codes"] == pytest.approx(
        (v1 - v0) / 1e9)
    assert gaps["ops.stack_operands"] == pytest.approx((o1 - o0) / 1e9)
    assert gaps["snn.apply_int"] == pytest.approx(
        (a1 - a0 - (v1 - v0) - (o1 - o0)) / 1e9)
    assert gaps.get("harness", 0.0) == pytest.approx(
        (w1 - w0 - (a1 - a0)) / 1e9)
    # a kernel over the operand set-up takes it out of the idle time
    busy = trace.reduce([("k", o0, o1, "kernel")], w0, w1, rec.intervals)
    assert "ops.stack_operands" not in dict(busy["idle_gaps"])
