"""The trace reduction on made-up device events and spans (the union of
device intervals, kernel and copy time, idle time by the host span open
meanwhile), the host spans, and, on a machine with a card, one short run
of each cell end to end (``-m cuda``)."""

import json
import subprocess
import sys

import pytest

from perfbench import harness, trace


def test_union_merges_overlaps():
    assert trace.union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4),
                                                              (5, 10)]


def test_reduce_counts_overlaps_once_and_labels_idle_time():
    events = [("k1", 10, 20, "kernel"), ("k1", 15, 30, "kernel"),
              ("Memcpy HtoD (Pageable -> Device)", 40, 50, "copy"),
              ("k2", 90, 130, "kernel")]
    spans = [("step", 0, 60), ("compaction", 5, 45), ("submit", 60, 100)]
    r = trace.reduce(events, 0, 100, spans)
    assert r["window_s"] == pytest.approx(100e-9)
    # busy: [10, 30) ∪ [40, 50) ∪ [90, 100) = 40 ns
    assert r["busy_s"] == pytest.approx(40e-9)
    assert r["kernel_s"] == pytest.approx(30e-9)
    assert r["copy_s"] == pytest.approx(10e-9)
    assert r["device_ops"][0] == ["k1", pytest.approx(25e-9)]
    # idle [0,10): step 5 + compaction 5; [30,40): compaction;
    # [50,90): step 10 + submit 30
    gaps = dict(r["idle_gaps"])
    assert gaps == {"submit": pytest.approx(30e-9),
                    "step": pytest.approx(15e-9),
                    "compaction": pytest.approx(15e-9)}
    assert sum(gaps.values()) == pytest.approx(r["window_s"] - r["busy_s"])


def test_idle_time_outside_every_span_is_the_harness():
    r = trace.reduce([], 0, 10, [("step", 2, 4)])
    assert dict(r["idle_gaps"]) == {"harness": pytest.approx(8e-9),
                                    "step": pytest.approx(2e-9)}


def test_spans_total_and_keep_intervals_only_when_asked():
    spans = trace.Spans()
    with spans("inputs"):
        pass
    assert spans.totals["inputs"][1] == 1 and not spans.intervals
    spans.keep = True
    with spans("snn_apply_int"):
        with spans("inputs"):
            pass
    assert [s[0] for s in spans.intervals] == ["inputs", "snn_apply_int"]
    assert spans.totals["inputs"][1] == 2
    spans.reset()
    assert not spans.totals and not spans.intervals


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark(
    harness.HERE.parent)["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_card(cell, traced):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 777), "--seconds", "2", "--trace", str(traced)],
        cwd=harness.HERE.parent, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, name
