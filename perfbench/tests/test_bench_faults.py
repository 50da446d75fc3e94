"""The comparison that decides ``correct``, shown to fail: each cell's run,
driven past the look for a card on the CPU at a size a test holds, with
the timed path broken underneath (a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced), and with the control (the reference at 8-bit codes in the
program's place).  A one-card cell has no exchange between chips to
leave out.  The sound run of each passes."""

import time

import pytest
import torch

from perfbench import harness

SMALL = {
    "snn784-batch": {"batch": 32, "warmup_calls": 1, "pool": 16,
                     "checked_calls": 2, "reference_block": 64},
    "wide-batch": {"batch": 8, "warmup_calls": 1, "pool": 8,
                   "checked_calls": 2, "reference_block": 16},
}
BATCH = list(SMALL)


def _run(cell, *, control=False, seconds=0.3):
    rec = harness.run_cell(harness.HERE.parent, cell, 2**31 + 99, seconds,
                           False, "cpu", time.perf_counter(),
                           control=control, traffic=SMALL[cell])
    return rec, harness.result_line(harness.HERE.parent, rec, False)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    _, line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    rec, line = _run(cell, control=True)
    assert line["correct"], line["checks"]
    assert not all(c["ok"] for c in rec["control_checks"].values())


# ---- the whole-window batch path's faults ---------------------------------

@pytest.fixture
def snn_mod():
    from repro_torch.core import snn
    return snn


@pytest.mark.parametrize("cell", BATCH)
def test_batch_state_unchanged(cell, snn_mod, monkeypatch):
    apply = snn_mod.snn_apply_int

    def unchanged(params, pixels, lanes, cfg, **kw):
        res = apply(params, pixels, lanes, cfg, **kw)
        zero = torch.zeros_like(res["spike_counts"])
        return dict(res, spike_counts=zero, v_final=zero,
                    first_spike_t=zero + cfg.num_steps, prng_state=lanes,
                    pred=torch.zeros_like(res["pred"]))
    monkeypatch.setattr(snn_mod, "snn_apply_int", unchanged)
    _, line = _run(cell)
    assert not line["correct"]


@pytest.mark.parametrize("cell", BATCH)
def test_batch_half_left_out(cell, snn_mod, monkeypatch):
    apply = snn_mod.snn_apply_int

    def half(params, pixels, lanes, cfg, **kw):
        h = pixels.shape[0] // 2
        res = apply(params, pixels[:h], lanes[:h], cfg, **kw)
        return {k: torch.cat([res[k], res[k]]) for k in
                ("pred", "spike_counts", "first_spike_t", "v_final",
                 "prng_state")}
    monkeypatch.setattr(snn_mod, "snn_apply_int", half)
    _, line = _run(cell)
    assert not line["correct"]


@pytest.mark.parametrize("cell", BATCH)
def test_batch_answer_altered(cell, snn_mod, monkeypatch):
    apply = snn_mod.snn_apply_int

    def altered(params, pixels, lanes, cfg, **kw):
        res = apply(params, pixels, lanes, cfg, **kw)
        pred = res["pred"].clone()
        pred[1] = (pred[1] + 1) % cfg.n_classes
        return dict(res, pred=pred)
    monkeypatch.setattr(snn_mod, "snn_apply_int", altered)
    _, line = _run(cell)
    assert not line["correct"]
