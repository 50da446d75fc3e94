"""The LM training entry (``entries/lm_train.py``) end to end on the CPU at
a size a test holds: the port's train step on mamba2-1.3b's reduced
widths, float32, against ``reference/mamba2.py``; the comparison shown to
fail with the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out, the loss altered where it is
produced, one layer's update left out) and with each control in the
program's place; the configuration's file against the port's registry
and the reference's leaves against the program's parameters at the
published widths; the LM readers on a made-up record and on an SNN
record; the SNN cells' metric lists as they were."""

import dataclasses
import json
import time

import pytest
import torch

from perfbench import harness, work_lm
from perfbench.entries import _lm

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "mamba2-train"
CFG = harness.cell_files(BENCH, CELL)[1]
RUN = _lm.as_run(CFG)          # the configuration as the program runs it
# mamba2-1.3b's reduced widths (``configs.get_reduced``), float32
SMALL_CFG = {"n_layer": 2, "d_model": 64, "d_state": 16, "headdim": 16,
             "chunk_size": 8, "vocab_size": 256,
             "program": {"num_layers": 2, "d_model": 64, "ssm_state": 16,
                         "ssm_head_dim": 16, "ssm_chunk": 8,
                         "vocab_size": 256, "tie_embeddings": True,
                         "compute_dtype": "float32"}}
SMALL_TR = {"batch": 8, "seq_len": 32, "pool_batches": 4,
            "reference_rows": 2}
LM_READERS = ["train_tokens_per_s", "lm_train_mfu", "lm_kernels_roofline",
              "lm_device_idle_pct", "lm_gemm_busy_pct"]


def _run(*, control=False, config=None, seconds=0.3):
    rec = harness.run_cell(ROOT, CELL, 2**31 + 77, seconds, False, "cpu",
                           time.perf_counter(), control=control,
                           traffic=SMALL_TR,
                           config=dict(SMALL_CFG, **(config or {})))
    return rec, harness.result_line(ROOT, rec, False)


@pytest.mark.parametrize("row_block", [256, 8])
def test_sound_run_is_correct(row_block, monkeypatch):
    # 8: the reference's SSD through its blocks below the diagonal too
    from perfbench.reference import mamba2
    monkeypatch.setattr(mamba2, "ROW_BLOCK", row_block)
    rec, line = _run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    checked = harness.cell_files(BENCH, CELL)[2]["checked_steps"]
    assert checked == 3                      # the first three steps
    assert line["attempted"] == rec["steps"] + checked > checked
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert rec["counts"]["microbatches"] == 2          # the port's rule, 8 rows
    assert rec["tokens"] == rec["steps"] * 8 * 32
    # float32 on both sides: the chunked scan and the quadratic SSD agree
    assert all(c["value"] <= 10 for k, c in line["checks"].items()
               if k.endswith("_ppm")), line["checks"]


def test_each_control_is_not_correct():
    # limits at this size: the float32 program reads at most a few ppm
    rec, line = _run(control=True, config={"limits": dict.fromkeys(
        CFG["limits"], 100)})
    assert line["correct"], line["checks"]
    ctl = rec["control_checks"]
    for name in ("fp8", "no_d_skip", "half_batch"):
        mine = [c for k, c in ctl.items() if k.startswith(name + ".")]
        assert len(mine) == 4 and not all(c["ok"] for c in mine), name


# ---- the training step's faults, at the cell's own limits -----------------

@pytest.fixture
def step_mod():
    from repro_torch.train import step
    return step


def test_state_unchanged(step_mod, monkeypatch):
    monkeypatch.setattr(step_mod, "streamed_update",
                        lambda opt, grads, opt_state, params, **kw:
                        (params, opt_state))
    _, line = _run()
    assert not line["correct"]
    assert line["checks"]["change_leaf_gap_ppm"]["value"] == 10**6


def test_half_batch_left_out(step_mod, monkeypatch):
    split = step_mod._split_rows

    def half(batch, nm):
        return [{k: v[:v.shape[0] // 2] for k, v in mb.items()}
                for mb in split(batch, nm)]
    monkeypatch.setattr(step_mod, "_split_rows", half)
    _, line = _run()
    assert not line["correct"]


def test_loss_altered(step_mod, monkeypatch):
    make = step_mod.make_loss_fn

    def altered(*args, **kw):
        loss_fn = make(*args, **kw)

        def fn(model, batch):
            loss, metrics = loss_fn(model, batch)
            return loss * 1.01, metrics
        return fn
    monkeypatch.setattr(step_mod, "make_loss_fn", altered)
    _, line = _run()
    assert not line["correct"]
    c = line["checks"]["loss_gap_ppm"]
    assert c["value"] > c["limit"]


def test_one_layer_update_left_out(step_mod, monkeypatch):
    apply = step_mod.opt_mod.apply_updates

    def skip(params, updates):
        return apply(params, {n: torch.zeros_like(u) if
                              n.startswith("layers.1.") else u
                              for n, u in updates.items()})
    monkeypatch.setattr(step_mod.opt_mod, "apply_updates", skip)
    _, line = _run()
    assert not line["correct"]
    c = line["checks"]["change_leaf_gap_ppm"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("leaf", ["A_log", "D", "dt_bias", "conv_b"])
def test_one_small_leaf_update_left_out(leaf, step_mod, monkeypatch):
    # the leaves of 8 values at this size (64 at the cell's), each gap
    # taken against the median leaf's norm where that is the larger
    apply = step_mod.opt_mod.apply_updates
    name = f"layers.1.mamba.{leaf}"

    def skip(params, updates):
        return apply(params, {n: torch.zeros_like(u) if n == name else u
                              for n, u in updates.items()})
    monkeypatch.setattr(step_mod.opt_mod, "apply_updates", skip)
    _, line = _run()
    assert not line["correct"]
    c = line["checks"]["change_leaf_gap_ppm"]
    assert c["value"] > c["limit"]


# ---- the configuration against the program --------------------------------

def test_configuration_echoes_the_registry():
    from repro_torch.configs import get_config
    arch = _lm.program_config(CFG)
    assert arch == dataclasses.replace(get_config(CFG["arch"]),
                                       **CFG["program"])
    assert CFG["reduced"] == []
    pairs = {"n_layer": "num_layers", "d_model": "d_model",
             "vocab_size": "vocab_size", "d_state": "ssm_state",
             "headdim": "ssm_head_dim", "expand": "ssm_expand",
             "d_conv": "ssm_conv", "chunk_size": "ssm_chunk",
             "tie_embeddings": "tie_embeddings",
             "param_dtype": "param_dtype", "compute_dtype": "compute_dtype"}
    for key, field in pairs.items():
        assert CFG[key] == getattr(arch, field), key
    # the departures only the program could undo, and no more
    assert set(CFG["assumed"]["as_run"]) == {
        "pad_vocab_size_multiple", "norm_epsilon", "residual_in_fp32",
        "conv_bias"}
    assert arch.padded_vocab == work_lm._widths(RUN)["Vp"] == 50432
    assert (work_lm.parameters(RUN)
            == sum(p.numel() for p in _meta_model().parameters()))


def _meta_model():
    spec = _lm.reference(CFG).leaves(RUN)
    return _lm.program_model(
        _lm.program_config(CFG),
        {n: torch.empty(s, device="meta") for n, s, _ in spec})


def test_reference_leaves_are_the_programs_parameters():
    model = _meta_model()        # names and shapes checked on assignment
    spec = _lm.reference(CFG).leaves(RUN)
    assert sorted(n for n, _, _ in spec) == sorted(
        n for n, _ in model.named_parameters())
    assert len(spec) == 48 * 14 + 2          # the head tied: no lm_head


def test_weights_come_from_the_seed():
    a = _lm.make_weights(CFG | SMALL_CFG, 5, "cpu")
    assert "lm_head" not in a
    b = _lm.make_weights(CFG | SMALL_CFG, 5, "cpu")
    c = _lm.make_weights(CFG | SMALL_CFG, 6, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.0.mamba.wx"], c["layers.0.mamba.wx"])
    dt = torch.nn.functional.softplus(a["layers.1.mamba.dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1001
    A = torch.exp(a["layers.0.mamba.A_log"])
    assert 1 <= float(A.min()) and float(A.max()) <= 16


# ---- the readers ----------------------------------------------------------

def _reader(name):
    return harness.load_module("metrics", name).read


def test_lm_readers_on_a_made_up_record():
    wk = work_lm.step_work(RUN, 8, 2048)
    rec = {"tokens": 10 * 16384, "steps": 10, "window_s": 20.0,
           "work": {k: 10 * v for k, v in wk.items()},
           "trace": {"window_s": 20.0, "busy_s": 19.0, "kernel_s": 18.5,
                     "copy_s": 0.1, "gemm_s": 4.75, "device_ops": [],
                     "idle_gaps": []}}
    assert _reader("train_tokens_per_s")(rec) == pytest.approx(8192.0)
    assert _reader("lm_train_mfu")(rec) == pytest.approx(
        100 * 10 * wk["flops"] / (20.0 * 989e12))
    assert _reader("lm_kernels_roofline")(rec) == pytest.approx(
        100 * 10 * wk["flops"] / 989e12 / 18.5)
    assert _reader("lm_device_idle_pct")(rec) == pytest.approx(5.0)
    assert _reader("lm_gemm_busy_pct")(rec) == pytest.approx(25.0)
    plain = {k: v for k, v in rec.items() if k != "trace"}
    assert _reader("lm_kernels_roofline")(plain) is None
    assert _reader("lm_gemm_busy_pct")(plain) is None


@pytest.mark.parametrize("metric", LM_READERS)
def test_lm_readers_find_nothing_in_an_snn_record(metric):
    rec = {"entry": "batch", "launches": 10, "window_s": 0.2,
           "images": 100000, "lane_steps": 2000000,
           "work": {"ops": 2.3e13, "bytes": 1e9},
           "trace": {"window_s": 0.2, "busy_s": 0.16, "kernel_s": 0.15,
                     "copy_s": 0.01, "device_ops": [],
                     "idle_gaps": [["snn_apply_int", 0.03]]}}
    assert _reader(metric)(rec) is None


# the parent's lists: the LM metrics reach no SNN cell
SNN_METRICS = {
    ("wide-batch", False): ["batch_images_per_s.wide", "setup_s"],
    ("wide-batch", True): ["wrapper_idle_ms_per_call.wide",
                           "snn_kernels_roofline.wide", "snn_mfu.wide",
                           "device_idle_pct.wide"],
    ("snn784-batch", False): ["batch_images_per_s.snn784", "setup_s"],
    ("snn784-batch", True): ["wrapper_idle_ms_per_call.snn784",
                             "snn_kernels_roofline.snn784",
                             "snn_mfu.snn784", "device_idle_pct.snn784"],
}


@pytest.mark.parametrize("cell,traced", list(SNN_METRICS))
def test_snn_cells_report_what_they_did(cell, traced):
    assert [m["name"] for m in harness._metric_names(BENCH, cell, traced)] \
        == SNN_METRICS[cell, traced]


def test_lm_cell_reports_the_rate_and_its_layers():
    assert [m["name"] for m in harness._metric_names(BENCH, CELL, False)] \
        == ["train_tokens_per_s", "setup_s"]
    assert sorted(m["name"] for m in harness._metric_names(BENCH, CELL,
                                                           True)) \
        == sorted(LM_READERS[1:])


def test_step_work_by_hand():
    # per layer: in-projections 2048 × (2·4096 + 2·128 + 64), out 4096 × 2048
    layer = 2048 * (8192 + 256 + 64) + 4096 * 2048
    assert work_lm.matrix_parameters(RUN) == 48 * layer + 2048 * 50277
    # SSD a chunk: 256·257·(128 + 4096) + 2·256·128·4096 + 2·4096·128
    #              + 2·256·128·4096, 8 chunks a 2,048-token sequence
    chunk = 256 * 257 * 4224 + 2 * 268435456 + 1048576
    assert work_lm.ssd_flops(RUN, 2048) == 8 * chunk
    wk = work_lm.step_work(RUN, 8, 2048)
    assert wk["flops"] == 6 * (48 * layer + 2048 * 50277) * 16384 \
        + 3 * 48 * 8 * 8 * chunk
    assert wk["flops"] == pytest.approx(1.394e14, rel=1e-3)
    # stored: the layers, the tied embedding of 50,432 rows, the final norm
    stored = 48 * (layer + 4 * (4096 + 256) + 3 * 64 + 4096 + 2048) \
        + 50432 * 2048 + 2048
    assert work_lm.parameters(RUN) == stored
    assert wk["bytes"] == 36 * stored
    t, bound = work_lm.least_time(wk["flops"], wk["bytes"])
    assert bound == "flops" and t == pytest.approx(wk["flops"] / 989e12)


@pytest.mark.parametrize("path", ["reference/mamba2.py", "work_lm.py",
                                  "traffic/tokens.py", "metrics/_lm.py"])
def test_yardstick_imports_nothing_of_the_program(path):
    import ast
    tree = ast.parse((harness.HERE / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", *harness.JAX_MODULES}, tops
