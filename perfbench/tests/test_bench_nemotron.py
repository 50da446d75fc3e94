"""The cell ``nemotron3-nano-train`` on the CPU at a size a test holds: the
port's train step on a reduced Nemotron-H (``MEMEM*E``, 8 experts routed
over with 4 held, Mamba-2 in 2 groups), float32, against
``reference/nemotron_h.py``; each control in the program's place; the
entry's traced path with the program's recorder; the configuration's
file against the catalog's keys and the port's registry, and the
reference's leaves against the program's parameters at the published
widths; the two MoE readers on a made-up record, an SNN record and a
``mamba2-train`` record; the work count by hand."""

import ast
import contextlib
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench import harness, work_nemotron_h
from perfbench.entries import _lm

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "nemotron3-nano-train"
CFG = harness.cell_files(BENCH, CELL)[1]
RUN = _lm.as_run(CFG)
SMALL_CFG = {"hidden_size": 64, "num_hidden_layers": 7, "mamba_num_heads": 8,
             "mamba_head_dim": 16, "n_groups": 2, "ssm_state_size": 16,
             "chunk_size": 8, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 16,
             "experts_routed_over": 8, "n_routed_experts": 4,
             "num_experts_per_tok": 2, "moe_intermediate_size": 32,
             "moe_shared_expert_intermediate_size": 48, "vocab_size": 256,
             "A_init_range": [1, 8],
             "program": {"num_layers": 7, "d_model": 64, "ssm_num_heads": 8,
                         "ssm_head_dim": 16, "ssm_groups": 2,
                         "ssm_state": 16, "ssm_chunk": 8, "num_heads": 4,
                         "num_kv_heads": 2, "head_dim": 16,
                         "padded_num_heads": 4, "moe_num_experts": 8,
                         "moe_experts_held": 4, "moe_top_k": 2, "d_ff": 32,
                         "moe_shared_ff": 48, "vocab_size": 256,
                         "compute_dtype": "float32"}}
SMALL_TR = {"batch": 2, "seq_len": 32, "pool_batches": 4,
            "reference_rows": 1}
MOE_READERS = ["lm_moe_host_syncs_per_step", "lm_moe_host_ms_per_step"]
# the catalog's config of NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 (the
# model-configs guide's architectures.jsonl), number for number
CATALOG = {
    "attention_bias": False, "chunk_size": 128, "conv_kernel": 4,
    "expand": 2, "head_dim": 128, "hidden_size": 2688,
    "hybrid_override_pattern":
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    "intermediate_size": 1856, "layer_norm_epsilon": 1e-05,
    "mamba_head_dim": 64, "mamba_hidden_act": "silu",
    "mamba_num_heads": 64, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "mlp_bias": False,
    "mlp_hidden_act": "relu2", "model_type": "nemotron_h",
    "moe_intermediate_size": 1856,
    "moe_shared_expert_intermediate_size": 3712, "n_group": 1,
    "n_groups": 8, "n_routed_experts": 128, "n_shared_experts": 1,
    "norm_eps": 1e-05, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts_per_tok": 6, "num_hidden_layers": 52,
    "num_key_value_heads": 2, "num_logits_to_keep": 1,
    "partial_rotary_factor": 1, "rescale_prenorm_residual": True,
    "residual_in_fp32": False, "rope_theta": 10000,
    "routed_scaling_factor": 2.5, "sliding_window": None,
    "ssm_state_size": 128, "tie_word_embeddings": False,
    "time_step_floor": 0.0001, "time_step_max": 0.1, "time_step_min": 0.001,
    "topk_group": 1, "use_bias": False, "use_conv_bias": True,
    "use_mamba_kernels": True, "vocab_size": 131072}


def _run(*, control=False, config=None, trace=False, seconds=0.3):
    rec = harness.run_cell(ROOT, CELL, 2**31 + 91, seconds, trace, "cpu",
                           time.perf_counter(), control=control,
                           traffic=SMALL_TR,
                           config=dict(SMALL_CFG, **(config or {})))
    return rec, harness.result_line(ROOT, rec, False)


@pytest.fixture
def float32_attention(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_bf16", lambda x: x)


def test_sound_run_is_correct():
    rec, line = _run()
    assert line["correct"], line["checks"]
    assert line["attempted"] == rec["steps"] + 3
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert rec["counts"]["microbatches"] == 1      # the port's rule, 2 rows
    assert rec["tokens"] == rec["steps"] * 2 * 32
    assert "program" not in rec          # untraced: the recorder stays off


def test_float32_both_sides_agree(float32_attention):
    # without the attention's bf16 operands the program is float32 too
    _, line = _run()
    assert all(c["value"] <= 20 for k, c in line["checks"].items()
               if k.endswith("_ppm")), line["checks"]


def test_each_control_is_not_correct(float32_attention):
    rec, line = _run(control=True, config={"limits": dict.fromkeys(
        CFG["limits"], 100)})
    assert line["correct"], line["checks"]
    ctl = rec["control_checks"]
    for name in ("fp8", "no_d_skip", "half_batch"):
        mine = [c for k, c in ctl.items() if k.startswith(name + ".")]
        assert len(mine) == 5 and not all(c["ok"] for c in mine), name


def test_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.train import step
    monkeypatch.setattr(step, "streamed_update",
                        lambda opt, grads, opt_state, params, **kw:
                        (params, opt_state))
    _, line = _run()
    assert not line["correct"]
    assert line["checks"]["change_leaf_gap_ppm"]["value"] == 10**6
    # leaves under the median leaf's norm read their share of it
    med = line["checks"]["change_median_leaf_gap_ppm"]
    assert 900_000 < med["value"] <= 10**6 and med["value"] > med["limit"]


def _norms(n=9, first=1.0, change=1.0):
    fg = {f"w{i}": first * (1 + i / 10) for i in range(n)}
    return {"grad_norm": [10.0, 10.0, 10.0], "first_grad": fg,
            "change": {k: change * v for k, v in fg.items()}}


def test_worst_leaf_finds_one_leaf_the_median_finds_every_leaf():
    from perfbench.entries import lm_train_program as entry
    want = _norms()
    assert set(entry.compare(want, want, CFG["limits"])) == set(CFG["limits"])
    assert "loss_gap_ppm" not in CFG["limits"]
    one = _norms()
    one["change"]["w8"] = 0.0                 # one leaf's update left out
    got = {k: c["value"] for k, c in
           entry.compare(one, want, CFG["limits"]).items()}
    assert got["change_leaf_gap_ppm"] == 10**6
    assert got["change_median_leaf_gap_ppm"] == 0
    each = _norms(first=1.002, change=1.0005)  # every leaf moved a little
    checks = entry.compare(each, want, CFG["limits"])
    assert checks["first_grad_leaf_gap_ppm"]["ok"]
    assert checks["change_leaf_gap_ppm"]["ok"]
    assert not checks["first_grad_median_leaf_gap_ppm"]["ok"]
    assert not checks["change_median_leaf_gap_ppm"]["ok"]


def test_traced_run_records_the_program(monkeypatch):
    # the CPU has no CUDA activity to profile: the window unprofiled
    from perfbench.entries import lm_train
    monkeypatch.setattr(lm_train, "profiled",
                        lambda on: contextlib.nullcontext(None))
    rec, line = _run(trace=True)
    assert line["correct"], line["checks"]
    prog = rec["program"]
    steps = rec["steps"]
    assert prog["steps"] == steps > 0
    c = prog["counters"]
    # 3 E blocks a step, each run again by the remat recompute
    assert c["moe.host_syncs"] == 6 * steps and c["moe.dropped"] == 0
    assert c["moe.rows"] > 0 and c["moe.rows_max"] <= c["moe.rows"]
    for name in ("moe.route", "moe.dispatch", "moe.count_read",
                 "moe.experts", "moe.combine"):
        assert prog["totals"][name][1] == 6 * steps
    assert _reader("lm_moe_host_syncs_per_step")(rec) == 6.0
    assert _reader("lm_moe_host_ms_per_step")(rec) > 0


# ---- the configuration against the catalog and the program ----------------

def test_configuration_echoes_the_catalog_and_the_registry():
    from repro_torch.configs import get_config
    cut = {"num_hidden_layers": 14, "n_routed_experts": 32,
           "vocab_size": 32768}
    assert sorted(CFG["reduced"]) == sorted(cut)
    for key, value in CATALOG.items():
        assert CFG[key] == cut.get(key, value), key
    assert CFG["experts_routed_over"] == CATALOG["n_routed_experts"]
    assert CFG["vocab_size"] * 8 >= CATALOG["vocab_size"]    # an eighth
    arch = _lm.program_config(CFG)
    published = get_config(CFG["arch"])
    assert arch == dataclasses.replace(published, **CFG["program"])
    pairs = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "moe_intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "n_routed_experts": "moe_experts_held",
             "experts_routed_over": "moe_num_experts",
             "expert_offset": "moe_expert_offset",
             "num_experts_per_tok": "moe_top_k",
             "moe_shared_expert_intermediate_size": "moe_shared_ff",
             "routed_scaling_factor": "moe_routed_scale",
             "mamba_num_heads": "ssm_num_heads",
             "mamba_head_dim": "ssm_head_dim", "n_groups": "ssm_groups",
             "ssm_state_size": "ssm_state", "conv_kernel": "ssm_conv",
             "chunk_size": "ssm_chunk", "param_dtype": "param_dtype",
             "compute_dtype": "compute_dtype"}
    for key, field in pairs.items():
        assert CFG[key] == getattr(arch, field), key
    assert arch.layer_pattern == CFG["hybrid_override_pattern"]
    assert arch.d_inner == 4096 and arch.activation == "squared_relu"
    assert not arch.use_rope and arch.moe_router == "sigmoid"
    assert not arch.tie_embeddings and arch.padded_vocab == 32768
    # the departures only the program could undo, and no more
    assert set(CFG["assumed"]["as_run"]) == {"norm_eps",
                                             "layer_norm_epsilon",
                                             "use_conv_bias"}


def _meta_model(cfg):
    spec = _lm.reference(cfg).leaves(_lm.as_run(cfg))
    return _lm.program_model(
        _lm.program_config(cfg),
        {n: torch.empty(s, device="meta") for n, s, _ in spec}), spec


def test_reference_leaves_are_the_programs_parameters():
    model, spec = _meta_model(CFG)   # names and shapes checked on assignment
    assert sorted(n for n, _, _ in spec) == sorted(
        n for n, _ in model.named_parameters())
    # 6 M of 14 leaves, 6 E of 6, 2 * of 5, embed, head, final norm
    assert len(spec) == 6 * 14 + 6 * 6 + 2 * 5 + 3
    stored = sum(p.numel() for p in model.parameters())
    assert stored == work_nemotron_h.parameters(RUN) == 2_492_957_184
    assert stored == _lm.program_config(CFG).param_count()


# ---- the readers ----------------------------------------------------------

def _reader(name):
    return harness.load_module("metrics", name).read


def test_moe_readers_on_a_made_up_record():
    rec = {"tokens": 5 * 16384, "steps": 5, "window_s": 20.0,
           "program": {"steps": 4, "counters": {"moe.host_syncs": 48,
                                                "moe.dropped": 0},
                       "totals": {"moe.route": [0.02, 48],
                                  "moe.dispatch": [0.5, 48],
                                  "moe.count_read": [0.3, 48],
                                  "moe.experts": [0.1, 48],
                                  "moe.combine": [0.08, 48],
                                  "other": [9.0, 1]}}}
    assert _reader("lm_moe_host_syncs_per_step")(rec) == pytest.approx(12.0)
    assert _reader("lm_moe_host_ms_per_step")(rec) == pytest.approx(100.0)


@pytest.mark.parametrize("metric", MOE_READERS)
def test_moe_readers_find_nothing_elsewhere(metric):
    snn = {"entry": "batch", "launches": 10, "window_s": 0.2,
           "images": 100000, "work": {"ops": 2.3e13, "bytes": 1e9},
           "trace": {"window_s": 0.2, "busy_s": 0.16, "kernel_s": 0.15,
                     "copy_s": 0.01, "device_ops": [], "idle_gaps": []}}
    mamba = {"entry": "lm_train", "tokens": 10 * 16384, "steps": 10,
             "window_s": 20.0, "work": {"flops": 1e15, "bytes": 1e11},
             "trace": {"window_s": 20.0, "busy_s": 19.0, "kernel_s": 18.5,
                       "copy_s": 0.1, "gemm_s": 4.75, "device_ops": [],
                       "idle_gaps": []}}
    no_moe = dict(mamba, program={"steps": 10, "counters": {},
                                  "totals": {"other": [1.0, 3]}})
    for rec in (snn, mamba, no_moe):
        assert _reader(metric)(rec) is None


def test_cell_reports_the_rate_and_its_layers():
    assert [m["name"] for m in harness._metric_names(BENCH, CELL, False)] \
        == ["train_tokens_per_s", "setup_s"]
    assert sorted(m["name"] for m in harness._metric_names(BENCH, CELL,
                                                           True)) \
        == sorted(["lm_train_mfu", "lm_kernels_roofline", "lm_gemm_busy_pct",
                   "lm_device_idle_pct", *MOE_READERS])
    # mamba2-train reports none of the new readers
    assert not {m["name"] for m in harness._metric_names(
        BENCH, "mamba2-train", True)} & set(MOE_READERS)


def test_step_work_by_hand():
    d = 2688
    mamba = d * (2 * 4096 + 2 * 8 * 128 + 64) + 4096 * d
    attn = 2 * d * 32 * 128 + 2 * d * 2 * 128
    moe = d * 128 + 2 * d * 3712 + 6 * 32 / 128 * 2 * d * 1856
    mats = 6 * mamba + 2 * attn + 6 * moe + d * 32768
    assert work_nemotron_h.matrix_parameters(RUN) == pytest.approx(mats)
    assert mats == pytest.approx(578.7e6, rel=1e-4)
    # the SSD a chunk of 128: C·Bᵀ in 8 groups and its product with x,
    # the state and its read-out, the carry; 64 chunks an 8,192 row
    chunk = 128 * 129 * (8 * 128 + 4096) + 4 * 128 * 128 * 4096 \
        + 2 * 4096 * 128
    assert work_nemotron_h.ssd_flops(RUN, 8192) == 64 * chunk
    attn_f = 2 * 32 * 128 * 8192 * 8193
    assert work_nemotron_h.attn_flops(RUN, 8192) == attn_f
    wk = work_nemotron_h.step_work(RUN, 2, 8192)
    assert wk["flops"] == int(6 * mats * 16384
                              + 3 * 2 * (6 * 64 * chunk + 2 * attn_f))
    assert wk["flops"] == pytest.approx(6.43e13, rel=1e-3)
    assert wk["bytes"] == 36 * 2_492_957_184
    t, bound = work_nemotron_h.least_time(wk["flops"], wk["bytes"])
    assert bound == "flops" and t == pytest.approx(wk["flops"] / 989e12)
    assert math.isclose(t, 0.065, rel_tol=0.01)


@pytest.mark.parametrize("path", ["reference/nemotron_h.py",
                                  "work_nemotron_h.py",
                                  "metrics/lm_moe_host_syncs_per_step.py",
                                  "metrics/lm_moe_host_ms_per_step.py"])
def test_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse((harness.HERE / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", *harness.JAX_MODULES}, tops
