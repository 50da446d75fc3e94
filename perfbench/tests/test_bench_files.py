"""``BENCHMARK.json`` and the files it names: every piece is found by its
name, names and units keep to their characters, every per-layer metric's
cells report the end-to-end metric it moves, nothing under ``perfbench/``
imports JAX or the JAX package (the reference not even the port), and
``run.py`` refuses to run without a card."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w, cfg, traffic = harness.cell_files(BENCH, cell)
    assert cfg["name"] == w["config"]
    assert (harness.HERE / "entries" / f"{traffic['entry']}.py").exists()
    entry = harness.load_module("entries", traffic["entry"])
    assert callable(entry.run) and callable(entry.check)
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (harness.HERE / "metrics").glob("*.py")
    if not p.stem.startswith("_")))
def test_reader_finds_nothing_in_an_empty_record(metric):
    assert harness.load_module("metrics", metric).read(
        {"entry": None, "sizes": [784, 10]}) is None


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.fullmatch(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]


def test_each_cell_reports_setup_a_rate_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in harness._metric_names(BENCH, cell, False)}
        layer = harness._metric_names(BENCH, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert layer, cell


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        if "workloads" not in m:
            # reported wherever what it moves is: that has no list either
            assert "workloads" not in moved, m["name"]
        for cell in m.get("workloads", ()):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (
                m["name"], cell)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.JAX_MODULES), path
    if "reference" in path.parts:
        assert "repro_torch" not in tops, path


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_jax_names_are_compared_whole():
    before = set(sys.modules)
    sys.modules["repro_torch_lookalike"] = sys.modules["json"]
    sys.modules["jaxtyping_lookalike"] = sys.modules["json"]
    try:
        assert harness.jax_loaded() == sorted(
            m for m in before if m.split(".")[0] in harness.JAX_MODULES)
        sys.modules["repro.core"] = sys.modules["json"]
        assert "repro.core" in harness.jax_loaded()
    finally:
        for m in ("repro_torch_lookalike", "jaxtyping_lookalike",
                  "repro.core"):
            sys.modules.pop(m, None)
