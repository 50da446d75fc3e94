"""The port's dry-run tooling (``launch.specs``, ``launch.mesh.
make_production_mesh``, ``launch.dryrun``, ``launch.recost``) against the
JAX package's, on the CPU.

* ``specs``: every leaf's shape and dtype equals JAX's
  ``ShapeDtypeStruct`` for every non-SNN arch × ``SHAPES`` cell at the
  published widths (the port's per-layer caches and parameters stacked
  as the JAX package stacks them); ``num_microbatches`` equals JAX's over
  every arch × shape × data ways in {1, 2, 16, 32, 256}.
* ``make_production_mesh``: shape and axis names equal JAX's, built in one
  subprocess on 512 forced host devices.
* Per-device ``argument_bytes`` of a train and a decode cell of two
  reduced archs (qwen3 with AdamW, jamba with Adafactor, MoE and Mamba
  caches) on a 2×4 mesh equal JAX's ``memory_analysis()
  .argument_size_in_bytes`` exactly (same subprocess).
* ``python -m repro_torch.launch.dryrun`` writes records with the JAX
  dry-run's keys, touching no device, and ``launch.recost`` reproduces
  their cost fields exactly from the archived op logs.
* The per-device figures of production cells (qwen3-4b train_4k and
  decode_32k on 16×16, llama3-8b prefill_32k, mamba2-1.3b prefill_32k and
  decode_32k), each counted as rank 0 of the placed program under a
  ``fake`` process group, against JAX's dry-run of the same cell (same
  subprocess): flops within ±5%; argument, output and alias bytes exact;
  collective bytes non-zero where the model axis is wider than one; peak
  within ±25% of JAX's peak less the f32 copies XLA:CPU makes of whole
  bf16 arguments before the step (the host-device compile runs bf16 dots
  in f32: every one of its ENTRY-level ``convert`` fusions of a parameter
  to f32, e.g. the stacked K/V cache's 2 × 1.51 GB in qwen3-4b's
  decode_32k, a copy the card's program does not make).  Each port cell
  runs in its own process, all at once.
"""

import dataclasses
import gzip
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as jcfg
from repro.launch import specs as jspecs
from repro_torch import configs as tcfg
from repro_torch.convert import _stack_named
from repro_torch.distributed.sharding import (make_device_mesh, make_rules,
                                              use_rules)
from repro_torch.launch import dryrun, recost
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.models.transformer import block_size, layer_plan

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [a for a in jcfg.list_archs() if a != "snn-mnist"]
ARG_ARCHS = ("qwen3-4b", "jamba-v0.1-52b")


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _jflat(tree) -> dict:
    """JAX leaves by dotted path: (shape, dtype name)."""
    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)
    return {".".join(key(k) for k in path): (tuple(l.shape), _dt(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tinputs(d: dict) -> dict:
    return {k: (tuple(v.shape), _dt(v.dtype)) for k, v in d.items()}


def _tcache(cache: list, cfg) -> dict:
    """The port's per-layer cache, stacked by block position as JAX keeps
    it: layer b·bs + j at index b of ``p{j}``."""
    bs = block_size(layer_plan(cfg))
    out = {}
    for j in range(bs):
        layers = cache[j::bs]
        for part, c in layers[0].items():
            for f in c._fields:
                leaf = getattr(c, f)
                assert all(getattr(e[part], f).device.type == "meta"
                           for e in layers)
                out[f"p{j}.{part}.{f}"] = ((len(layers), *leaf.shape),
                                           _dt(leaf.dtype))
    return out


# ---- specs -----------------------------------------------------------------

@pytest.mark.parametrize("shape", list(jcfg.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, shape):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    js, ts = jcfg.SHAPES[shape], tcfg.SHAPES[shape]
    assert dataclasses.astuple(js) == dataclasses.astuple(ts)
    if js.kind == "decode":
        want = _jflat(jspecs.decode_state_spec(jc, js))
        st = tspecs.decode_state_spec(tc, ts)
        got = {f"cache.{k}": v for k, v in _tcache(st.cache, tc).items()}
        for f in ("cur_len", "last_token", "done"):
            got[f] = (tuple(getattr(st, f).shape), _dt(getattr(st, f).dtype))
        # every cache leaf its own storage: the dry-run counts each
        leaves = [t for e in st.cache for c in e.values() for t in c]
        assert len({id(t.untyped_storage()) for t in leaves}) == len(leaves)
    else:
        fn = "train_inputs" if js.kind == "train" else "prefill_inputs"
        want = _jflat(getattr(jspecs, fn)(jc, js))
        got = _tinputs(getattr(tspecs, fn)(tc, ts))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    model = tspecs.abstract_params(tc)
    assert all(p.device.type == "meta" for p in model.parameters())
    tree = _stack_named(
        dict(model.named_parameters()), tc, lambda ts, stacked: (
            (len(ts), *ts[0].shape) if stacked else tuple(ts[0].shape),
            _dt(ts[0].dtype)))

    def flat(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    assert dict(flat(tree)) == _jflat(jspecs.abstract_params(jc))


@pytest.mark.parametrize("arch", ARCHS)
def test_num_microbatches_match_jax(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for shape in jcfg.SHAPES:
        for ways in (1, 2, 16, 32, 256):
            assert tspecs.num_microbatches(tc, tcfg.SHAPES[shape], ways) == \
                jspecs.num_microbatches(jc, jcfg.SHAPES[shape], ways), \
                (shape, ways)


# ---- production meshes and per-device argument bytes, against JAX ----------

JAX_CODE = """
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro import configs as jcfg
from repro.distributed.partition import (batch_specs, cache_specs,
    param_specs, to_shardings, train_state_specs)
from repro.distributed.sharding import make_device_mesh, make_rules, use_rules
from repro.launch.dryrun import _bf16_params
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (abstract_params, decode_state_spec,
    num_microbatches, train_inputs)
from repro.serve.engine import ServeState, make_decode_step
from repro.train.step import TrainSettings, init_state, make_train_step


out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["multi" if mp else "single"] = [list(m.devices.shape),
                                        list(m.axis_names)]
mesh = make_device_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
for arch in json.loads(sys.argv[2]):
    cfg = jcfg.get_reduced(arch)
    for kind in ("train", "decode"):
        shape = jcfg.ShapeConfig("t", 32, 8, kind)
        fsdp = kind == "train" or cfg.param_count() * 2 / 4 > 4e9
        rules = make_rules(mesh, fsdp=fsdp, sequence_parallel=kind == "train")
        with mesh, use_rules(rules):
            if kind == "train":
                s = TrainSettings(num_microbatches=num_microbatches(
                    cfg, shape, 2), accum_dtype="float32",
                    cast_params="bfloat16")
                st = jax.eval_shape(lambda k: init_state(k, cfg, s),
                                    jax.ShapeDtypeStruct((2,), jnp.uint32))
                b = train_inputs(cfg, shape)
                st_sh = to_shardings(mesh, rules, train_state_specs(
                    cfg, cfg.optimizer, st), st)
                b_sh = to_shardings(mesh, rules, batch_specs(b), b)
                fn = jax.jit(make_train_step(cfg, s,
                                             grad_shardings=st_sh.params),
                             in_shardings=(st_sh, b_sh),
                             out_shardings=(st_sh, None), donate_argnums=(0,))
                args = (st, b)
            else:
                p = _bf16_params(abstract_params(cfg))
                p_sh = to_shardings(mesh, rules, param_specs(cfg, p), p)
                st = decode_state_spec(cfg, shape)
                vec = ("batch",)
                st_sh = to_shardings(mesh, rules, ServeState(
                    cache=cache_specs(cfg, st.cache, decode=True),
                    cur_len=vec, last_token=vec, done=vec), st)
                fn = jax.jit(make_decode_step(cfg),
                             in_shardings=(p_sh, st_sh),
                             out_shardings=(st_sh, None), donate_argnums=(1,))
                args = (p, st)
            ma = fn.lower(*args).compile().memory_analysis()
            out[f"{arch}.{kind}"] = ma.argument_size_in_bytes
from repro.launch.dryrun import run_cell
for arch, shape in json.loads(sys.argv[3]):
    hlo = sys.argv[1] + f".{arch}.{shape}.hlo"
    rec = run_cell(arch, shape, False, save_hlo=hlo)
    text = open(hlo).read()
    sig = next(l for l in text.splitlines() if l.startswith("ENTRY"))
    rec["entry_outputs"] = len(re.findall(
        r"(?:bf16|f32|s32|u32|pred|s8|u8)\\[", sig.split("->")[1]))
    out[f"cell.{arch}.{shape}"] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


# production cells held against the JAX dry-run (F-aj)
CELLS = [("qwen3-4b", "train_4k"), ("qwen3-4b", "decode_32k"),
         ("llama3-8b", "prefill_32k"), ("mamba2-1.3b", "prefill_32k"),
         ("mamba2-1.3b", "decode_32k")]
FLOPS_BAND, PEAK_BAND = 0.05, 0.25

PORT_CELL = """
import json, sys, warnings
warnings.filterwarnings("ignore")
from repro_torch.launch.dryrun import run_cell
rec = run_cell(sys.argv[2], sys.argv[3], False)
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
"""


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    out = tmp / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PORT_CELL),
         str(tmp / f"port.{cell[0]}.{cell[1]}.json"), *cell], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell in CELLS}
    try:
        proc = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(JAX_CODE), str(out),
             json.dumps(ARG_ARCHS), json.dumps(CELLS)], env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        for p in procs.values():
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    got = json.loads(out.read_text())
    for arch, shape in CELLS:
        got[f"port.{arch}.{shape}"] = json.loads(
            (tmp / f"port.{arch}.{shape}.json").read_text())
        got[f"cell.{arch}.{shape}"]["f32_argument_copies"] = \
            dryrun.f32_argument_copies(
                (tmp / f"jax.json.{arch}.{shape}.hlo").read_text())
    return got


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_jax(jax_meshes, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape, axes = jax_meshes["multi" if multi_pod else "single"]
    assert list(mesh.devices.shape) == shape
    assert list(mesh.axis_names) == axes
    assert mesh_axis_sizes(mesh) == dict(zip(axes, shape))
    assert {d.type for d in mesh.devices.flat} == {"meta"}


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARG_ARCHS)
def test_argument_bytes_match_jax(jax_meshes, arch, kind):
    cfg = tcfg.get_reduced(arch)
    mesh = make_device_mesh((2, 4), ("data", "model"),
                            devices=[torch.device("meta")] * 8)
    fsdp = kind == "train" or cfg.param_count() * 2 / 4 > 4e9
    rules = make_rules(mesh, fsdp=fsdp, sequence_parallel=kind == "train")
    with use_rules(rules):
        _, args, extra, arg_b, _, _ = dryrun.build_cell(
            cfg, tcfg.ShapeConfig("t", 32, 8, kind), mesh, rules)
    assert arg_b == jax_meshes[f"{arch}.{kind}"]
    assert extra["batch_per_data_shard"] == 4


# ---- F-aj: rank 0 of the placed program against the JAX dry-run ------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_rank0_figures_match_jax_dryrun(jax_meshes, arch, shape):
    port = jax_meshes[f"port.{arch}.{shape}"]
    jax_rec = jax_meshes[f"cell.{arch}.{shape}"]
    pm, jm = port["memory"], jax_rec["memory"]
    for k in ("argument_bytes", "alias_bytes"):
        assert pm[k] == jm[k], k
    # XLA's output size adds its output tuple's index table (8 bytes a
    # leaf); the train step's "step" metric is a device scalar there and
    # a Python number here; prefill's fresh cur_len (int32) and done
    # (bool), constants, come out replicated there and batch-sharded here
    extra = {"train": 4, "decode": 0, "prefill": (4 + 1) * (
        port["batch_per_data_shard"] * (port["data_ways"] - 1))}
    assert jm["output_bytes"] - pm["output_bytes"] == \
        8 * jax_rec["entry_outputs"] + extra[tcfg.SHAPES[shape].kind]
    # each rank's argument bytes are its placed shards' (the train
    # state's two step counters count as int32 scalars)
    assert pm["argument_bytes"] == port["input_bytes_eager"] + (
        8 if shape.startswith("train") else 0)
    flops = port["cost"]["flops_per_device"] / \
        jax_rec["cost"]["flops_per_device"]
    assert abs(flops - 1) <= FLOPS_BAND, flops
    peak = pm["peak_bytes"] / (jm["peak_bytes"]
                               - jax_rec["f32_argument_copies"])
    assert abs(peak - 1) <= PEAK_BAND, peak
    assert port["model_ways"] == 16 and port["devices"] == 256
    coll = port["collectives_per_device"]
    assert coll["total"] > 0 and sum(coll["counts"].values()) > 0
    assert coll["total"] == sum(coll[k] for k in JAX_KINDS - {"total"})
    assert "split" not in port


# ---- the CLI and re-costing --------------------------------------------------

# the keys of ``repro.launch.dryrun.run_cell``'s record
JAX_KEYS = {"arch", "shape", "mesh", "devices", "lower_s", "compile_s",
            "memory", "cost", "collectives_per_device",
            "collectives_body_once"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_bytes"}
JAX_COST = {"xla_flops_per_device", "xla_bytes_per_device",
            "flops_per_device", "bytes_per_device"}
JAX_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "total"}


def test_dryrun_cli_records_and_recost(tmp_path, capsys):
    out, logs = tmp_path / "dryrun", tmp_path / "oplog"
    dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh",
                 "both", "--out", str(out), "--log-dir", str(logs)])
    assert "all requested cells ran" in capsys.readouterr().out
    assert not torch.cuda.is_initialized()
    recs = {}
    for mesh, devices in (("single", 256), ("multi", 512)):
        tag = f"qwen3-4b.decode_32k.{mesh}"
        rec = json.loads((out / f"{tag}.json").read_text())
        assert JAX_KEYS <= set(rec) and set(rec["memory"]) == JAX_MEMORY
        assert JAX_COST <= set(rec["cost"])
        coll = rec["collectives_per_device"]
        assert JAX_KINDS <= set(coll) and set(coll["counts"]) == \
            JAX_KINDS - {"total"}
        # rank 0's own collectives: the decode's q gather and its
        # flash-decoding all-reduces over the kv_seq-sharded cache
        assert coll["total"] > 0 and coll["counts"]["all-reduce"] > 0
        assert rec["devices"] == devices and "split" not in rec
        assert rec["model_ways"] == 16
        m = rec["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] \
            + m["temp_bytes"] - m["alias_bytes"]
        assert m["alias_bytes"] > 0 and m["argument_bytes"] > m["alias_bytes"]
        assert rec["cost"]["flops_per_device"] > 0
        with gzip.open(logs / f"{tag}.oplog.json.gz", "rt") as f:
            assert json.load(f)[0][0] == "<inputs>"
        recs[tag] = rec
    # the multi-pod mesh halves the batch each data shard serves
    assert recs["qwen3-4b.decode_32k.multi"]["batch_per_data_shard"] * 2 == \
        recs["qwen3-4b.decode_32k.single"]["batch_per_data_shard"]

    # recost from the logs alone: first with the cost fields spoiled
    again = tmp_path / "again"
    shutil.copytree(out, again)
    for p in again.glob("*.json"):
        rec = json.loads(p.read_text())
        rec["cost"]["flops_per_device"] = rec["cost"]["bytes_per_device"] = 0
        rec["cost"]["peak_bytes_eager"] = 0
        rec["collectives_per_device"] = None
        p.write_text(json.dumps(rec))
    recost.main(["--out", str(again), "--log", str(logs)])
    assert "2 cells recosted" in capsys.readouterr().out
    for tag, rec in recs.items():
        assert json.loads((again / f"{tag}.json").read_text()) == rec


def test_dryrun_cli_drops_stale_records_and_fails_on_unplaced_families(
        tmp_path, capsys):
    """A record of the even split is removed and its cell rerun; a family
    the placed path does not cover yet (whisper) writes no record, is
    listed, and the CLI exits 1."""
    out = tmp_path / "dryrun"
    out.mkdir()
    stale = out / "whisper-small.decode_32k.single.json"
    stale.write_text(json.dumps({"split": "even"}))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(out),
                     "--log-dir", str(tmp_path / "oplog")])
    text = capsys.readouterr().out
    assert e.value.code == 1
    assert "STALE whisper-small.decode_32k.single" in text
    assert "LATER whisper-small.decode_32k.single" in text
    assert "1 cells not run" in text
    assert "all requested cells ran" not in text
    assert not stale.exists()
