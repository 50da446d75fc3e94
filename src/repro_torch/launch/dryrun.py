"""Multi-pod dry-run: run every (arch × shape × mesh) cell's real step on
``meta`` tensors as rank 0 of the partitioned program, and cost it (port
of ``repro.launch.dryrun``).

For each live cell this starts PyTorch's ``fake`` process group at the
production mesh's world size (256 or 512) as rank 0, builds the
production ``DeviceMesh``, places the ``meta`` state, batch and cache on
it (``distributed.partition.place``: ``DTensor.from_local`` of each
rank's shard, so no global tensor is allocated), and runs the port's REAL
placed step (``make_train_step`` with ``init_state``, the streamed
optimizer update included, for train shapes; ``make_prefill`` /
``make_decode_step`` on bf16 parameters for serving shapes) under
``launch.op_cost``.  The counter sees the local ops at shard shapes and
the collectives DTensor and the model's regions issue, so every figure is
rank 0's own, as XLA's per-device figures are.  One JSON per cell under
``--out`` carries the JAX dry-run's keys:

  * memory — per-device argument, output, alias, temp and peak bytes
    (``argument_bytes`` every state and batch leaf's shard under the
    production rules, as JAX's; ``output_bytes`` and ``alias_bytes``
    follow the JAX dry-run's donation; ``peak_bytes`` is JAX's sum:
    arguments + outputs + temporaries − aliased),
  * cost   — per-device flops and eager bytes,
  * collectives_per_device — bytes by JAX's five kinds (its convention:
    max(result, operand), all-reduce × 2), their total and counts.

The group is destroyed before the next cell.  The counts are of the
port's program on ``meta``, not measurements.
Each cell's op log is archived gzipped under ``--log-dir``, so
``launch.recost`` can recompute the cost fields without running anything.
Nothing touches a device: no allocation, no CUDA context.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --compare-to results/dryrun --jax-hlo results/hlo
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import re
import sys
import time

import torch
import torch.distributed as dist
from torch import nn

from ..configs import SHAPES, cell_is_live, get_config, list_archs
from ..distributed.partition import (batch_specs, cache_specs, param_specs,
                                     place, to_shardings, train_state_specs)
from ..distributed.sharding import make_rules, use_rules
from ..serve.engine import ServeState, make_decode_step, make_prefill
from ..train.step import TrainSettings, init_state, make_train_step
from .mesh import make_production_mesh
from .op_cost import COLLECTIVES, OpCounter, _leaves, cost_log
from .specs import (abstract_params, decode_state_spec, num_microbatches,
                    prefill_inputs, train_inputs)

__all__ = ["build_cell", "run_cell", "shard_bytes", "fake_group", "compare",
           "f32_argument_copies", "main"]


@contextlib.contextmanager
def fake_group(world: int):
    """PyTorch's ``fake`` process group of ``world`` ranks, this process
    rank 0, for the body: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bf16_params(model: nn.Module) -> nn.Module:
    """The floating parameters cast to bf16 (on ``meta``: no data)."""
    return model.to(torch.bfloat16)


def _ways(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes.get(a, 1)
    return n


def shard_bytes(tree, specs, sizes: dict) -> int:
    """Per-device bytes of ``tree`` (tensors, modules, dicts, lists, named
    tuples; a Python int is an int32 scalar) under resolved mesh-axis
    ``specs`` (``to_shardings``' output) on mesh axes of ``sizes``."""
    if tree is None:
        return 0
    if isinstance(tree, int):
        return 4
    if isinstance(tree, torch.Tensor):
        n = tree.element_size()
        for d, e in zip(tree.shape, specs or (None,) * tree.dim()):
            n *= d // _ways(e, sizes)
        return n
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return sum(shard_bytes(v, specs[k], sizes) for k, v in tree.items())
    if hasattr(tree, "_fields"):
        return sum(shard_bytes(getattr(tree, f), getattr(specs, f), sizes)
                   for f in tree._fields)
    return sum(shard_bytes(v, s, sizes) for v, s in zip(tree, specs))


def _data_ways(mesh) -> int:
    return _ways(tuple(a for a in ("pod", "data") if a in mesh.axis_names),
                 mesh.shape)


def build_cell(arch: str, shape_name: str, mesh, rules):
    """``(step, args, extra, arg_bytes, out_bytes, alias_bytes)`` for the
    cell: the step and its ``meta`` arguments, and the per-device bytes of
    its arguments, outputs and donated arguments under ``rules`` (outputs
    other than the donated state are added after the run).  On a mesh
    with a process mesh the arguments are the global ones placed on it
    (each rank holds its shards); without one, the unplaced arguments at
    one data shard's batch.  ``arch`` and ``shape_name`` may also be an
    ``ArchConfig`` and a ``ShapeConfig``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    sizes = mesh.shape
    data_ways = _data_ways(mesh)
    local = shape.global_batch // data_ways \
        if shape.global_batch % data_ways == 0 else shape.global_batch
    placed = mesh.torch_mesh is not None
    lshape = shape if placed else \
        dataclasses.replace(shape, global_batch=local)

    def put(tree, specs):
        return place(tree, specs, mesh) if placed else tree

    if shape.kind == "train":
        nm = num_microbatches(cfg, shape, data_ways)
        accum = "bfloat16" if cfg.param_count() > 150e9 else "float32"
        settings = TrainSettings(num_microbatches=nm, accum_dtype=accum,
                                 cast_params="bfloat16")
        state = init_state(None, cfg, settings,
                           lambda g: abstract_params(cfg), device="meta")
        glob = train_inputs(cfg, shape)
        st_sh = to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, state), state)
        b_sh = to_shardings(mesh, rules, batch_specs(glob), glob)
        st_b = shard_bytes(state, st_sh, sizes)
        b_b = shard_bytes(glob, b_sh, sizes)
        return (make_train_step(cfg, settings),
                (put(state, st_sh), put(train_inputs(cfg, lshape), b_sh)),
                {"batch_per_data_shard": local, "num_microbatches": nm},
                st_b + b_b, st_b, st_b)

    params = _bf16_params(abstract_params(cfg))
    p_sh = to_shardings(mesh, rules, param_specs(cfg, params), params)
    p_b = shard_bytes(params, p_sh, sizes)
    params = put(params, p_sh)

    if shape.kind == "prefill":
        glob = prefill_inputs(cfg, shape)
        b_sh = to_shardings(mesh, rules, batch_specs(glob), glob)
        b_b = shard_bytes(glob, b_sh, sizes)
        return (make_prefill(cfg, max_len=shape.seq_len),
                (params, put(prefill_inputs(cfg, lshape), b_sh)),
                {"batch_per_data_shard": local}, p_b + b_b, 0, 0)

    glob = decode_state_spec(cfg, shape)
    vec = ("batch",)
    st_sh = to_shardings(mesh, rules, ServeState(
        cache=cache_specs(cfg, glob.cache, decode=True), cur_len=vec,
        last_token=vec, done=vec), glob)
    st_b = shard_bytes(glob, st_sh, sizes)
    return (make_decode_step(cfg),
            (params, put(decode_state_spec(cfg, lshape), st_sh)),
            {"batch_per_data_shard": local}, p_b + st_b, st_b, st_b)


def cost_fields(rec: dict, oc) -> dict:
    """Write ``oc``'s cost fields (rank 0's own) into the record ``rec``:
    flops, eager bytes and peak, and the collectives by JAX's five kinds
    with their total and counts."""
    rec["cost"].update(flops_per_device=oc.flops,
                       bytes_per_device=oc.bytes,
                       peak_bytes_eager=oc.peak_bytes)
    coll = {k: oc.collectives.get(k, 0.0) for k in COLLECTIVES}
    rec["collectives_per_device"] = dict(
        coll, total=sum(coll.values()),
        counts={k: oc.collective_counts.get(k, 0) for k in COLLECTIVES})
    return rec


def _storage_bytes(tree, skip: set) -> int:
    """Bytes of the distinct storages reachable from ``tree`` that are
    not in ``skip`` (storage ids)."""
    seen, n = set(skip), 0
    for t in _leaves(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             save_log: str | None = None, log_dir: str | None = None,
             sequence_parallel: bool | None = None) -> dict:
    with fake_group(512 if multi_pod else 256):
        return _run_cell(arch, shape_name, multi_pod, save_log=save_log,
                         log_dir=log_dir,
                         sequence_parallel=sequence_parallel)


def _run_cell(arch, shape_name, multi_pod, *, save_log, log_dir,
              sequence_parallel) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = SHAPES[shape_name].kind
    if sequence_parallel is None:
        sequence_parallel = kind == "train"
    # serving keeps params TP-sharded but replicated over data when the
    # bf16 copy fits (≤ 4 GB a device), as the JAX dry-run chooses
    fsdp = True
    if kind != "train":
        tp = mesh.shape.get("model", 1)
        fsdp = get_config(arch).param_count() * 2 / tp > 4e9
    rules = make_rules(mesh, fsdp=fsdp, sequence_parallel=sequence_parallel)
    model_ways = mesh.shape.get("model", 1)
    t0 = time.time()
    with use_rules(rules):
        step, args, extra, arg_b, donated_b, alias_b = build_cell(
            arch, shape_name, mesh, rules)
        ins = {id(t.untyped_storage()) for t in _leaves(args)}
        with OpCounter(*args) as ctr:
            out = step(*args)
    run_s = time.time() - t0
    inputs_meta = ctr.log[0][4]
    fresh_meta = _storage_bytes(out, ins)
    # outputs beside the donated state (train: the metrics; decode: the
    # logits; prefill: all of them)
    other_meta = _storage_bytes(out if kind == "prefill" else out[1:], set())
    out_b = donated_b + other_meta
    oc = cost_log(ctr.log)
    temp = max(int(oc.peak_bytes) - inputs_meta - fresh_meta, 0)
    tag = f"{arch}.{shape_name}.{'multi' if multi_pod else 'single'}"
    for path in (save_log,
                 log_dir and os.path.join(log_dir, tag + ".oplog.json.gz")):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with gzip.open(path, "wt") as f:
                json.dump(ctr.log, f)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "devices": mesh.size,
        "lower_s": None, "compile_s": None, "run_s": round(run_s, 1),
        "data_ways": _data_ways(mesh), "model_ways": model_ways,
        "rank": 0, "input_bytes_eager": inputs_meta,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp,
            "alias_bytes": alias_b,
            "peak_bytes": arg_b + out_b + temp - alias_b,
        },
        # no XLA program: the port has no raw XLA numbers
        "cost": {"xla_flops_per_device": None, "xla_bytes_per_device": None},
        "collectives_body_once": None,
        **extra,
    }
    return cost_fields(rec, oc)


def f32_argument_copies(hlo_text: str) -> int:
    """Bytes of the f32 copies of whole arguments in a compiled XLA
    program's text: its ENTRY computation's ``convert`` fusions of a
    parameter to f32.  XLA:CPU, which compiles the JAX dry-run on host
    devices, runs bf16 dots in f32 and hoists such copies of bf16 weights
    and caches out of the step; a program on the card makes none."""
    lines = hlo_text.splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("ENTRY"))
    total = 0
    for line in lines[at + 1:]:
        if line.startswith("}"):
            break
        m = re.match(r"\s*%\S*convert\S* = f32\[([0-9,]*)\]\S* "
                     r"fusion\(%param\.\d+\)", line)
        if m:
            n = 4
            for d in m.group(1).split(","):
                n *= int(d) if d else 1
            total += n
    return total


def compare(port_dir: str, jax_dir: str, hlo_dir: str | None = None) -> list:
    """Port/JAX ratios of every cell both directories hold (the port's
    records and ``repro.launch.dryrun``'s, read as JSON): flops, peak,
    temporaries and argument bytes a device, and the collective totals.
    With ``hlo_dir`` (the JAX dry-run's archived ``<cell>.hlo.gz``), also
    the peak against JAX's peak less :func:`f32_argument_copies`."""
    rows = []
    for name in sorted(os.listdir(port_dir)):
        jpath = os.path.join(jax_dir, name)
        if not name.endswith(".json") or not os.path.exists(jpath):
            continue
        with open(os.path.join(port_dir, name)) as f:
            t = json.load(f)
        with open(jpath) as f:
            j = json.load(f)

        def ratio(a, b):
            return a / b if b else None
        rows.append({
            "cell": name[:-5],
            "flops": ratio(t["cost"]["flops_per_device"],
                           j["cost"]["flops_per_device"]),
            "peak": ratio(t["memory"]["peak_bytes"],
                          j["memory"]["peak_bytes"]),
            "temp": ratio(t["memory"]["temp_bytes"],
                          j["memory"]["temp_bytes"]),
            "argument": ratio(t["memory"]["argument_bytes"],
                              j["memory"]["argument_bytes"]),
            "port_peak_gb": t["memory"]["peak_bytes"] / 1e9,
            "jax_peak_gb": j["memory"]["peak_bytes"] / 1e9,
            "port_collective_gb": t["collectives_per_device"]["total"] / 1e9,
            "jax_collective_gb": (j["collectives_per_device"] or {}).get(
                "total", 0) / 1e9})
        hpath = hlo_dir and os.path.join(hlo_dir, name[:-5] + ".hlo.gz")
        if hpath and os.path.exists(hpath):
            with gzip.open(hpath, "rt") as f:
                copies = f32_argument_copies(f.read())
            rows[-1].update(
                jax_f32_copies_gb=copies / 1e9,
                peak_less_copies=ratio(t["memory"]["peak_bytes"],
                                       j["memory"]["peak_bytes"] - copies))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--save-log", default=None,
                    help="write the op log (gzipped JSON) to this path")
    ap.add_argument("--log-dir", default="results/torch/oplog",
                    help="archive each cell's gzipped op log (enables "
                         "offline re-costing without running the step)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--compare-to", default=None,
                    help="print the port/JAX ratios against this directory "
                         "of the JAX dry-run's records and exit")
    ap.add_argument("--jax-hlo", default=None,
                    help="with --compare-to: the JAX dry-run's archived HLO "
                         "(its --hlo-dir), for the peak less XLA:CPU's f32 "
                         "argument copies")
    args = ap.parse_args(argv)
    if args.compare_to:
        for r in compare(args.out, args.compare_to, args.jax_hlo):
            print(json.dumps(r))
        return

    archs = [args.arch] if args.arch else \
        [a for a in list_archs() if get_config(a).family != "snn"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures, later = [], []
    for arch in archs:
        for shape in shapes:
            if not cell_is_live(arch, shape):
                print(f"SKIP  {arch} × {shape} (long-context n/a, DESIGN §7)")
                continue
            for mp in meshes:
                tag = f"{arch}.{shape}.{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        stale = "split" in json.load(f)
                    if not stale:
                        print(f"CACHED {tag}")
                        continue
                    # a record of the even split, before rank 0 was run
                    os.remove(path)
                    print(f"STALE {tag}: removed, rerun", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, save_log=args.save_log,
                                   log_dir=args.log_dir)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    gb = rec["memory"]["peak_bytes"] / 2**30
                    print(f"OK    {tag}: peak {gb:.2f} GiB/dev, "
                          f"{rec['cost']['flops_per_device']:.3g} flops/dev, "
                          f"run {rec['run_s']}s", flush=True)
                except NotImplementedError as e:
                    # a family the placed path does not cover yet
                    later.append(tag)
                    print(f"LATER {tag}: {e}", flush=True)
                except Exception as e:  # noqa: BLE001 — report & continue
                    failures.append((tag, repr(e)))
                    print(f"FAIL  {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e[:200])
    if later:
        print(f"\n{len(later)} cells not run, their families not placed "
              f"yet: {' '.join(later)}")
    if failures or later:
        sys.exit(1)
    print("\nall requested cells ran")


if __name__ == "__main__":
    main()
