"""Multi-pod dry-run: run every (arch × shape × mesh) cell's real step on
``meta`` tensors and cost it (port of ``repro.launch.dryrun``).

For each live cell this builds the port's REAL step (``make_train_step``
with ``init_state``, the streamed optimizer update included, for train
shapes; ``make_prefill`` / ``make_decode_step`` on bf16 parameters for
serving shapes), runs it on ``meta`` stand-ins (``launch.specs``) under
``launch.op_cost``, and records one JSON per cell under ``--out`` with
the JAX dry-run's keys:

  * memory — per-device argument, output, alias, temp and peak bytes,
  * cost   — per-device flops and bytes,
  * collectives_per_device — by kind.

The port partitions nothing (``distributed.sharding.shard`` only checks
names), so the per-device figures are defined as follows:

  * the step runs at one data shard's batch, ``global_batch /
    data_ways``, where the data axes ("pod", "data") divide it (as
    ``to_shardings`` drops axes that do not divide),
  * ``argument_bytes`` is exact: every state and batch leaf's shard under
    the production rules (``distributed.partition.to_shardings``) on the
    mesh's axis sizes; ``output_bytes`` and ``alias_bytes`` follow the JAX
    dry-run's donation (the train state, the decode state),
  * ``temp_bytes``, ``flops_per_device`` and ``bytes_per_device`` are the
    data shard's meta-run figures divided evenly over the model axis; the
    record says so with ``"split": "even"``.  ``peak_bytes`` is JAX's sum
    (arguments + outputs + temporaries − aliased),
  * ``collectives_per_device`` keeps JAX's kinds, each null: the program
    the port runs on these meshes issues no collective until the model
    axis runs across processes; ``op_cost`` counts c10d ops once it does.

Each cell's op log is archived gzipped under ``--log-dir``, so
``launch.recost`` can recompute the cost fields without running anything.
Nothing touches a device: no allocation, no CUDA context.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys
import time

import torch
from torch import nn

from ..configs import SHAPES, cell_is_live, get_config, list_archs
from ..distributed.partition import (batch_specs, cache_specs, param_specs,
                                     to_shardings, train_state_specs)
from ..distributed.sharding import make_rules, use_rules
from ..serve.engine import ServeState, make_decode_step, make_prefill
from ..train.step import TrainSettings, init_state, make_train_step
from .mesh import make_production_mesh
from .op_cost import COLLECTIVES, OpCounter, _leaves, cost_log
from .specs import (abstract_params, decode_state_spec, num_microbatches,
                    prefill_inputs, train_inputs)

__all__ = ["build_cell", "run_cell", "shard_bytes", "main"]

_NO_COLLECTIVES = ("the port runs one process per step: no collective is "
                   "issued until the model axis runs across processes")


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
    cell: the step and its ``meta`` arguments at one data shard's batch,
    and the per-device bytes of its arguments, outputs and donated
    arguments under ``rules`` (outputs other than the donated state are
    added after the run).  ``arch`` and ``shape_name`` may also be an
    ``ArchConfig`` and a ``ShapeConfig``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    sizes = mesh.shape
    data_ways = _data_ways(mesh)
    local = shape.global_batch // data_ways \
        if shape.global_batch % data_ways == 0 else shape.global_batch
    lshape = dataclasses.replace(shape, global_batch=local)

    if shape.kind == "train":
        nm = num_microbatches(cfg, shape, data_ways)
        accum = "bfloat16" if cfg.param_count() > 150e9 else "float32"
        settings = TrainSettings(num_microbatches=nm, accum_dtype=accum,
                                 cast_params="bfloat16")
        state = init_state(None, cfg, settings,
                           lambda g: abstract_params(cfg), device="meta")
        glob = train_inputs(cfg, shape)
        st_b = shard_bytes(state, to_shardings(
            mesh, rules, train_state_specs(cfg, cfg.optimizer, state),
            state), sizes)
        b_b = shard_bytes(glob, to_shardings(mesh, rules, batch_specs(glob),
                                             glob), sizes)
        return (make_train_step(cfg, settings),
                (state, train_inputs(cfg, lshape)),
                {"batch_per_data_shard": local, "num_microbatches": nm},
                st_b + b_b, st_b, st_b)

    params = _bf16_params(abstract_params(cfg))
    p_b = shard_bytes(params, to_shardings(
        mesh, rules, param_specs(cfg, params), params), sizes)

    if shape.kind == "prefill":
        glob = prefill_inputs(cfg, shape)
        b_b = shard_bytes(glob, to_shardings(mesh, rules, batch_specs(glob),
                                             glob), sizes)
        return (make_prefill(cfg, max_len=shape.seq_len),
                (params, prefill_inputs(cfg, lshape)),
                {"batch_per_data_shard": local}, p_b + b_b, 0, 0)

    glob = decode_state_spec(cfg, shape)
    vec = ("batch",)
    st_specs = ServeState(cache=cache_specs(cfg, glob.cache, decode=True),
                          cur_len=vec, last_token=vec, done=vec)
    st_b = shard_bytes(glob, to_shardings(mesh, rules, st_specs, glob),
                       sizes)
    return (make_decode_step(cfg), (params, decode_state_spec(cfg, lshape)),
            {"batch_per_data_shard": local}, p_b + st_b, st_b, st_b)


def cost_fields(rec: dict, oc, ways: int) -> dict:
    """Write ``oc``'s cost fields into the record ``rec``, split evenly
    over ``ways`` model shards: flops, bytes, the data shard's eager
    peak, and the collectives (JAX's kinds, null until a collective
    runs)."""
    rec["cost"].update(flops_per_device=oc.flops / ways,
                       bytes_per_device=oc.bytes / ways,
                       peak_bytes_data_shard=oc.peak_bytes)
    rec["collectives_per_device"] = dict(
        {k: v / ways for k, v in oc.collectives.items()},
        total=oc.collective_total / ways) if oc.collective_total else \
        dict(dict.fromkeys(COLLECTIVES), total=None, note=_NO_COLLECTIVES)
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
    # logits; prefill: all of them), split evenly
    other_meta = _storage_bytes(out if kind == "prefill" else out[1:], set())
    out_b = donated_b + other_meta // model_ways
    oc = cost_log(ctr.log)
    temp = max(int(oc.peak_bytes) - inputs_meta - fresh_meta, 0) \
        // model_ways
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
        "split": "even", "data_ways": _data_ways(mesh),
        "model_ways": model_ways,
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
    return cost_fields(rec, oc, model_ways)


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
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else \
        [a for a in list_archs() if get_config(a).family != "snn"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            if not cell_is_live(arch, shape):
                print(f"SKIP  {arch} × {shape} (long-context n/a, DESIGN §7)")
                continue
            for mp in meshes:
                tag = f"{arch}.{shape}.{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"CACHED {tag}")
                    continue
                try:
                    rec = run_cell(arch, shape, mp, save_log=args.save_log,
                                   log_dir=args.log_dir)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    gb = rec["memory"]["peak_bytes"] / 2**30
                    print(f"OK    {tag}: peak {gb:.2f} GiB/dev, "
                          f"{rec['cost']['flops_per_device']:.3g} flops/dev, "
                          f"run {rec['run_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 — report & continue
                    failures.append((tag, repr(e)))
                    print(f"FAIL  {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e[:200])
        sys.exit(1)
    print("\nall requested cells ran")


if __name__ == "__main__":
    main()
