"""The port's SNN lane mesh as one process per rank: four ``gloo`` rank
subprocesses on the CPU, against the one-process port's engine on the
same mesh shape and the JAX package's single-device engine.

The ranks start once and run the 1×4, 2×2 and 4×1 meshes in turn
(``devices=["cpu"] * 4``: ``configs.snn_mnist.make_stream_engine`` builds
a process mesh under a group of four), at two stacks, (40, 32, 10) and
(40, 64, 64, 10), T=12, 40 images, chunks of 4.  Every comparison is
integer equality:

* ``RequestResult``s id for id against the one-process engine on the
  same mesh shape and against JAX's ``SNNStreamEngine``, speculation on
  and off, every rank returning the same dict;
* on 2×2 with the adaptive controller on, every chunk's telemetry
  record (the tile leaf data-outer, model-inner, the 10-wide head split
  5 + 5) and chunk length equal to the one-process 2×2 engine's;
* each rank's placed weight bytes are its own cell's: 1/M of each layer
  that splits, the whole of each layer that replicates;
* the exchange collectives a step: two per layer that splits and one
  for the tile rows;
* ``snapshot_lanes`` rows of the 2×2 ranks adopt into a one-process
  engine and finish with JAX's results;
* the fault harness, the tier and the tuner on a process mesh raise
  ``NotImplementedError``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.serve import SNNStreamEngine as JaxEngine
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.serve import (AdaptiveDispatchConfig, SNNStreamEngine,
                               lane_from_wire)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIZES = ((40, 32, 10), (40, 64, 64, 10))
MESHES = ((1, 4), (2, 2), (4, 1))
T, CHUNK, LANES, N_IMG, PATIENCE, SEED = 12, 4, 8, 40, 3, 3
ADAPTIVE = dict(adaptive=True, min_chunk_steps=2, max_chunk_steps=6,
                grow_patience=1)
SNAP_STEPS = 3        # chunks the 2x2 ranks run before their snapshot

COMMON = f"""
import dataclasses, json
import numpy as np

SIZES, MESHES = {SIZES!r}, {MESHES!r}
T, CHUNK, LANES, N_IMG, PATIENCE, SEED = {T}, {CHUNK}, {LANES}, {N_IMG}, \\
    {PATIENCE}, {SEED}
ADAPTIVE = {ADAPTIVE!r}
SNAP_STEPS = {SNAP_STEPS}


def case(sizes):
    rng = np.random.default_rng(len(sizes))
    p = {{"layers": [
        {{"w_q": np.clip(np.round(rng.normal(0.0, 120.0, (i, o))), -256,
                        255).astype(np.int16), "scale": np.float32(1 / 128)}}
        for i, o in zip(sizes[:-1], sizes[1:])]}}
    imgs = rng.integers(0, 256, (N_IMG, sizes[0]), dtype=np.uint8)
    return p, imgs


def results(res):
    return {{str(k): [r.pred, r.steps, r.adds, r.early_exit,
                     r.weight_version, np.asarray(r.spike_counts).tolist()]
            for k, r in sorted(res.items())}}


def drive(eng, imgs):
    # submissions paused after 20 images for three steps, so that
    # admission runs mid-stream; the chunk length first and after every
    # step
    lengths = [eng.chunk_steps]
    for i, im in enumerate(imgs):
        if i == 20:
            for _ in range(3):
                eng.step()
                lengths.append(eng.chunk_steps)
        eng.submit(im)
    while eng.pending:
        eng.step()
        lengths.append(eng.chunk_steps)
    return results(eng.run()), lengths
"""

RANK_CODE = COMMON + """
import sys
import torch, torch.distributed as dist
rank, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
import repro_torch.serve.snn_engine as se
from repro_torch.configs import snn_mnist as cfgs
from repro_torch.serve import (AdaptiveDispatchConfig, FaultInjector,
                               FaultPlan, lane_to_wire)
from repro_torch.tune import autotune_engine

calls = {"n": 0}
_gather = dist.all_gather


def counted(*a, **kw):
    calls["n"] += 1
    return _gather(*a, **kw)


dist.all_gather = counted
tels = []
_summarize = se.summarize_chunk


def record(tel, *a, **kw):
    tels.append([t.tolist() for t in tel])
    return _summarize(tel, *a, **kw)


se.summarize_chunk = record


def engine(p, cfg, nd, md, **kw):
    knobs = cfgs.SNNStreamMeshConfig(
        num_devices=nd, model_devices=md, lanes_per_device=LANES // nd,
        chunk_steps=CHUNK, overlap=kw.pop("overlap", True),
        adaptive=kw.pop("adaptive", None))
    return cfgs.make_stream_engine(p, cfg, knobs, devices=["cpu"] * 4,
                                   patience=PATIENCE, seed=SEED, **kw)


def weight_bytes(eng):
    return sum(t.numel() * t.element_size()
               for form in eng.bank.weights(eng.bank.current).values()
               for t in form)


out = {}
for sizes in SIZES:
    p, imgs = case(sizes)
    cfg = dataclasses.replace(cfgs.SNN_CONFIG, layer_sizes=sizes,
                              num_steps=T)
    for nd, md in MESHES:
        tag = f"{sizes}/{nd}x{md}"
        for backend in ("fused", "reference"):
            for overlap in (True, False):
                eng = engine(p, cfg, nd, md, backend=backend,
                             overlap=overlap)
                assert eng.mesh.torch_mesh is not None
                assert eng.lanes.px.shape[0] == LANES // nd
                per_chunk = []
                advance = eng._advance

                def counting(lanes, w, eng=eng, advance=advance):
                    n0 = calls["n"]
                    got = advance(lanes, w)
                    per_chunk.append((calls["n"] - n0,
                                      eng.controller.chunk_steps))
                    return got

                eng._advance = counting
                res, _ = drive(eng, imgs)
                out[f"{tag}/{backend}/{overlap}"] = res
                if overlap:
                    out[f"{tag}/{backend}/stats"] = eng.stats
                out[f"{tag}/{backend}/collectives"] = per_chunk
        out[f"{tag}/bytes"] = weight_bytes(eng)
        out[f"{tag}/ways"] = list(eng.model_ways)
    # 2x2 with the adaptive controller: the record every chunk
    tels.clear()
    eng = engine(p, cfg, 2, 2, backend="reference",
                 adaptive=AdaptiveDispatchConfig(**ADAPTIVE))
    res, lengths = drive(eng, imgs)
    out[f"{sizes}/adaptive"] = {"tels": list(tels), "lengths": lengths,
                                "results": res}
    # 2x2 ranks snapshot mid-stream
    eng = engine(p, cfg, 2, 2, backend="fused")
    for im in imgs:
        eng.submit(im)
    for _ in range(SNAP_STEPS):
        eng.step()
    rows = eng.snapshot_lanes()
    out[f"{sizes}/snapshot"] = {
        "rows": [[rid, lane_to_wire(row)] for rid, row in rows],
        "queue": [[rid, im.tolist()] for rid, im in eng.queue],
        "results": results(eng.results)}

# the layers that do not run over ranks yet
refused = []
p, imgs = case(SIZES[0])
cfg = dataclasses.replace(cfgs.SNN_CONFIG, layer_sizes=SIZES[0], num_steps=T)
for what, make in [
        ("injector", lambda: engine(p, cfg, 2, 2, injector=FaultInjector(
            FaultPlan.from_spec("seed=1,dispatch=0.1"), 0))),
        ("tier", lambda: cfgs.make_serving_tier(
            p, cfg, cfgs.SNNServingTierConfig(num_engines=1, sharded=True),
            devices=["cpu"] * 4)),
        ("tuner", lambda: autotune_engine(
            p, cfg, make_engine=lambda c, a: engine(p, cfg, 1, 4),
            device="cpu"))]:
    try:
        make()
    except NotImplementedError as e:
        refused.append([what, str(e)])
out["refused"] = refused

# nccl, with two ranks on one card or no card at all, raises before any
# collective (the group's backend read as nccl)
backend, raised = dist.get_backend, []
dist.get_backend = lambda *a: "nccl"
knobs = cfgs.SNNStreamMeshConfig(num_devices=1, model_devices=4)
for devices in (["cuda:0"] * 4, None):
    try:
        cfgs.make_stream_mesh(knobs, devices=devices)
    except (ValueError, RuntimeError) as e:
        raised.append([type(e).__name__, str(e)])
dist.get_backend = backend
out["nccl"] = raised
with open(f"{out_dir}/r{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ns = {}
exec(textwrap.dedent(COMMON), ns)
_case, _results, _drive = ns["case"], ns["results"], ns["drive"]


def _cfgs(sizes):
    return (dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=sizes,
                                num_steps=T),
            dataclasses.replace(jcfgs.SNN_CONFIG, layer_sizes=sizes,
                                num_steps=T))


def _one_process(p, cfg, nd, md, **kw):
    knobs = tcfgs.SNNStreamMeshConfig(
        num_devices=nd, model_devices=md, lanes_per_device=LANES // nd,
        chunk_steps=CHUNK, adaptive=kw.pop("adaptive", None))
    return tcfgs.make_stream_engine(p, cfg, knobs,
                                    devices=[torch.device("cpu")] * (nd * md),
                                    patience=PATIENCE, seed=SEED, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("snn_ranks")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULT_PLAN", None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_CODE), str(r), str(port),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        # the references run in this process meanwhile
        want = {}
        for sizes in SIZES:
            p, imgs = _case(sizes)
            tc, jc = _cfgs(sizes)
            jeng = JaxEngine({"layers": [
                {"w_q": jnp.asarray(l["w_q"]), "scale": jnp.float32(
                    l["scale"])} for l in p["layers"]]}, jc,
                batch_size=LANES, chunk_steps=CHUNK, patience=PATIENCE,
                seed=SEED)
            want[f"{sizes}/jax"] = _drive(jeng, imgs)[0]
            for nd, md in MESHES:
                eng = _one_process(p, tc, nd, md, backend="reference")
                assert eng.mesh.torch_mesh is None
                want[f"{sizes}/{nd}x{md}"] = _drive(eng, imgs)[0]
            import repro_torch.serve.snn_engine as se
            tels, summarize = [], se.summarize_chunk

            def record(tel, *a, **kw):
                tels.append([t.tolist() for t in tel])
                return summarize(tel, *a, **kw)

            se.summarize_chunk = record
            try:
                eng = _one_process(p, tc, 2, 2, backend="reference",
                                   adaptive=AdaptiveDispatchConfig(
                                       **ADAPTIVE))
                res, lengths = _drive(eng, imgs)
            finally:
                se.summarize_chunk = summarize
            want[f"{sizes}/adaptive"] = {"tels": tels, "lengths": lengths,
                                         "results": res}
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:          # a failed rank leaves the rest waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [json.loads((out / f"r{r}.json").read_text()) for r in range(4)]
    return got, want


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("nd,md", MESHES, ids=lambda m: str(m))
def test_ranks_serve_as_one_process_and_jax(ranks, sizes, nd, md):
    """Every rank, both backends, speculation on and off: the one-process
    engine's results on the same mesh shape, and JAX's."""
    got, want = ranks
    ref = want[f"{sizes}/{nd}x{md}"]
    assert ref == want[f"{sizes}/jax"]
    assert len(ref) == N_IMG
    for r in range(4):
        for backend in ("fused", "reference"):
            for overlap in (True, False):
                assert got[r][f"{sizes}/{nd}x{md}/{backend}/{overlap}"] == \
                    ref, (r, backend, overlap)
    stats = [g[f"{sizes}/{nd}x{md}/fused/stats"] for g in got]
    assert stats[0]["spec_used"] + stats[0]["spec_wasted"] > 0
    assert all(s == stats[0] for s in stats)


@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_ranks_adaptive_telemetry_chunk_for_chunk(ranks, sizes):
    """2×2, adaptive controller on: the record the controller reads and
    the chunk length after every step equal the one-process engine's."""
    got, want = ranks
    exp = want[f"{sizes}/adaptive"]
    assert len(exp["tels"]) > 3 and len(set(exp["lengths"])) > 1
    for r in range(4):
        run = got[r][f"{sizes}/adaptive"]
        assert run["lengths"] == exp["lengths"], r
        assert len(run["tels"]) == len(exp["tels"]), r
        for i, (g, e) in enumerate(zip(run["tels"], exp["tels"])):
            assert g == e, (r, i)
        assert run["results"] == exp["results"] == want[f"{sizes}/jax"]


def _padded(n):
    return n + (-n) % 128


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("nd,md", MESHES, ids=lambda m: str(m))
def test_each_rank_holds_its_own_weight_shards(ranks, sizes, nd, md):
    """A rank's placed bytes: on a model axis the packed planes of its
    column shard of each layer that splits and of the whole of each layer
    that replicates; without one the whole int16 codes."""
    got, _ = ranks
    ways = [md if n % md == 0 else 1 for n in sizes[1:]] if md > 1 else \
        [1] * (len(sizes) - 1)
    if md > 1:
        want = sum(2 * _padded(n // w) * _padded(k)
                   for k, n, w in zip(sizes[:-1], sizes[1:], ways))
    else:
        want = sum(2 * k * n for k, n in zip(sizes[:-1], sizes[1:]))
    for r in range(4):
        assert got[r][f"{sizes}/{nd}x{md}/ways"] == ways
        assert got[r][f"{sizes}/{nd}x{md}/bytes"] == want, r


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("nd,md", MESHES, ids=lambda m: str(m))
def test_exchange_collectives_per_step(ranks, sizes, nd, md):
    """Two collectives a step per layer that splits (membranes, spikes)
    and one for the tile rows; none without a model axis."""
    got, _ = ranks
    n_split = sum(n % md == 0 for n in sizes[1:]) if md > 1 else 0
    per_step = 2 * n_split + 1 if md > 1 else 0
    for r in range(4):
        for backend in ("fused", "reference"):
            chunks = got[r][f"{sizes}/{nd}x{md}/{backend}/collectives"]
            assert chunks
            assert all(n == per_step * steps for n, steps in chunks), \
                (r, backend, chunks)


@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_rank_snapshot_adopts_into_one_process(ranks, sizes):
    """The 2×2 ranks' ``snapshot_lanes`` rows (alike on every rank) and
    their unadmitted queue finish in a one-process engine with JAX's
    results."""
    got, want = ranks
    snap = got[0][f"{sizes}/snapshot"]
    assert all(g[f"{sizes}/snapshot"] == snap for g in got)
    assert snap["rows"] and snap["queue"]
    p, _ = _case(sizes)
    tc, _ = _cfgs(sizes)
    eng = SNNStreamEngine(p, tc, batch_size=LANES, chunk_steps=CHUNK,
                          patience=PATIENCE, seed=SEED, device="cpu")
    for rid, row in snap["rows"]:
        eng.adopt(rid, lane_from_wire(row))
    for rid, im in snap["queue"]:
        eng.submit(np.asarray(im, np.uint8), request_id=rid)
    res = dict(snap["results"], **_results(eng.run()))
    assert res == want[f"{sizes}/jax"]


def test_process_mesh_refuses_the_fault_harness_tier_and_tuner(ranks):
    got, _ = ranks
    for r in range(4):
        whats = [w for w, _ in got[r]["refused"]]
        assert whats == ["injector", "tier", "tuner"], got[r]["refused"]
        assert all("ROADMAP.md" in msg for _, msg in got[r]["refused"])


def test_nccl_refuses_two_ranks_on_one_card(ranks):
    """Under nccl a device list naming one card for several ranks, or a
    rank with no card of its own, raises: no switch of backend."""
    got, _ = ranks
    for r in range(4):
        (kind0, msg0), (kind1, msg1) = got[r]["nccl"]
        assert kind0 == "ValueError" and "nccl" in msg0
        assert kind1 == "RuntimeError" and "nccl" in msg1
