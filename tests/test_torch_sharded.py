"""Parity of the port's (data × model) serving mesh with the JAX package's,
on the CPU.

The partial contraction (K3's plain version on CPU tensors) against the
JAX package's Pallas kernel in interpret mode; the model-sharded stack
step against the unsharded JAX step; ``ShardedSNNStreamEngine`` on 4×1,
1×4 and 2×2 meshes of CPU devices against the JAX single-device engine,
and against the JAX sharded engine on a forced-host 2×2 mesh chunk for
chunk.  Every comparison is integer equality.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.core import lif as jlif
from repro.core import snn as jsnn
from repro.core import telemetry as jtel
from repro.kernels import ops as jops
from repro.serve import SNNStreamEngine as JaxEngine
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.core import lif as tlif
from repro_torch.core import snn as tsnn
from repro_torch.distributed.sharding import (make_2d_device_mesh,
                                              make_device_mesh)
from repro_torch.kernels import fused_snn as tfused
from repro_torch.kernels import ops as tops
from repro_torch.serve import (AdaptiveDispatchConfig, ShardedSNNStreamEngine,
                               SNNStreamEngine, shard_weights)
from repro_torch.serve.telemetry import ChunkSummary

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")


def _codes(rng, sizes, mean=0.0, std=120.0):
    return {"layers": [
        {"w_q": np.clip(np.round(rng.normal(mean, std, (i, o))), -256, 255)
         .astype(np.int16), "scale": np.float32(1 / 128)}
        for i, o in zip(sizes[:-1], sizes[1:])]}


def _jax_params(p):
    return {"layers": [{"w_q": jnp.asarray(l["w_q"]),
                        "scale": jnp.float32(l["scale"])}
                       for l in p["layers"]]}


def _as_tuple(r):
    return (r.request_id, r.pred, r.steps, r.adds, r.early_exit,
            r.weight_version, np.asarray(r.spike_counts).tolist())


def _assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _as_tuple(got[rid]) == _as_tuple(want[rid]), rid


def _mesh_engine(p, cfg, nd, md, lpd, **kw):
    knobs = tcfgs.SNNStreamMeshConfig(
        num_devices=nd, model_devices=md, lanes_per_device=lpd,
        chunk_steps=kw.pop("chunk_steps", 3),
        overlap=kw.pop("overlap", True), adaptive=kw.pop("adaptive", None))
    return tcfgs.make_stream_engine(p, cfg, knobs, devices=[CPU] * (nd * md),
                                    **kw)


# ---- K3: the partial contraction ------------------------------------------

def _dead_tile_case(rng):
    """Live spikes everywhere, and block 0 (lanes 0-7) has no enabled
    neuron in output tile 1 (columns 128-255): the reference kernel skips
    those tile pairs and leaves their raw currents at 0."""
    x = rng.random((16, 300)) < 0.3
    en = rng.random((16, 260)) < 0.8
    en[:8, 128:256] = False
    return x, en


@pytest.mark.parametrize("sparse_skip", [True, False])
@pytest.mark.parametrize("case", [(4, 40, 24), (8, 200, 130), (3, 12, 6),
                                  "dead_en_tile"])
def test_partial_contraction_op_matches_jax(case, sparse_skip):
    rng = np.random.default_rng(5)
    if case == "dead_en_tile":
        x, en = _dead_tile_case(rng)
    else:
        B, n_in, n_out = case
        x = rng.random((B, n_in)) < 0.15
        en = rng.random((B, n_out)) < 0.8
    w = rng.integers(-256, 256, (x.shape[1], en.shape[1])).astype(np.int16)
    want_cur, want_skip = jops.partial_contraction_op(
        jnp.asarray(x), jnp.asarray(en), jnp.asarray(w),
        sparse_skip=sparse_skip, interpret=True)
    got_cur, got_skip = tops.partial_contraction_op(
        torch.from_numpy(x), torch.from_numpy(en), torch.from_numpy(w),
        sparse_skip=sparse_skip)
    np.testing.assert_array_equal(got_cur.numpy(), np.asarray(want_cur))
    np.testing.assert_array_equal(got_skip.numpy(), np.asarray(want_skip))
    assert got_cur.dtype == got_skip.dtype == torch.int32
    if case == "dead_en_tile":
        dense = x[:8].astype(np.int64) @ w[:, 128:256].astype(np.int64)
        dead = got_cur.numpy()[:8, 128:256]
        if sparse_skip:   # skipped, not the dense dot (the trap)
            assert (dead == 0).all() and (dense != 0).any()
        else:
            np.testing.assert_array_equal(dead, dense)


def test_partial_contraction_refuses_a_noncontiguous_shard():
    """A column slice of wider packed planes goes to the kernel as it is,
    and the wrapper refuses it instead of copying it per launch; unpadded
    int16 codes are padded and packed per call."""
    x = torch.zeros((8, 128), dtype=torch.bool)
    en = torch.ones((8, 128), dtype=torch.bool)
    wide = torch.zeros((128, 256), dtype=torch.int16)
    packed = tfused.pack_weights(wide)                  # (2, 256, 128)
    with pytest.raises(ValueError, match="contiguous"):
        tops.partial_contraction_op(x, en, packed[:, 128:])
    with pytest.raises(ValueError, match="fits neither"):
        tops.partial_contraction_op(x, en, wide[:100])
    with pytest.raises(ValueError, match="fits neither"):
        tops.partial_contraction_op(x, en, packed)
    cur, _ = tops.partial_contraction_op(x, en, wide[:, 128:].contiguous())
    assert cur.shape == (8, 128)
    cur, _ = tops.partial_contraction_op(x, en, packed[:, 128:].contiguous())
    assert cur.shape == (8, 128)


# ---- the model-sharded stack step ------------------------------------------

@pytest.mark.parametrize("contraction", ["kernel", "plain"])
@pytest.mark.parametrize("model_shards", [2, 4])
def test_sharded_step_matches_jax(model_shards, contraction):
    """One step of SNN_CONFIG_DEEP's widths (784→128→64→10) on a 2- or
    4-way model axis equals the JAX unsharded step; the 10-class head
    replicates on the 4-way axis.  The tile row of a sharded layer lists
    each peer's own skip counts (the JAX mirror on its column slice),
    model-inner; a replicated layer's is the unsharded count, per peer."""
    rng = np.random.default_rng(model_shards)
    cfg = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, active_pruning=True)
    sizes = cfg.layer_sizes
    ways = tfused.layer_shard_ways(sizes, model_shards)
    assert ways == ((4, 4, 1) if model_shards == 4 else (2, 2, 2))
    B = 12
    codes = [l["w_q"] for l in _codes(rng, sizes)["layers"]]
    px = rng.integers(0, 256, (B, sizes[0]), dtype=np.uint8)
    st0 = rng.integers(1, 2**32, (B, sizes[0]), dtype=np.uint32)
    vs = [rng.integers(-300, 200, (B, n)).astype(np.int32)
          for n in sizes[1:]]
    ens = [rng.random((B, n)) < 0.9 for n in sizes[1:]]
    j_states = tuple(jlif.LIFStateInt(v=jnp.asarray(v), enable=jnp.asarray(e))
                     for v, e in zip(vs, ens))
    j_w = tuple(jnp.asarray(w) for w in codes)
    j_out = jsnn.snn_int_stack_step(
        jnp.asarray(st0), jnp.asarray(px), j_states, j_w, cfg.lif,
        active_pruning=True)
    # each layer's input spikes: the fired vector of the stack cut before it
    x_in = [jnp.asarray(px) > jnp.asarray(
        (_xorshift(st0) >> 24).astype(np.uint8))]
    for l in range(1, len(codes)):
        x_in.append(jsnn.snn_int_stack_step(
            jnp.asarray(st0), jnp.asarray(px), j_states[:l], j_w[:l],
            cfg.lif, active_pruning=True)[2])

    grid = [[CPU] * model_shards]
    weights = shard_weights(codes, grid, ways)[0]
    t_states = tuple(tlif.LIFStateInt(v=torch.from_numpy(v),
                                      enable=torch.from_numpy(e))
                     for v, e in zip(vs, ens))
    st0_t = torch.from_numpy(st0.view(np.int32)).view(torch.uint32)
    rng_t, states, fired, adds, tel = tsnn.snn_int_stack_step_sharded(
        st0_t, torch.from_numpy(px), t_states, weights,
        tcfgs.SNN_CONFIG_DEEP.lif, model_shards=model_shards,
        active_pruning=True, contraction=contraction)

    j_rng, j_states2, j_fired, j_adds, j_tel = j_out
    np.testing.assert_array_equal(rng_t.view(torch.int32).numpy(),
                                  np.asarray(j_rng).view(np.int32))
    for a, b in zip(states, j_states2):
        np.testing.assert_array_equal(a.v.numpy(), np.asarray(b.v))
        np.testing.assert_array_equal(a.enable.numpy(), np.asarray(b.enable))
    np.testing.assert_array_equal(fired.numpy(), np.asarray(j_fired))
    np.testing.assert_array_equal(adds.numpy(), np.asarray(j_adds))
    for k in ("n_spk", "n_en"):
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(j_tel[k]))
    for l, w_ways in enumerate(ways):
        if w_ways == 1:
            want = np.tile(np.asarray(j_tel["tiles"][l]), model_shards)
        else:
            n_sh = sizes[l + 1] // w_ways
            want = np.concatenate([np.asarray(jtel.layer_tile_skips(
                x_in[l], jnp.asarray(ens[l][:, m * n_sh:(m + 1) * n_sh]),
                sparse_skip=True)) for m in range(w_ways)])
        np.testing.assert_array_equal(tel["tiles"][l].numpy(), want)


def _xorshift(s):
    s = s.astype(np.uint32)
    s ^= s << np.uint32(13)
    s ^= s >> np.uint32(17)
    s ^= s << np.uint32(5)
    return s


# ---- the engine ---------------------------------------------------------------

_CFG_SIZES = (24, 16, 10)


def _drive(eng, imgs, p_new, rollout_after=2):
    """Submit half, run a few chunks, roll out new weights, submit the
    rest, run to the end."""
    half = len(imgs) // 2
    for im in imgs[:half]:
        eng.submit(im)
    for _ in range(rollout_after):
        eng.step()
    eng.begin_rollout(p_new)
    for im in imgs[half:]:
        eng.submit(im)
    return eng.run()


@pytest.fixture(scope="module")
def engine_case():
    """20 images over 8 lanes at patience 1 (mid-chunk retirement,
    re-admission), a rollout after two chunks; the JAX single-device
    engine's results."""
    rng = np.random.default_rng(0)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG, layer_sizes=_CFG_SIZES,
                             num_steps=10)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=_CFG_SIZES,
                             num_steps=10)
    p_old, p_new = _codes(rng, _CFG_SIZES), _codes(rng, _CFG_SIZES, mean=8)
    imgs = rng.integers(0, 256, (20, _CFG_SIZES[0]), dtype=np.uint8)
    jeng = JaxEngine(_jax_params(p_old), jc, batch_size=8, chunk_steps=3,
                     patience=1, seed=11)
    want = _drive(jeng, imgs, _jax_params(p_new))
    assert sum(r.early_exit and r.steps % 3 for r in want.values()) > 0
    assert {r.weight_version for r in want.values()} == {0, 1}
    return tc, p_old, p_new, imgs, want


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("nd,md,lpd,ways", [(4, 1, 2, (1, 1)),
                                            (1, 4, 8, (4, 1)),
                                            (2, 2, 4, (2, 2))])
def test_mesh_engine_matches_jax(engine_case, nd, md, lpd, ways, backend):
    tc, p_old, p_new, imgs, want = engine_case
    k3 = tfused.partial_contraction.launches
    eng = _mesh_engine(p_old, tc, nd, md, lpd, patience=1, seed=11,
                       backend=backend)
    assert (eng.n_devices, eng.model_devices, eng.model_ways) == \
        (nd, md, ways)
    _assert_results_equal(_drive(eng, imgs, p_new), want)
    assert eng.stats["chunks"] > 0
    assert tfused.partial_contraction.launches == k3   # CPU: plain version


def test_failover_from_mesh_engine_matches_jax():
    """Rows snapshot from a 2×2 engine mid-window adopt into a single
    engine and finish equal to a JAX run that never moved."""
    rng = np.random.default_rng(4)
    sizes = (24, 16, 10)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG, layer_sizes=sizes,
                             num_steps=12)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=sizes,
                             num_steps=12)
    p = _codes(rng, sizes)
    imgs = rng.integers(0, 256, (8, 24), dtype=np.uint8)
    jeng = JaxEngine(_jax_params(p), jc, batch_size=8, chunk_steps=3,
                     patience=10_000, seed=9)
    for im in imgs:
        jeng.submit(im)
    want = jeng.run()

    src = _mesh_engine(p, tc, 2, 2, 4, patience=10_000, seed=9,
                       backend="fused")
    for im in imgs:
        src.submit(im)
    src.run(max_chunks=2)                 # mid-window: 6 of 12 steps done
    rows = src.snapshot_lanes()
    assert len(rows) == 8
    dst = SNNStreamEngine(p, tc, batch_size=8, chunk_steps=3,
                          patience=10_000, seed=9, device="cpu")
    for rid, row in rows:
        dst.adopt(rid, row)
    _assert_results_equal(dst.run(), want)


_JAX_2X2 = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.snn_mnist import (SNN_CONFIG, SNNStreamMeshConfig,
                                         make_stream_engine)
    from repro.serve.telemetry import AdaptiveDispatchConfig
    assert len(jax.devices()) == 4
    case = json.loads(sys.argv[1])
    cfg = dataclasses.replace(SNN_CONFIG, layer_sizes=tuple(case["sizes"]),
                              num_steps=case["T"])
    params = {"layers": [{"w_q": jnp.asarray(np.asarray(w, np.int16)),
                          "scale": jnp.float32(1 / 128)}
                         for w in case["codes"]]}
    knobs = SNNStreamMeshConfig(num_devices=2, model_devices=2,
                                lanes_per_device=4, chunk_steps=4,
                                adaptive=AdaptiveDispatchConfig(
                                    adaptive=True, min_chunk_steps=2,
                                    max_chunk_steps=6, grow_patience=1))
    eng = make_stream_engine(params, cfg, knobs, patience=3, seed=3,
                             backend="reference")
    tels = []
    observe = eng._observe

    def record(src, nxt, tel):
        tels.append([np.asarray(a).tolist() for a in tel])
        return observe(src, nxt, tel)

    eng._observe = record
    imgs = np.asarray(case["imgs"], np.uint8)
    loads, lengths = [], []
    for i, im in enumerate(imgs):
        if i == 20:
            for _ in range(3):
                eng.step()
                loads.append(list(eng.load_summary()))
                lengths.append(eng.chunk_steps)
        eng.submit(im)
    while eng.pending:
        eng.step()
        loads.append(list(eng.load_summary()))
        lengths.append(eng.chunk_steps)
    res = eng.run()
    print(json.dumps({"tels": tels, "loads": loads, "lengths": lengths,
                      "stats": eng.stats,
                      "results": {str(k): [r.pred, r.steps, r.adds,
                                           r.early_exit]
                                  for k, r in res.items()}}))
"""


def test_mesh_engine_matches_jax_sharded_engine_chunk_for_chunk():
    """The JAX sharded engine on a forced-host 2×2 mesh and the port's on
    a 2×2 mesh of CPU devices, adaptive controller on: the same telemetry
    record every chunk (the tile leaf data-outer / model-inner, the 10-wide
    head sharded 5 + 5), the same load summaries and chunk lengths."""
    rng = np.random.default_rng(21)
    sizes, T = (40, 32, 10), 12
    p = _codes(rng, sizes)
    imgs = rng.integers(0, 256, (40, sizes[0]), dtype=np.uint8)
    case = {"sizes": sizes, "T": T,
            "codes": [l["w_q"].tolist() for l in p["layers"]],
            "imgs": imgs.tolist()}
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_2X2),
                          json.dumps(case)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])

    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=sizes,
                              num_steps=T)
    eng = _mesh_engine(p, cfg, 2, 2, 4, chunk_steps=4, patience=3, seed=3,
                       backend="reference",
                       adaptive=AdaptiveDispatchConfig(
                           adaptive=True, min_chunk_steps=2,
                           max_chunk_steps=6, grow_patience=1))
    assert eng.model_ways == (2, 2)
    tels = []
    observe = eng._observe

    def record(src, nxt, tel):
        tels.append([a.tolist() for a in tel])
        return observe(src, nxt, tel)

    eng._observe = record
    loads, lengths = [], []
    for i, im in enumerate(imgs):
        if i == 20:
            for _ in range(3):
                eng.step()
                loads.append(list(eng.load_summary()))
                lengths.append(eng.chunk_steps)
        eng.submit(im)
    while eng.pending:
        eng.step()
        loads.append(list(eng.load_summary()))
        lengths.append(eng.chunk_steps)
    res = eng.run()

    assert len(tels) == len(want["tels"]) > 3
    for i, (got, exp) in enumerate(zip(tels, want["tels"])):
        assert got == exp, i
    assert len(set(lengths)) > 1 and lengths == want["lengths"]
    assert len(loads) == len(want["loads"])
    for got, exp in zip(loads, want["loads"]):
        assert got[:5] + got[6:] == exp[:5] + exp[6:]
        assert got[5] == pytest.approx(exp[5], rel=1e-12)
    assert eng.stats == want["stats"]
    assert {str(k): [r.pred, r.steps, r.adds, r.early_exit]
            for k, r in res.items()} == want["results"]


# ---- speculation --------------------------------------------------------------

def test_speculation_fires_and_changes_nothing():
    """Steady state (full tile, gate never fires): the speculative chunk
    k+1 is used, and overlap=False gives the same results."""
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=(16, 8),
                              num_steps=12)
    p = _codes(rng, cfg.layer_sizes)
    imgs = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    runs = {}
    for overlap in (True, False):
        eng = _mesh_engine(p, cfg, 2, 2, 4, chunk_steps=4, overlap=overlap,
                           patience=10_000, seed=5, backend="fused")
        for im in imgs:
            eng.submit(im)
        runs[overlap] = eng.run()
        if overlap:
            assert eng.stats["spec_used"] > 0, eng.stats
        else:
            assert eng.stats["spec_used"] == eng.stats["spec_wasted"] == 0
    _assert_results_equal(runs[True], runs[False])


def test_speculation_discarded_on_chunk_length_retune():
    """A speculative chunk dispatched at length L is discarded when the
    controller's chunk length moves before the commit, and the committed
    chunk runs at the new length."""
    rng = np.random.default_rng(2)
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=(16, 10),
                              num_steps=24)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG, layer_sizes=(16, 10),
                             num_steps=24)
    p = _codes(rng, cfg.layer_sizes)
    imgs = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    eng = _mesh_engine(p, cfg, 1, 2, 8, chunk_steps=4, patience=10_000,
                       seed=7, backend="reference",
                       adaptive=AdaptiveDispatchConfig(
                           adaptive=True, min_chunk_steps=2,
                           grow_patience=10_000))
    for im in imgs:
        eng.submit(im)
    eng.step()                       # commit chunk 1, speculate chunk 2
    assert eng._spec is not None and eng._spec_steps == 4
    eng.controller.observe(ChunkSummary(
        density_in=0.2, layer_densities=(0.2,), executed_adds=0,
        tiles_skipped=0, lanes_retired=8, lanes_active=8,
        active_lane_steps=32))
    assert eng.controller.chunk_steps == 2
    before = dict(eng.stats)
    steps_before = int(eng.lanes.steps.max())
    eng.step()
    assert eng.stats["spec_wasted"] == before["spec_wasted"] + 1
    assert eng.stats["spec_used"] == before["spec_used"]
    assert int(eng.lanes.steps.max()) == steps_before + 2
    res = eng.run()
    jeng = JaxEngine(_jax_params(p), jc, batch_size=8, chunk_steps=4,
                     patience=10_000, seed=7)
    for im in imgs:
        jeng.submit(im)
    _assert_results_equal(res, jeng.run())


# ---- plumbing -------------------------------------------------------------------

def test_make_2d_device_mesh_validation():
    pool = [CPU] * 4
    mesh = make_2d_device_mesh(4, 1, devices=pool)
    assert mesh.shape == {"data": 4, "model": 1}
    mesh = make_2d_device_mesh(1, 4, axis_names=("d", "m"), devices=pool)
    assert mesh.shape == {"d": 1, "m": 4}
    assert list(mesh.devices.flat) == pool
    mesh = make_2d_device_mesh(model_devices=2, devices=pool)
    assert mesh.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="distinct"):
        make_2d_device_mesh(1, 1, axis_names=("x", "x"), devices=pool)
    with pytest.raises(ValueError, match=">= 1"):
        make_2d_device_mesh(1, 0, devices=pool)
    with pytest.raises(ValueError, match=">= 1"):
        make_2d_device_mesh(0, 1, devices=pool)
    with pytest.raises(ValueError, match="devices"):
        make_2d_device_mesh(5, 1, devices=pool)
    with pytest.raises(ValueError, match="divide"):
        make_2d_device_mesh(model_devices=3, devices=pool)
    with pytest.raises(ValueError, match="length"):
        make_device_mesh((2, 2), ("data",), devices=pool)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_2d_device_mesh(1, 1)


def test_layer_shard_ways_matches_jax():
    from repro.kernels import fused_snn as jfused
    for sizes, m in (((784, 2048, 2048, 10), 4), ((784, 2048, 2048, 10), 1),
                     ((24, 16, 10), 2), ((24, 15, 10), 2), ((784, 10), 0),
                     ((784, 10), 2), ((784, 128, 64, 10), 4)):
        assert tfused.layer_shard_ways(sizes, m) == \
            jfused.layer_shard_ways(sizes, m)


def test_engine_rejects_bad_meshes():
    p = _codes(np.random.default_rng(0), (12, 6))
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=(12, 6))
    mesh = make_2d_device_mesh(2, 1, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="differ"):
        ShardedSNNStreamEngine(p, cfg, mesh=mesh, axis_name="data",
                               model_axis_name="data", backend="reference")
    with pytest.raises(ValueError, match="axis"):
        ShardedSNNStreamEngine(p, cfg, mesh=mesh, axis_name="lanes",
                               backend="reference")
    with pytest.raises(ValueError, match="divide"):
        ShardedSNNStreamEngine(p, cfg, mesh=mesh, batch_size=5,
                               backend="reference")
    with pytest.raises(ValueError, match="conflicting"):
        ShardedSNNStreamEngine(p, cfg, mesh=mesh, lanes_per_device=4,
                               batch_size=6, backend="reference")


def test_weight_shards_are_placed_once_as_their_own_tensors():
    """Each column shard is its own contiguous LANE-padded tensor of packed
    int8 planes (2, n_out_pad, n_in_pad) that unpack to its codes; a device
    the grid names twice holds each tensor once."""
    rng = np.random.default_rng(1)
    codes = [l["w_q"] for l in _codes(rng, (200, 256, 10))["layers"]]
    grid = [[CPU, CPU], [CPU, CPU]]
    placed = shard_weights(codes, grid, (2, 1))
    assert [len(layer) for layer in placed[0]] == [2, 1]
    for m, w in enumerate(placed[0][0]):
        assert w.is_contiguous() and w.dtype == torch.int8
        assert tuple(w.shape) == (2, 128, 256)
        codes_m = tfused.unpack_weights(w).numpy()
        np.testing.assert_array_equal(codes_m[:200],
                                      codes[0][:, m * 128:(m + 1) * 128])
        assert not codes_m[200:].any() and not w[:, :, 200:].any()
    head = placed[0][1][0]
    assert tuple(head.shape) == (2, 128, 256) and head.is_contiguous()
    np.testing.assert_array_equal(tfused.unpack_weights(head).numpy()[:, :10],
                                  codes[1])
    assert not head[:, 10:].any()
    assert placed[1][0][0] is placed[0][0][0]     # one tensor per device
    plain = shard_weights(codes, grid, None)
    assert tuple(plain[0][1].shape) == (256, 10)
    assert plain[0][1].dtype == torch.int16


def test_wide_resolves_fused_on_model_axis():
    """The counterpart of the JAX test of the same name: SNN_CONFIG_WIDE's
    per-lane state overflows the resident kernel's shared memory on one
    shard (366,512 B against 232,448 B) but each 4-way model shard's fits
    (104,688 B), and each 2-way shard's too (186,160 B), so on a card
    ``auto`` resolves ``fused`` there and ``fused_streamed`` on one shard;
    the 2-way shards of a stack twice as wide do not fit, and resolve
    ``fused_streamed``."""
    cfg = tcfgs.SNN_CONFIG_WIDE
    kw = dict(layer_sizes=cfg.layer_sizes, local_batch=256, device="cuda")
    assert tsnn.resolve_backend(cfg, "auto", 3, **kw) == "fused_streamed"
    assert tsnn.resolve_backend(cfg, "auto", 3, model_shards=4,
                                **kw) == "fused"
    assert tfused.stack_smem_bytes([784, 2048, 2048, 10]) == 366_512
    assert tfused.stack_smem_bytes([784, 512, 512, 10]) == 104_688
    assert tfused.stack_smem_bytes([784, 1024, 1024, 10]) == 186_160
    assert tfused.SMEM_LIMIT_BYTES == 232_448
    with pytest.raises(ValueError, match="shared-memory"):
        tsnn.resolve_backend(cfg, "fused", 3, **kw)
    assert tsnn.fused_unsupported_reason(cfg, 3, cfg.layer_sizes, 256,
                                         model_shards=2) is None
    assert tsnn.resolve_backend(cfg, "auto", 3, model_shards=2,
                                **kw) == "fused"
    wider = (784, 4096, 4096, 10)
    why = tsnn.fused_unsupported_reason(cfg, 3, wider, 256, model_shards=2)
    assert "2-way model axis" in why
    assert tsnn.resolve_backend(cfg, "auto", 3, model_shards=2,
                                **dict(kw, layer_sizes=wider)) == \
        "fused_streamed"
    assert tsnn.resolve_backend(cfg, "auto", 3, model_shards=4,
                                layer_sizes=cfg.layer_sizes,
                                device="cpu") == "reference"


def test_model_axis_serves_stacks_past_the_stack_kernels():
    """On a model axis every fused backend is the partial contraction,
    which holds no per-lane state in shared memory: a stack whose 2-way
    shards neither stack kernel holds (784→32768→10) is served, with the
    reference's results, where the single-device engine refuses it."""
    rng = np.random.default_rng(31)
    sizes = (784, 32768, 10)
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=sizes,
                              num_steps=6)
    assert tsnn.fused_unsupported_reason(cfg, 2, sizes, 8, streamed=True,
                                         model_shards=2) is not None
    p = _codes(rng, sizes, std=20.0)
    imgs = rng.integers(0, 256, (3, sizes[0]), dtype=np.uint8)
    with pytest.raises(ValueError, match="streamed working set"):
        SNNStreamEngine(p, cfg, batch_size=8, backend="fused_streamed",
                        device="cpu")
    runs = {}
    for backend in ("fused", "fused_streamed", "reference"):
        eng = _mesh_engine(p, cfg, 1, 2, 8, backend=backend)
        assert eng.backend == backend and eng.model_ways == (2, 2)
        for im in imgs:
            eng.submit(im)
        runs[backend] = eng.run()
    _assert_results_equal(runs["fused"], runs["reference"])
    _assert_results_equal(runs["fused_streamed"], runs["reference"])
