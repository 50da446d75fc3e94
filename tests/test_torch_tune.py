"""The port's autotuner and dispatch cache (``repro_torch.tune``) against the
JAX package's (``repro.tune``), on the CPU.

Every case of ``tests/test_autotune.py`` runs here on the port, and the
two packages meet where they share state: one config has one fingerprint
in both, a cache file the JAX tuner writes on the CPU arms the port's
engine with results equal to the JAX engine's, and an entry tuned at a
batch block the port's kernels do not run (``block_b=16``) is a miss that
names ``block_b``, never an error.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.tune as jtune
from repro.configs import snn_mnist as jcfgs
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.core import snn
from repro_torch.distributed.sharding import make_2d_device_mesh
from repro_torch.kernels import fused_snn
from repro_torch.serve import (AdaptiveDispatchConfig,
                               ShardedSNNStreamEngine, SNNStreamEngine,
                               TelemetryController)
from repro_torch.serve.router import SNNServingTier
from repro_torch.serve.telemetry import ChunkSummary, make_controller
from repro_torch.tune import (ArrivalSchedule, AutotuneConfig,
                              CacheDecision, DispatchCache,
                              DispatchCacheError, TunedShapes,
                              autotune_engine, cache_key,
                              config_fingerprint, decide_dispatch,
                              device_kind_now, fingerprint_payload, measure,
                              serve_schedule, write_cache)
from repro_torch.tune import timing as ttiming
from repro_torch.tune.cache import CACHE_CODEC_VERSION, ENV_DISPATCH_CACHE
from test_torch_tier_common import JAX, TORCH, small_net

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_env_cache(monkeypatch):
    # an env-armed cache must not reach the engines these tests compare
    monkeypatch.delenv(ENV_DISPATCH_CACHE, raising=False)


def _small_cfg(pkg=TORCH, **kw):
    kw.setdefault("layer_sizes", (16, 10))
    kw.setdefault("num_steps", 8)
    return dataclasses.replace(pkg.cfgs.SNN_CONFIG, **kw)


def _tuned(**kw):
    base = dict(chunk_steps=3, block_b=8, lanes_per_device=4,
                spike_density_threshold=0.2, backend="reference")
    base.update(kw)
    return TunedShapes(**base)


def _write(tmp_path, cfg, tuned=None, mesh_shapes=((1,),),
           name="cache.json", backend="auto", kind=CPU):
    """Persist a cache armed for ``cfg`` on the CPU; returns the path."""
    tuned = tuned or _tuned()
    cache = DispatchCache()
    fp = config_fingerprint(cfg)
    for mesh in mesh_shapes:
        cache.put(cache_key(fp, kind, mesh, backend), tuned)
    return cache.save(str(tmp_path / name))


def _engine(params_q, cfg, **kw):
    return SNNStreamEngine(params_q, cfg, device=CPU, **kw)


def _bits(results):
    return {int(rid): (int(r.pred), int(r.steps),
                       tuple(np.asarray(r.spike_counts).tolist()))
            for rid, r in results.items()}


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def test_fingerprint_stable_and_diverges():
    cfg = _small_cfg()
    assert config_fingerprint(cfg) == config_fingerprint(
        dataclasses.replace(cfg))
    for other in (dataclasses.replace(cfg, num_steps=9),
                  dataclasses.replace(cfg, layer_sizes=(16, 12, 10)),
                  dataclasses.replace(cfg, readout="first_spike"),
                  dataclasses.replace(cfg, spike_density_threshold=0.3)):
        assert config_fingerprint(other) != config_fingerprint(cfg)
    # the backend request is keyed separately, not fingerprinted
    assert config_fingerprint(dataclasses.replace(
        cfg, backend="reference")) == config_fingerprint(cfg)
    payload = fingerprint_payload(cfg)
    assert "qat" not in payload and "backend" not in payload
    assert payload["num_steps"] == 8


@pytest.mark.parametrize("name", ["SNN_CONFIG", "SNN_CONFIG_PRUNED",
                                  "SNN_CONFIG_DEEP", "SNN_CONFIG_WIDE"])
def test_fingerprint_equal_across_packages(name):
    """Every config of both ``configs/snn_mnist.py`` files, and a variant
    of each on every other fingerprinted field, hashes alike."""
    j, t = getattr(jcfgs, name), getattr(tcfgs, name)
    assert fingerprint_payload(t) == jtune.fingerprint_payload(j)
    assert config_fingerprint(t) == jtune.config_fingerprint(j)
    for kw in ({"sparse_skip": False}, {"spike_density_threshold": 0.1},
               {"dot_impl": "f32"}, {"fuse_encoder": True},
               {"emit_trace": False}, {"active_pruning": True}):
        assert config_fingerprint(dataclasses.replace(t, **kw)) == \
            jtune.config_fingerprint(dataclasses.replace(j, **kw)), kw


# ---------------------------------------------------------------------------
# cache codec: roundtrip + rejection ladder
# ---------------------------------------------------------------------------

def test_cache_roundtrip(tmp_path):
    cfg = _small_cfg()
    path = _write(tmp_path, cfg, mesh_shapes=((1,), (2, 1)))
    loaded = DispatchCache.load(path)
    d = loaded.lookup(fingerprint=config_fingerprint(cfg),
                      device_kind=device_kind_now(CPU), mesh_shape=(1,),
                      backend=None)       # None normalizes to "auto"
    assert d.hit and d.tuned == _tuned() and d.source == path
    miss = loaded.lookup(fingerprint=config_fingerprint(cfg),
                         device_kind=device_kind_now(CPU), mesh_shape=(4, 1),
                         backend="auto")
    assert not miss.hit and "static defaults" in miss.reason
    # the file is the JAX package's codec: it reads there too
    assert jtune.DispatchCache.load(path).to_json() == loaded.to_json()


def test_cache_rejects_corrupt_stale_future(tmp_path):
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{nope")
    with pytest.raises(DispatchCacheError, match="not valid JSON"):
        DispatchCache.load(str(corrupt))

    future = tmp_path / "future.json"
    future.write_text(json.dumps(
        {"codec_version": CACHE_CODEC_VERSION + 1, "entries": {}}))
    with pytest.raises(DispatchCacheError, match="newer build"):
        DispatchCache.load(str(future))

    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"codec_version": 0, "entries": {}}))
    with pytest.raises(DispatchCacheError, match="regenerate"):
        DispatchCache.load(str(stale))

    noversion = tmp_path / "nover.json"
    noversion.write_text(json.dumps({"entries": {}}))
    with pytest.raises(DispatchCacheError, match="codec_version"):
        DispatchCache.load(str(noversion))

    badentry = tmp_path / "badentry.json"
    badentry.write_text(json.dumps({
        "codec_version": CACHE_CODEC_VERSION,
        "entries": {"k": {"chunk_steps": 0, "block_b": 8,
                          "lanes_per_device": 4,
                          "spike_density_threshold": 0.2,
                          "backend": "reference"}}}))
    with pytest.raises(DispatchCacheError, match="chunk_steps"):
        DispatchCache.load(str(badentry))
    badblock = tmp_path / "badblock.json"
    badblock.write_text(json.dumps({
        "codec_version": CACHE_CODEC_VERSION,
        "entries": {"k": {"chunk_steps": 2, "block_b": 12,
                          "lanes_per_device": 4,
                          "spike_density_threshold": 0.2,
                          "backend": "reference"}}}))
    with pytest.raises(DispatchCacheError, match="multiple of"):
        DispatchCache.load(str(badblock))


def test_engine_falls_back_on_bad_cache_never_crashes(tmp_path, rng):
    """Every rejected-cache shape constructs a working engine on static
    defaults, with one UserWarning and the reason recorded."""
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    for blob in ("{nope",
                 json.dumps({"codec_version": CACHE_CODEC_VERSION + 1,
                             "entries": {}}),
                 json.dumps({"codec_version": 0, "entries": {}})):
        p = tmp_path / "bad.json"
        p.write_text(blob)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = _engine(params_q, cfg, patience=10_000, seed=0,
                          dispatch_cache=str(p))
        assert not eng.cache_decision.hit
        assert "static defaults" in eng.cache_decision.reason
        assert sum(issubclass(w.category, UserWarning) for w in caught) == 1
        eng.submit(np.full(cfg.n_in, 40, np.uint8))
        res = eng.run()
        assert res[0].steps == cfg.num_steps
    eng = _engine(params_q, cfg, patience=2, seed=0,
                  dispatch_cache=str(tmp_path / "absent.json"))
    assert not eng.cache_decision.hit


def test_no_fingerprint_cross_leak(tmp_path, rng):
    """Shapes tuned for one network never arm a different one."""
    cfg_a = _small_cfg()
    cfg_b = _small_cfg(num_steps=6)
    path = _write(tmp_path, cfg_a)
    eng = _engine(small_net(rng, cfg_b.layer_sizes), cfg_b, patience=2,
                  seed=0, dispatch_cache=path)
    assert not eng.cache_decision.hit
    assert config_fingerprint(cfg_b) in eng.cache_decision.key
    assert _engine(small_net(rng, cfg_a.layer_sizes), cfg_a, patience=2,
                   seed=0, dispatch_cache=path).cache_decision.hit


# ---------------------------------------------------------------------------
# env resolution through the engines and the tier
# ---------------------------------------------------------------------------

def test_env_resolution_single_sharded_tier(tmp_path, rng, monkeypatch):
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    n_dev = 2
    path = _write(tmp_path, cfg, mesh_shapes=((1,), (n_dev, 1)))
    monkeypatch.setenv(ENV_DISPATCH_CACHE, path)

    eng = _engine(params_q, cfg, patience=2, seed=0)
    assert eng.cache_decision.hit and eng.cache_decision.source == path
    assert eng.batch_size == _tuned().lanes_per_device
    assert eng.controller.chunk_steps == _tuned().chunk_steps
    assert eng.dispatch_threshold == \
        pytest.approx(_tuned().spike_density_threshold)

    mesh = make_2d_device_mesh(n_dev, 1, devices=[CPU] * n_dev)
    sh = ShardedSNNStreamEngine(params_q, cfg, mesh=mesh, patience=2,
                                seed=0)
    assert sh.cache_decision.hit
    assert f"mesh={n_dev}x1" in sh.cache_decision.key
    assert sh.batch_size == _tuned().lanes_per_device * n_dev
    assert sh.controller.chunk_steps == _tuned().chunk_steps

    tier = SNNServingTier(params_q, cfg, num_engines=2, device=CPU)
    assert len(tier.cache_decisions) == 2
    assert all(d.hit for d in tier.cache_decisions)

    monkeypatch.setenv(ENV_DISPATCH_CACHE, "")
    eng2 = _engine(params_q, cfg, patience=2, seed=0)
    assert not eng2.cache_decision.hit
    assert "no dispatch cache" in eng2.cache_decision.reason
    assert (eng2.batch_size, eng2.chunk_steps) == (8, 4)
    monkeypatch.setenv(ENV_DISPATCH_CACHE, path)
    eng3 = _engine(params_q, cfg, patience=2, seed=0, dispatch_cache=False)
    assert not eng3.cache_decision.hit
    assert "explicitly disabled" in eng3.cache_decision.reason


def test_mesh_and_tier_configs_thread_the_cache(tmp_path, rng):
    """``SNNStreamMeshConfig`` and ``SNNServingTierConfig`` carry the
    cache to their engines; the mesh knobs' chunk length defaults to None
    and resolves through it, else to 4."""
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    path = _write(tmp_path, cfg, mesh_shapes=((1,), (1, 1)))
    assert tcfgs.SNN_STREAM_MESH.chunk_steps is None
    eng = tcfgs.make_stream_engine(
        params_q, cfg, tcfgs.SNNStreamMeshConfig(dispatch_cache=path),
        devices=[CPU], patience=2, seed=0)
    assert eng.cache_decision.hit and eng.chunk_steps == 3
    assert eng.batch_size == _tuned().lanes_per_device
    plain = tcfgs.make_stream_engine(params_q, cfg, devices=[CPU],
                                     patience=2, seed=0)
    assert not plain.cache_decision.hit and plain.chunk_steps == 4
    tier = tcfgs.make_serving_tier(
        params_q, cfg, tcfgs.SNNServingTierConfig(dispatch_cache=path),
        device=CPU)
    assert [d.hit for d in tier.cache_decisions] == [True, True]


def test_explicit_args_beat_tuned_knob_by_knob(tmp_path, rng):
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    path = _write(tmp_path, cfg)
    eng = _engine(params_q, cfg, patience=2, seed=0, chunk_steps=5,
                  dispatch_cache=path)
    assert eng.cache_decision.hit
    assert eng.controller.chunk_steps == 5          # explicit wins
    assert eng.batch_size == _tuned().lanes_per_device  # tuned fills rest
    eng = _engine(params_q, cfg, patience=2, seed=0, batch_size=6,
                  dispatch_cache=path)
    assert eng.batch_size == 6
    assert eng.controller.chunk_steps == _tuned().chunk_steps


def test_cache_armed_engine_bit_identical(tmp_path, rng):
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    path = _write(tmp_path, cfg)
    sched = ArrivalSchedule(n_requests=10, per_round=3, seed=5)
    pixels = sched.pixels(cfg.n_in)
    plain = _engine(params_q, cfg, patience=2, seed=0, dispatch_cache=False)
    armed = _engine(params_q, cfg, patience=2, seed=0, dispatch_cache=path)
    assert armed.cache_decision.hit
    assert _bits(serve_schedule(plain, sched, pixels)) \
        == _bits(serve_schedule(armed, sched, pixels))


# ---------------------------------------------------------------------------
# block_b: the port's kernels run one block
# ---------------------------------------------------------------------------

def test_block_b_value_neutral_and_validated(rng):
    """The engine at the kernels' block serves what it serves unpinned,
    and the block check refuses every other value, naming ``block_b``
    and the fixed block."""
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    sched = ArrivalSchedule(n_requests=10, per_round=3, seed=5)
    pixels = sched.pixels(cfg.n_in)
    base = _engine(params_q, cfg, patience=2, seed=0, dispatch_cache=False)
    pinned = _engine(params_q, cfg, patience=2, seed=0, block_b=8,
                     dispatch_cache=False)
    assert _bits(serve_schedule(base, sched, pixels)) \
        == _bits(serve_schedule(pinned, sched, pixels))
    fused_snn.check_block_b(None)
    fused_snn.check_block_b(fused_snn.BLOCK_B)
    for bad in (4, 12, 16, 0):
        with pytest.raises(ValueError,
                           match=f"block_b.*{fused_snn.BLOCK_B}"):
            fused_snn.check_block_b(bad)


@pytest.mark.parametrize("bad", [4, 12, 16, 0])
def test_engine_refuses_other_blocks(rng, bad):
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    with pytest.raises(ValueError, match="block_b"):
        _engine(params_q, cfg, block_b=bad, dispatch_cache=False)
    with pytest.raises(ValueError, match="block_b"):
        ShardedSNNStreamEngine(
            params_q, cfg, mesh=make_2d_device_mesh(1, 1, devices=[CPU]),
            block_b=bad, dispatch_cache=False)


def test_block_b_8_equals_jax_block_16():
    """The port at its one block gives the JAX engine's results at
    ``block_b=16`` (the JAX results do not depend on the block)."""
    rng = np.random.default_rng(7)
    p = small_net(rng, (16, 10))
    sched = ArrivalSchedule(n_requests=6, per_round=2, seed=9)

    def serve(pkg, block_b):
        cfg = _small_cfg(pkg)
        eng = pkg.serve.SNNStreamEngine(
            pkg.params(p), cfg, batch_size=4, patience=2, seed=0,
            backend="fused", block_b=block_b, dispatch_cache=False,
            **pkg.kw)
        return _bits(serve_schedule(eng, sched, sched.pixels(cfg.n_in)))

    assert serve(TORCH, 8) == serve(JAX, 16)


def test_jax_block_16_entry_is_a_miss_naming_block_b(tmp_path, rng):
    """An entry the JAX tuner made at ``block_b=16`` reads (the codec is
    shared) but never arms the port: a miss naming block_b, defaults."""
    cfg = _small_cfg()
    cache = jtune.DispatchCache()
    cache.put(jtune.cache_key(jtune.config_fingerprint(_small_cfg(JAX)),
                              "cpu", (1,), "auto"),
              jtune.TunedShapes(chunk_steps=3, block_b=16,
                                lanes_per_device=4,
                                spike_density_threshold=0.2,
                                backend="reference"))
    path = cache.save(str(tmp_path / "jax16.json"))
    eng = _engine(small_net(rng, cfg.layer_sizes), cfg, patience=2,
                  seed=0, dispatch_cache=path)
    d = eng.cache_decision
    assert not d.hit and "block_b" in d.reason and d.tuned is None
    assert (eng.batch_size, eng.chunk_steps) == (8, 4)


# ---------------------------------------------------------------------------
# proportional controller shrink
# ---------------------------------------------------------------------------

def _summary(retired, active, chunk):
    return ChunkSummary(density_in=0.1, layer_densities=(0.1,),
                        executed_adds=0, tiles_skipped=0,
                        lanes_retired=retired, lanes_active=active,
                        active_lane_steps=active * chunk)


def test_proportional_shrink():
    cfg = AdaptiveDispatchConfig(adaptive=True, min_chunk_steps=2,
                                 max_chunk_steps=16,
                                 shrink_retire_frac=0.25)
    ctl = make_controller(cfg, spike_density_threshold=0.25,
                          chunk_steps=12, num_steps=20)
    ctl.observe(_summary(retired=2, active=8, chunk=12))
    assert ctl.chunk_steps == 11
    ctl.observe(_summary(retired=8, active=8, chunk=11))
    assert ctl.chunk_steps == 7
    ctl.observe(_summary(retired=4, active=8, chunk=7))
    assert ctl.chunk_steps == 5
    ctl.observe(_summary(retired=8, active=8, chunk=5))
    ctl.observe(_summary(retired=8, active=8, chunk=2))
    assert ctl.chunk_steps == cfg.min_chunk_steps == 2


def test_shrink_frozen_noop():
    ctl = make_controller(AdaptiveDispatchConfig(adaptive=False),
                          spike_density_threshold=0.25, chunk_steps=12,
                          num_steps=20)
    ctl.observe(_summary(retired=8, active=8, chunk=12))
    assert ctl.chunk_steps == 12 and ctl.history == []


def test_controller_from_cache():
    tuned = _tuned(chunk_steps=6, spike_density_threshold=0.11)
    ctl = TelemetryController.from_cache(tuned, num_steps=20)
    assert ctl.frozen
    assert ctl.chunk_steps == 6
    assert ctl.dispatch_threshold == pytest.approx(0.11)
    adaptive = TelemetryController.from_cache(
        tuned, cfg_adaptive=AdaptiveDispatchConfig(adaptive=True),
        num_steps=20)
    assert not adaptive.frozen and adaptive.chunk_steps == 6


# ---------------------------------------------------------------------------
# resolve_backend cache consult
# ---------------------------------------------------------------------------

def test_resolve_backend_consults_cache():
    cfg = _small_cfg()
    cache = DispatchCache()
    key = cache_key(config_fingerprint(cfg), "cpu", (1,), "auto")
    cache.put(key, _tuned(backend="staged"))
    kw = dict(layer_sizes=cfg.layer_sizes, device=CPU)
    # auto + hit: the cached staged backend is adopted directly
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cache,
                               **kw) == "staged"
    # a cached stack kernel off the card fails its gate → normal chain
    cache.put(key, _tuned(backend="fused"))
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cache,
                               **kw) == "reference"
    # explicit requests ignore the cache entirely
    cache.put(key, _tuned(backend="staged"))
    assert snn.resolve_backend(cfg, "reference", 1, dispatch_cache=cache,
                               **kw) == "reference"
    # no entry for another mesh shape → normal chain
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cache,
                               mesh_shape=(4, 1), **kw) == "reference"


def test_resolve_backend_cache_gate_on_a_card(monkeypatch):
    """Keyed by the card's name: a cached stack kernel is adopted where
    its shared-memory model holds the lanes, and a cached ``reference`` is
    never adopted on the card (plain PyTorch runs there only when named).
    The choice is host arithmetic; no card is touched."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cfg = _small_cfg()
    cache = DispatchCache()
    key = cache_key(config_fingerprint(cfg), "NVIDIA H100 80GB HBM3", (1,),
                    "auto")
    kw = dict(layer_sizes=cfg.layer_sizes, device="cuda")
    cache.put(key, _tuned(backend="fused_streamed", lanes_per_device=64))
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cache,
                               **kw) == "fused_streamed"
    cache.put(key, _tuned(backend="reference"))
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cache,
                               **kw) == "fused"
    # the CPU's entries never apply to the card
    cpu_only = DispatchCache({cache_key(config_fingerprint(cfg), "cpu", (1,),
                                        "auto"): _tuned(backend="staged")})
    assert snn.resolve_backend(cfg, "auto", 1, dispatch_cache=cpu_only,
                               **kw) == "fused"


def test_decide_dispatch_records_miss_reason():
    cfg = _small_cfg()
    d = decide_dispatch(None, cfg=cfg, backend=None, mesh_shape=(1,),
                        device=CPU)
    assert isinstance(d, CacheDecision)
    assert not d.hit and "no dispatch cache" in d.reason
    assert "|cpu|mesh=1|auto" in d.key


# ---------------------------------------------------------------------------
# timing harness
# ---------------------------------------------------------------------------

def test_measure_contract():
    calls = []
    rec = measure(lambda: calls.append(1), repeats=3, warmup=2)
    assert len(calls) == 5
    assert rec.repeats == 3 and rec.warmup == 2
    assert len(rec.samples_s) == 3
    assert rec.median_s == sorted(rec.samples_s)[1]
    assert rec.device_kind == device_kind_now(CPU) == "cpu"
    assert rec.interpret is False
    assert rec.to_json()["interpret"] is False
    assert rec.us == pytest.approx(rec.median_s * 1e6)
    with pytest.raises(ValueError):
        measure(lambda: None, repeats=0)


def test_measure_synchronizes_only_when_cuda_is_in_use(monkeypatch):
    """The host clock stops after ``torch.cuda.synchronize()`` once CUDA
    is initialised, and no synchronise is called while it is not."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert measure(lambda: None, repeats=2, warmup=1).device_kind == "cpu"
    assert syncs == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    rec = measure(lambda: None, repeats=2, warmup=1)
    assert len(syncs) == 3 and rec.device_kind == "NVIDIA H100 80GB HBM3"
    assert ttiming.device_kind_now("cuda") == "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# the tuner end to end (tiny grid)
# ---------------------------------------------------------------------------

TUNE_CFG = dict(chunk_steps_grid=(2, 4), block_b_grid=(8,), lanes_grid=(4,),
                threshold_grid=(0.1, 0.4), repeats=2, warmup=1,
                max_candidates=4)


def test_autotune_engine_and_write_cache(tmp_path, rng):
    cfg = _small_cfg()
    params_q = small_net(rng, cfg.layer_sizes)
    tc = AutotuneConfig(
        schedule=ArrivalSchedule(n_requests=6, per_round=2, seed=3),
        **TUNE_CFG)
    assert AutotuneConfig().block_b_grid == (8,)
    result = autotune_engine(params_q, cfg, tune_cfg=tc, patience=2,
                             seed=0, device=CPU)
    assert result.bit_identical
    assert result.records[0]["candidate"] == result.default.to_json()
    assert result.tuned.seconds_per_retired_request \
        <= result.baseline_spr * (1 + 1e-9)
    assert result.fingerprint == config_fingerprint(cfg)
    assert result.device_kind == "cpu" and result.tuned.block_b == 8
    path = str(tmp_path / "tuned.json")
    write_cache(result, path, mesh_shapes=((1,),))
    eng = _engine(params_q, cfg, patience=2, seed=0, dispatch_cache=path)
    assert eng.cache_decision.hit
    assert eng.controller.chunk_steps == result.tuned.chunk_steps


def test_jax_written_cache_arms_the_port(tmp_path):
    """The JAX tuner's cache file, written on the CPU, is a hit in the
    port's CPU engine, whose results equal the JAX engine's on it."""
    rng = np.random.default_rng(11)
    p = small_net(rng, (16, 10))
    sched = ArrivalSchedule(n_requests=6, per_round=2, seed=3)
    jres = jtune.autotune_engine(
        JAX.params(p), _small_cfg(JAX), patience=2, seed=0,
        tune_cfg=jtune.AutotuneConfig(schedule=jtune.ArrivalSchedule(
            n_requests=6, per_round=2, seed=3), **TUNE_CFG))
    path = str(tmp_path / "jax.json")
    jtune.write_cache(jres, path)
    runs = {}
    for pkg in (JAX, TORCH):
        cfg = _small_cfg(pkg)
        eng = pkg.serve.SNNStreamEngine(pkg.params(p), cfg, patience=2,
                                        seed=0, dispatch_cache=path,
                                        **pkg.kw)
        assert eng.cache_decision.hit, eng.cache_decision.reason
        assert (eng.batch_size, eng.chunk_steps) == (
            jres.tuned.lanes_per_device, jres.tuned.chunk_steps)
        runs[pkg.name] = {
            rid: (r.pred, r.steps, r.adds, r.early_exit,
                  np.asarray(r.spike_counts).tolist())
            for rid, r in serve_schedule(
                eng, sched, sched.pixels(cfg.n_in)).items()}
    assert runs["torch"] == runs["jax"]
