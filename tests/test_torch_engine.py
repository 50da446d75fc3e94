"""Parity of the port's streaming engine with the JAX package's, on the CPU.

The same seeded images, engine seed and weight codes (handed over with
``params_from_jax``) go through ``repro.serve.SNNStreamEngine`` and
``repro_torch.serve.SNNStreamEngine(device="cpu")``; every
``RequestResult`` must be equal, id for id.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.serve import SNNStreamEngine as JaxEngine
from repro.serve.telemetry import AdaptiveDispatchConfig as JaxAdaptive
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import fused_snn as tfused
from repro_torch.serve import AdaptiveDispatchConfig, SNNStreamEngine


def _codes(rng, sizes, mean=6.0):
    return {"layers": [
        {"w_q": np.clip(np.round(rng.normal(mean, 40, (i, o))), -256, 255)
         .astype(np.int16), "scale": np.float32(1 / 128)}
        for i, o in zip(sizes[:-1], sizes[1:])]}


def _jax_params(p):
    return {"layers": [{"w_q": jnp.asarray(l["w_q"]),
                        "scale": jnp.float32(l["scale"])}
                       for l in p["layers"]]}


def _images(rng, n, n_in):
    px = rng.integers(0, 256, (n, n_in), dtype=np.uint8)
    px[:, : n_in // 3] = 0
    return px


def _assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        g, w = got[rid], want[rid]
        assert g.request_id == w.request_id == rid
        for f in ("pred", "steps", "adds", "early_exit", "weight_version"):
            assert getattr(g, f) == getattr(w, f), (rid, f)
        np.testing.assert_array_equal(g.spike_counts,
                                      np.asarray(w.spike_counts),
                                      err_msg=str(rid))


def _drive(eng, imgs, p_new=None, rollout_after=2):
    """Submit half, run a few chunks, optionally roll out new weights,
    submit the rest, run to the end."""
    half = len(imgs) // 2
    for im in imgs[:half]:
        eng.submit(im)
    for _ in range(rollout_after):
        eng.step()
    if p_new is not None:
        eng.begin_rollout(p_new)
    for im in imgs[half:]:
        eng.submit(im)
    return eng.run()


@pytest.mark.parametrize("name,adaptive", [
    ("SNN_CONFIG", False), ("SNN_CONFIG", True),
    ("SNN_CONFIG_PRUNED", False), ("SNN_CONFIG_DEEP", True),
])
def test_engine_matches_jax(name, adaptive):
    rng = np.random.default_rng(len(name) + adaptive)
    jc, tc = getattr(jcfgs, name), getattr(tcfgs, name)
    p = _codes(rng, jc.layer_sizes)
    imgs = _images(rng, 14, jc.n_in)
    kw = dict(batch_size=4, chunk_steps=4, patience=2, seed=5)
    jeng = JaxEngine(_jax_params(p), jc, adaptive=JaxAdaptive(
        adaptive=adaptive), **kw)
    teng = SNNStreamEngine(params_from_jax(p, device="cpu"), tc,
                           adaptive=AdaptiveDispatchConfig(
                               adaptive=adaptive), device="cpu", **kw)
    assert teng.backend == "reference"
    _assert_results_equal(_drive(teng, imgs), _drive(jeng, imgs))
    assert teng.chunk_steps == jeng.chunk_steps
    if adaptive:
        assert teng.controller.density_ewma == pytest.approx(
            jeng.controller.density_ewma, rel=1e-12)
    assert any(r.early_exit for r in teng.results.values())
    assert teng.load_summary() == jeng.load_summary()


@pytest.mark.parametrize("adaptive", [False, True])
def test_engine_rollout_matches_jax(adaptive):
    rng = np.random.default_rng(12)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG, readout="membrane")
    tc = dataclasses.replace(tcfgs.SNN_CONFIG, readout="membrane")
    p_old = _codes(rng, jc.layer_sizes)
    p_new = _codes(rng, jc.layer_sizes, mean=-2.0)
    imgs = _images(rng, 16, jc.n_in)
    kw = dict(batch_size=6, chunk_steps=3, patience=3, seed=11)
    jeng = JaxEngine(_jax_params(p_old), jc,
                     adaptive=JaxAdaptive(adaptive=adaptive), **kw)
    teng = SNNStreamEngine(params_from_jax(p_old, device="cpu"), tc,
                           adaptive=AdaptiveDispatchConfig(
                               adaptive=adaptive), device="cpu", **kw)
    want = _drive(jeng, imgs, _jax_params(p_new))
    got = _drive(teng, imgs, params_from_jax(p_new, device="cpu"))
    _assert_results_equal(got, want)
    assert {r.weight_version for r in got.values()} == {0, 1}
    assert [e.kind for e in teng.bank.history] == \
        [e.kind for e in jeng.bank.history]


@pytest.mark.parametrize("name", ["SNN_CONFIG", "SNN_CONFIG_PRUNED",
                                  "SNN_CONFIG_DEEP"])
def test_fused_chunks_on_cpu_equal_reference(name):
    """The engine's fused chunk (gated stack op, plain version on the CPU)
    serves the same results as its reference chunk."""
    rng = np.random.default_rng(3)
    cfg = getattr(tcfgs, name)
    p = params_from_jax(_codes(rng, cfg.layer_sizes), device="cpu")
    imgs = _images(rng, 11, cfg.n_in)
    res = {}
    for b in ("reference", "fused"):
        eng = SNNStreamEngine(p, cfg, batch_size=5, chunk_steps=4,
                              patience=2, seed=2, backend=b, device="cpu")
        before = tfused.fused_snn_stack.launches
        for im in imgs:
            eng.submit(im)
        res[b] = eng.run()
        assert tfused.fused_snn_stack.launches == before
        assert eng.dispatches > 0
    _assert_results_equal(res["fused"], res["reference"])


def test_snapshot_adopt_resumes_exactly():
    """Lanes evacuated mid-window from one engine and adopted by another
    finish with the results of an uninterrupted engine."""
    rng = np.random.default_rng(9)
    cfg = tcfgs.SNN_CONFIG_PRUNED
    p = params_from_jax(_codes(rng, cfg.layer_sizes), device="cpu")
    imgs = _images(rng, 6, cfg.n_in)
    kw = dict(batch_size=4, chunk_steps=3, patience=50, seed=1,
              device="cpu")
    ref = SNNStreamEngine(p, cfg, **kw)
    for im in imgs:
        ref.submit(im)
    want = ref.run()

    a, b = SNNStreamEngine(p, cfg, **kw), SNNStreamEngine(p, cfg, **kw)
    for im in imgs:
        a.submit(im)
    a.step()
    a.step()
    ckpt = a.checkpoint_lanes()
    rows = a.snapshot_lanes()
    assert [r for r, _ in ckpt] == [r for r, _ in rows] and rows
    for rid, row in rows:
        b.adopt(rid, row)
    with pytest.raises(ValueError):
        b.adopt(rows[0][0], rows[0][1])
    for rid, im in a.queue:
        b.submit(im, request_id=rid)
    got = dict(a.results)
    got.update(b.run())
    _assert_results_equal(got, {k: v for k, v in want.items()})


def test_engine_needs_a_device_choice():
    cfg = tcfgs.SNN_CONFIG
    p = {"layers": [{"w_q": np.zeros((784, 10), np.int16), "scale": 1.0}]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SNNStreamEngine(p, cfg)
    with pytest.raises(ValueError):
        SNNStreamEngine(p, dataclasses.replace(cfg, readout="mean"),
                        device="cpu")
    eng = SNNStreamEngine(p, cfg, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        eng.begin_rollout({"layers": [{"w_q": np.zeros((784, 9), np.int16)}]})
    bad = {"layers": [{"w_q": np.full((784, 10), 300, np.int16)}]}
    with pytest.raises(ValueError, match="9-bit"):
        SNNStreamEngine(bad, cfg, backend="fused", device="cpu")


def test_weight_bank_matches_jax():
    """The version store walks the same state machine in both packages."""
    from repro.serve.rollout import RolloutInProgressError as JaxBusy
    from repro.serve.rollout import WeightBank as JaxBank
    from repro_torch.serve.rollout import RolloutInProgressError, WeightBank
    banks = (JaxBank(("w0",)), WeightBank(("w0",)))
    trace = []
    for bank, busy in zip(banks, (JaxBusy, RolloutInProgressError)):
        log = [bank.begin(("w1",)), bank.begin(("w2",)), bank.versions]
        with pytest.raises(busy):
            bank.begin(("w3",), exclusive=True)
        log += [bank.gc({1}), bank.versions, bank.ensure(0, ("w0",)),
                bank.ensure(0, ("w0",)), bank.abort(), bank.versions,
                bank.weights(2), bank.gc(set()), bank.rolling]
        with pytest.raises(ValueError):
            bank.ensure(9, ("w9",))
        log += [(e.kind, e.version, e.retired) for e in bank.history]
        trace.append(log)
    assert trace[0] == trace[1]
