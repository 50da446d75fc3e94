"""Shared helpers of the serving-tier parity tests (this file holds no
test): one namespace per package (its ``serve`` module, configs,
parameter hand-over and engine keywords), seeded integer nets, and the
state a run is compared on."""

import copy
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import snn_mnist as jcfgs
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax

JAX = SimpleNamespace(name="jax", serve=jserve, cfgs=jcfgs, kw={},
                      params=lambda p: {"layers": [
                          {"w_q": jnp.asarray(l["w_q"]),
                           "scale": jnp.float32(l["scale"])}
                          for l in p["layers"]]})
TORCH = SimpleNamespace(name="torch", serve=tserve, cfgs=tcfgs,
                        kw={"device": "cpu"},
                        params=lambda p: params_from_jax(p, device="cpu"))


def small_net(rng, sizes):
    return {"layers": [
        {"w_q": rng.integers(-256, 256, (a, b)).astype(np.int16),
         "scale": np.float32(1.0)}
        for a, b in zip(sizes[:-1], sizes[1:])]}


def _cfg(pkg, sizes=(12, 6), T=8):
    return dataclasses.replace(pkg.cfgs.SNN_CONFIG, layer_sizes=sizes,
                               num_steps=T)


def _plan(pkg, events=(), **kw):
    return pkg.serve.FaultPlan(
        events=tuple(pkg.serve.FaultEvent(**e) for e in events), **kw)


def _results(res):
    return {rid: (r.pred, r.steps, r.adds, r.early_exit,
                  np.asarray(r.spike_counts).tolist(), r.weight_version)
            for rid, r in res.items()}


def _engine_state(e):
    return {"health": dataclasses.asdict(e.health),
            "history": copy.deepcopy(list(e.controller.history)),
            "ladder": e._ladder, "effective": e.backend_effective,
            "consults": None if e.injector is None else e.injector.consults,
            "bank": [(ev.kind, ev.version, ev.retired)
                     for ev in e.bank.history],
            "load": tuple(e.load_summary())}


def _tier_state(tier, res):
    return {"results": _results(res),
            "shed": {r: dataclasses.asdict(s) for r, s in tier.shed.items()},
            "faulted": {r: dataclasses.asdict(f)
                        for r, f in tier.faulted.items()},
            "stats": copy.deepcopy(tier.stats),
            "dead": sorted(tier._dead),
            "engines": [_engine_state(e) for e in tier.engines]}


def _tier(pkg, p, cfg, **kw):
    return pkg.serve.SNNServingTier(pkg.params(p), cfg, **kw, **pkg.kw)


def _engine(pkg, p, cfg, **kw):
    return pkg.serve.SNNStreamEngine(pkg.params(p), cfg, **kw, **pkg.kw)


def _both(case):
    """Run ``case(pkg)`` for both packages; the port must equal JAX."""
    want, got = case(JAX), case(TORCH)
    assert got == want
    return got


def _partition_ok(state, submitted):
    res, shed, faulted = (set(state["results"]), set(state["shed"]),
                          set(state["faulted"]))
    assert res | shed | faulted == set(submitted)
    assert not (res & shed) and not (res & faulted) and not (shed & faulted)
