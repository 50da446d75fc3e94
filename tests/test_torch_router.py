"""Parity of the port's serving tier with the JAX package's, on the CPU.

The same seeded images, tier seed, weight codes and submission schedule
go through ``repro.serve.SNNServingTier`` and
``repro_torch.serve.SNNServingTier(device="cpu")``; the port must equal
the JAX package on the routing (every request's engine and the per-engine
counts), the shed records, the results, the load reports, the rollout
histories and the ledger lines.  One sharded case builds the port's tier
over four CPU devices (2 engines × 2 data shards) against the JAX tier
on a forced-host 4-device CPU in a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.serve import SNNStreamEngine
from test_torch_tier_common import TORCH, _both, _cfg, _results, _tier, small_net

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _state(tier, res):
    return {"results": _results(res),
            "assignment": dict(tier._assignment),
            "shed": {r: dataclasses.asdict(s) for r, s in tier.shed.items()},
            "stats": dict(tier.stats, routed_per_engine=list(
                tier.stats["routed_per_engine"])),
            "loads": [tuple(l) for l in tier.load_report()],
            "rollouts": [[(e.kind, e.version, e.retired) for e in h]
                         for h in tier.rollout_history()],
            "next_id": tier._next_id}


@pytest.mark.parametrize("seed,n_engines,chunk_steps,burst", [
    (3, 1, 2, 2), (17, 3, 1, 4), (905, 4, 5, 1), (65_000, 2, 3, 5),
])
def test_random_schedules_route_and_serve_alike(seed, n_engines, chunk_steps,
                                               burst):
    """A random bursty schedule with early exit live: the same engine for
    every request, the same results, and the JAX tier's results equal
    single-engine serving (so the port's do too)."""
    rng = np.random.default_rng(seed)
    p = small_net(rng, (12, 6))
    n_imgs = int(rng.integers(4, 12))
    imgs = rng.integers(0, 256, (n_imgs, 12), dtype=np.uint8)
    takes = rng.integers(0, burst + 1, 4 * n_imgs + 8).tolist()

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=n_engines,
                     lanes_per_engine=2, chunk_steps=chunk_steps, patience=1,
                     seed=seed, backend="reference", shedding=False)
        done, routes = 0, []
        for take in takes:
            take = min(take, n_imgs - done)
            for im in imgs[done:done + take]:
                routes.append(tier._assignment[tier.submit(im)])
            done += take
            tier.step()
        for im in imgs[done:]:
            tier.submit(im)
        st = _state(tier, tier.run())
        st["routes"] = routes
        return st

    st = _both(case)
    one = SNNStreamEngine(TORCH.params(p), _cfg(TORCH), batch_size=4,
                          chunk_steps=chunk_steps, patience=1, seed=seed,
                          backend="reference", device="cpu")
    for im in imgs:
        one.submit(im)
    assert st["results"] == _results(one.run())


def test_routing_order_matches_jax():
    rng = np.random.default_rng(1)
    p = small_net(rng, (24, 12, 10))
    imgs = rng.integers(0, 256, (24, 24), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg, (24, 12, 10), 10), num_engines=3,
                     lanes_per_engine=4, chunk_steps=3, patience=2, seed=5,
                     backend="reference")
        for im in imgs:
            tier.submit(im)
        assignment = dict(tier._assignment)
        st = _state(tier, tier.run())
        st["assigned"] = assignment
        return st

    st = _both(case)
    assert st["stats"]["routed_per_engine"] == [8, 8, 8]
    assert st["assigned"][0] == 0


def test_deadline_and_overload_shed_records_match_jax():
    rng = np.random.default_rng(3)
    p = small_net(rng, (24, 12, 10))
    imgs = rng.integers(0, 256, (16, 24), dtype=np.uint8)

    def case(pkg):
        cfg = _cfg(pkg, (24, 12, 10), 10)
        tier = _tier(pkg, p, cfg, num_engines=2, lanes_per_engine=2,
                     chunk_steps=3, patience=10_000, seed=0,
                     backend="reference")
        for im in imgs[:10]:
            tier.submit(im)
        tier.submit(imgs[10], deadline_steps=1)
        tier.submit(imgs[11], deadline_steps=10_000)
        deadline = _state(tier, tier.run())
        tier = _tier(pkg, p, cfg, num_engines=2, lanes_per_engine=2,
                     chunk_steps=3, patience=10_000, seed=0,
                     backend="reference", queue_limit=2)
        for im in imgs[:8]:
            tier.submit(im, priority="batch")
        for im in imgs[8:10]:
            tier.submit(im, priority="interactive")
        tier.submit(imgs[10], priority="batch")
        tier.step()
        tier.submit(imgs[11], priority="standard", deadline_steps=4)
        return {"deadline": deadline, "overload": _state(tier, tier.run())}

    st = _both(case)
    assert st["deadline"]["shed"][10]["reason"] == "deadline"
    reasons = {s["reason"] for s in st["overload"]["shed"].values()}
    assert "overload" in reasons
    assert st["overload"]["stats"]["displaced"] == 2


def test_unknown_priority_leaves_tier_untouched_alike():
    rng = np.random.default_rng(17)
    p = small_net(rng, (12, 6))
    img = np.zeros(12, np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     backend="reference", shedding=False)
        errs = []
        for kw in (dict(priority="platinum"), None, dict(request_id=0)):
            if kw is None:
                tier.submit(img)
                continue
            with pytest.raises(ValueError) as ei:
                tier.submit(img, **kw)
            errs.append(str(ei.value))
            errs.append((tier._next_id, dict(tier._meta),
                         [e.pending for e in tier.engines]))
        with pytest.raises(ValueError) as ei:
            pkg.serve.SNNServingTier(pkg.params(p), _cfg(pkg),
                                     default_priority="platinum",
                                     backend="reference", **pkg.kw)
        errs.append(str(ei.value))
        st = _state(tier, tier.run())
        st["errs"] = errs
        return st

    st = _both(case)
    assert st["errs"][1] == (0, {}, [0, 0])
    assert set(st["results"]) == {0}


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_rollouts_mid_traffic_match_jax(backend):
    """One rollout mid-traffic, then two back to back before the first
    drains: every window on its admission-time weights, the same rollout
    histories on every engine."""
    rng = np.random.default_rng(6)
    sizes = (16, 8)
    nets = [small_net(np.random.default_rng(k), sizes) for k in (0, 99, 7)]
    imgs = rng.integers(0, 256, (12, 16), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, nets[0], _cfg(pkg, sizes, 8), num_engines=2,
                     lanes_per_engine=4, chunk_steps=3, patience=10_000,
                     seed=11, backend=backend, shedding=False)
        for im in imgs[:4]:
            tier.submit(im)
        tier.step()
        v1 = tier.begin_rollout(pkg.params(nets[1]))
        for im in imgs[4:8]:
            tier.submit(im)
        tier.step()
        v2 = tier.begin_rollout(pkg.params(nets[2]))
        for im in imgs[8:]:
            tier.submit(im)
        active = tier.rollout_active
        st = _state(tier, tier.run())
        st["versions"] = (v1, v2, active, tier.rollout_active)
        return st

    st = _both(case)
    assert st["versions"] == (1, 2, True, False)
    assert [st["results"][r][-1] for r in range(12)] == [0] * 4 + [1] * 4 \
        + [2] * 4


def test_serving_tier_config_builds_alike():
    rng = np.random.default_rng(2)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (10, 12), dtype=np.uint8)

    def case(pkg):
        knobs = pkg.cfgs.SNNServingTierConfig(
            num_engines=3, lanes_per_engine=2, chunk_steps=2, queue_limit=1,
            priority_classes=("low", "high"), default_priority="low",
            default_deadline_steps=30, watchdog_chunks=3, demote_after=3)
        tier = pkg.cfgs.make_serving_tier(pkg.params(p), _cfg(pkg), knobs,
                                          backend="reference", seed=4,
                                          **pkg.kw)
        for i, im in enumerate(imgs):
            tier.submit(im, priority=("low", "high")[i % 2])
        st = _state(tier, tier.run())
        st["knobs"] = (tier.priority_classes, tier.default_priority,
                       tier.queue_limit, tier.default_deadline_steps,
                       dataclasses.asdict(tier.fault_cfg),
                       [(e.batch_size, e.chunk_steps) for e in tier.engines])
        default = pkg.cfgs.make_serving_tier(pkg.params(p), _cfg(pkg),
                                             backend="reference", **pkg.kw)
        st["default"] = (default.queue_limit, default.priority_classes,
                         [(e.batch_size, e.chunk_steps)
                          for e in default.engines],
                         dataclasses.asdict(default.fault_cfg))
        return st

    st = _both(case)
    assert st["knobs"][-1] == [(2, 2)] * 3 and st["default"][2] == [(8, 4)] * 2


def test_ledger_lines_match_jax(tmp_path):
    """A tier with a ledger appends the same shed, fault and result lines
    in the same order in both packages."""
    rng = np.random.default_rng(30)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (9, 12), dtype=np.uint8)

    def case(pkg):
        path = tmp_path / f"{pkg.name}.jsonl"
        ledger = pkg.serve.Ledger(str(path))
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=1, seed=8, backend="reference",
                     queue_limit=1, ledger=ledger,
                     fault_plan=pkg.serve.FaultPlan(events=(
                         pkg.serve.FaultEvent(kind="poison", request_id=0),),
                     ), fault_cfg=pkg.serve.FaultToleranceConfig(
                         quarantine_after=1))
        for im in imgs:
            tier.submit(im)
        tier.run()
        ledger.close()
        return pkg.serve.read_ledger(str(path))

    lines = _both(case)
    kinds = {rec["kind"] for rec in lines}
    assert kinds == {"shed", "fault", "result"}


_JAX_SHARDED_TIER = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    import dataclasses
    from repro.configs.snn_mnist import SNN_CONFIG
    from repro.serve import FaultEvent, FaultPlan, SNNServingTier
    assert len(jax.devices()) == 4
    case = json.loads(sys.argv[1])
    cfg = dataclasses.replace(SNN_CONFIG, layer_sizes=tuple(case["sizes"]),
                              num_steps=case["T"])
    params = {"layers": [{"w_q": jnp.asarray(np.asarray(w, np.int16)),
                          "scale": jnp.float32(1.0)} for w in case["codes"]]}
    plan = FaultPlan(events=(FaultEvent(kind="device_loss", engine=1,
                                        first_chunk=2),))
    tier = SNNServingTier(params, cfg, num_engines=2, lanes_per_engine=4,
                          chunk_steps=3, patience=10_000, seed=11,
                          backend="reference", sharded=True,
                          devices_per_engine=2, shedding=False,
                          fault_plan=plan)
    for im in np.asarray(case["imgs"], np.uint8):
        tier.submit(im)
    res = tier.run()
    print(json.dumps({
        "results": {str(k): [r.pred, r.steps, r.adds, r.early_exit,
                             np.asarray(r.spike_counts).tolist()]
                    for k, r in res.items()},
        "stats": tier.stats,
        "ladders": [list(e._ladder) for e in tier.engines],
        "events": [e.health.events for e in tier.engines]}))
"""


def test_sharded_tier_matches_jax_on_four_devices():
    """Two sharded engines of two data shards each (the port over four CPU
    devices, the JAX package over a forced-host 4-device CPU), engine 1
    lost mid-window: the same results, stats, ladders and health logs."""
    import torch
    rng = np.random.default_rng(12)
    sizes, T = (24, 12, 10), 10
    p = small_net(rng, sizes)
    imgs = rng.integers(0, 256, (16, sizes[0]), dtype=np.uint8)
    case = {"sizes": sizes, "T": T,
            "codes": [l["w_q"].tolist() for l in p["layers"]],
            "imgs": imgs.tolist()}
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_JAX_SHARDED_TIER),
                          json.dumps(case)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])

    tier = _tier(TORCH, p, _cfg(TORCH, sizes, T), num_engines=2,
                 lanes_per_engine=4, chunk_steps=3, patience=10_000, seed=11,
                 backend="reference", sharded=True, devices_per_engine=2,
                 shedding=False,
                 fault_plan=TORCH.serve.FaultPlan(events=(
                     TORCH.serve.FaultEvent(kind="device_loss", engine=1,
                                            first_chunk=2),)),
                 devices=[torch.device("cpu")] * 4)
    for e in tier.engines:
        assert e.n_devices == 2 and e.local_batch == 2
    for im in imgs:
        tier.submit(im)
    res = tier.run()
    got = {"results": {str(k): [r.pred, r.steps, r.adds, r.early_exit,
                                np.asarray(r.spike_counts).tolist()]
                       for k, r in res.items()},
           "stats": tier.stats,
           "ladders": [list(e._ladder) for e in tier.engines],
           "events": [e.health.events for e in tier.engines]}
    assert got == want
    assert want["stats"]["evacuated"] >= 1 and len(want["results"]) == 16
