"""Parity of the port's fault harness with the JAX package's, on the CPU.

Each case of ``tests/test_faults.py`` runs twice, at its own sizes, on the
same seeded numpy inputs and the same fault plan: through
``repro.serve`` (the reference backend, or ``fused`` in interpret mode)
and through ``repro_torch.serve`` with ``device="cpu"`` (the codes handed
over with ``params_from_jax``).  The port must equal the JAX package on
the results, the shed and fault records, the tier's stats, every
engine's health log and controller history, its ladder, its effective
rung after the run and its injector's consult count.  Plus the plan
grammar, the policy validation and the router's estimators as equal
values, seeded random plans through both tiers, and two properties of
the port alone: a kernel error under an armed injector is never taken
for a fault, and a demoted engine packs no weights per chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from test_torch_tier_common import JAX, TORCH, _both, _cfg, _engine, \
    _engine_state, _partition_ok, _plan, _results, _tier, _tier_state, \
    small_net
from repro.core import telemetry as jtel
from repro_torch.core import telemetry as ttel
from repro_torch.kernels import fused_snn as tfused
from repro_torch.kernels import ops as tops
from repro_torch.serve import snn_engine as tengine


# ---- failover -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_failover_evacuation_matches_jax(backend):
    rng = np.random.default_rng(6)
    p = small_net(rng, (16, 8))
    imgs = rng.integers(0, 256, (6, 16), dtype=np.uint8)

    def case(pkg):
        out = {}
        for name, events in (("plan", [dict(kind="device_loss", engine=1,
                                            first_chunk=2)]), ("base", None)):
            tier = _tier(pkg, p, _cfg(pkg, (16, 8), 8), num_engines=2,
                         lanes_per_engine=2, chunk_steps=3, patience=10_000,
                         seed=11, backend=backend, shedding=False,
                         fault_plan=(None if events is None
                                     else _plan(pkg, events)))
            rids = [tier.submit(im) for im in imgs]
            out[name] = _tier_state(tier, tier.run())
            out[name]["rids"] = rids
        return out

    got = _both(case)
    st = got["plan"]
    assert st["stats"]["engines_failed"] == 1 and st["stats"]["evacuated"] >= 1
    assert st["faulted"] == {} and st["results"] == got["base"]["results"]
    _partition_ok(st, st["rids"])


def test_hang_watchdog_and_requeue_match_jax():
    rng = np.random.default_rng(7)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (6, 12), dtype=np.uint8)

    def case(pkg):
        ft = pkg.serve.FaultToleranceConfig(watchdog_chunks=2)
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=10_000, seed=3,
                     backend="reference", shedding=False, fault_cfg=ft,
                     fault_plan=_plan(pkg, [dict(kind="hang", engine=1,
                                                 first_chunk=1)]))
        for im in imgs:
            tier.submit(im)
        return _tier_state(tier, tier.run())

    st = _both(case)
    assert st["stats"]["evacuated"] >= 1 and st["stats"]["requeued"] >= 1
    fail = [e for e in st["engines"][1]["health"]["events"]
            if e.get("event") == "engine_failure"]
    assert fail and fail[0]["reason"] == "hang"
    assert st["engines"][0]["load"][6:] == (0, 0, 2, True)


def test_state_lost_records_match_jax():
    rng = np.random.default_rng(8)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (6, 12), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=10_000, seed=5,
                     backend="reference", shedding=False,
                     fault_plan=_plan(pkg, [dict(
                         kind="device_loss", engine=1, first_chunk=1,
                         state_lost=True)]))
        for im in imgs:
            tier.submit(im)
        return _tier_state(tier, tier.run())

    st = _both(case)
    _partition_ok(st, range(6))
    assert any(f["reason"] == "state_lost" for f in st["faulted"].values())
    assert all(f["replay_seed"] == 5 + r for r, f in st["faulted"].items())


def test_all_engines_dead_matches_jax():
    rng = np.random.default_rng(9)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (3, 12), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=10_000, seed=1,
                     backend="reference", shedding=False,
                     fault_plan=_plan(pkg, [dict(kind="device_loss",
                                                 first_chunk=0)]))
        for im in imgs[:2]:
            tier.submit(im)
        res = tier.run()
        tier.submit(imgs[2])
        return _tier_state(tier, res)

    st = _both(case)
    assert st["results"] == {} and st["dead"] == [0, 1]
    assert st["faulted"][2]["reason"] == "no_capacity"
    _partition_ok(st, range(3))


# ---- the engine's ladder, retries and escalation ----------------------------

def test_degradation_ladder_matches_jax():
    rng = np.random.default_rng(10)
    p = small_net(rng, (16, 8))
    imgs = rng.integers(0, 256, (6, 16), dtype=np.uint8)

    def case(pkg):
        out = {}
        for name, plan in (("plan", _plan(pkg, [dict(
                kind="dispatch", first_chunk=0, last_chunk=4,
                backends=("fused",))])), ("base", None)):
            eng = _engine(pkg, p, _cfg(pkg, (16, 8), 8), batch_size=2,
                          chunk_steps=2, patience=10_000, seed=4,
                          backend="fused",
                          fault_cfg=pkg.serve.FaultToleranceConfig(
                              demote_after=2, promote_after=3),
                          injector=(None if plan is None else
                                    pkg.serve.FaultInjector(plan, 0)))
            assert eng._ladder == ("fused", "fused_streamed", "reference")
            for im in imgs:
                eng.submit(im)
            out[name] = {"results": _results(eng.run()),
                         **_engine_state(eng)}
        return out

    got = _both(case)
    st = got["plan"]
    assert st["results"] == got["base"]["results"]
    moves = [(e["event"], e["from"], e["to"]) for e in st["health"]["events"]
             if e["event"] in ("demote", "promote")]
    assert moves[0] == ("demote", "fused", "fused_streamed")
    assert moves[-1] == ("promote", "fused_streamed", "fused")
    assert st["effective"] == "fused" and st["health"]["alive"]


@pytest.mark.parametrize("kind", ["dispatch", "telemetry"])
def test_retry_backoff_and_corrupted_telemetry_match_jax(kind):
    """A bounded transient burst (retries and backoff) or two corrupted
    telemetry records: results untouched, the same health counts."""
    seed, n, eng_seed, last = {"dispatch": (11, 4, 2, 3),
                               "telemetry": (13, 2, 6, 1)}[kind]
    rng = np.random.default_rng(seed)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (n, 12), dtype=np.uint8)

    def case(pkg):
        out = {}
        for name, plan in (("plan", _plan(pkg, [dict(
                kind=kind, first_chunk=0, last_chunk=last)])),
                ("base", None)):
            eng = _engine(pkg, p, _cfg(pkg), batch_size=2, chunk_steps=2,
                          patience=10_000, seed=eng_seed,
                          backend="reference",
                          injector=(None if plan is None else
                                    pkg.serve.FaultInjector(plan, 0)))
            for im in imgs:
                eng.submit(im)
            out[name] = {"results": _results(eng.run()),
                         **_engine_state(eng)}
        return out

    got = _both(case)
    st = got["plan"]
    assert st["results"] == got["base"]["results"]
    if kind == "dispatch":
        assert st["health"]["total_faults"] == 4
    else:
        assert st["health"]["telemetry_faults"] == 2
    assert st["health"]["alive"] and st["health"]["consecutive_faults"] == 0


def test_escalation_to_engine_failure_matches_jax():
    rng = np.random.default_rng(12)
    p = small_net(rng, (12, 6))

    def case(pkg):
        eng = _engine(pkg, p, _cfg(pkg), batch_size=2, chunk_steps=2,
                      patience=10_000, seed=2, backend="reference",
                      injector=pkg.serve.FaultInjector(_plan(pkg, [dict(
                          kind="dispatch", first_chunk=0)]), 0))
        eng.submit(np.zeros(12, np.uint8))
        with pytest.raises(pkg.serve.EngineFailure) as ei:
            eng.run()
        load = eng.load_summary()
        score = (jtel if pkg is JAX else ttel).load_score(load)
        return {"error": (str(ei.value), ei.value.reason,
                          ei.value.state_lost),
                "score": score, **_engine_state(eng)}

    st = _both(case)
    assert st["error"][1] == "dispatch_exhausted"
    assert st["score"] == float("inf") and not st["health"]["alive"]


# ---- poison, rollout ------------------------------------------------------

def test_poison_quarantine_matches_jax():
    rng = np.random.default_rng(14)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (5, 12), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=10_000, seed=21,
                     backend="reference", shedding=False,
                     fault_cfg=pkg.serve.FaultToleranceConfig(
                         quarantine_after=2),
                     fault_plan=_plan(pkg, [dict(kind="poison", request_id=2,
                                                 first_chunk=0)]))
        for im in imgs:
            tier.submit(im)
        return _tier_state(tier, tier.run())

    st = _both(case)
    assert set(st["faulted"]) == {2}
    rec = st["faulted"][2]
    assert (rec["reason"], rec["faults"], rec["replay_seed"]) == \
        ("quarantined", 2, 23)
    assert st["stats"]["poison_retries"] == 1


def test_evacuation_restores_gcd_version_matches_jax():
    rng = np.random.default_rng(15)
    old = small_net(rng, (12, 6))
    new = small_net(np.random.default_rng(99), (12, 6))
    img = rng.integers(0, 256, (12,), dtype=np.uint8)

    def case(pkg):
        kw = dict(batch_size=2, chunk_steps=2, patience=10_000, seed=30,
                  backend="reference")
        src = _engine(pkg, old, _cfg(pkg), **kw)
        src.submit(img, request_id=7)
        src.step()
        row = src.evict_lane(7)
        tgt = _engine(pkg, old, _cfg(pkg), **kw)
        tgt.begin_rollout(pkg.params(new))
        tgt.bank.gc({1})
        with pytest.raises(KeyError, match="version 0"):
            tgt.adopt(7, row)
        assert tgt.bank.ensure(0, tgt._place_weights(tuple(
            l["w_q"] for l in pkg.params(old)["layers"])))
        tgt.adopt(7, row)
        return {"row_steps": int(row.steps), "results": _results(tgt.run()),
                "src": _engine_state(src), **_engine_state(tgt)}

    st = _both(case)
    assert st["row_steps"] > 0 and st["results"][7][-1] == 0
    assert [b[0] for b in st["bank"]] == ["begin", "complete", "restore",
                                          "complete"]


def test_failure_mid_rollout_matches_jax():
    rng = np.random.default_rng(16)
    old = small_net(rng, (12, 6))
    new = small_net(np.random.default_rng(98), (12, 6))
    imgs = rng.integers(0, 256, (4, 12), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, old, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=10_000, seed=40,
                     backend="reference", shedding=False,
                     fault_plan=_plan(pkg, [dict(kind="device_loss",
                                                 engine=1, first_chunk=2)]))
        for im in imgs[:2]:
            tier.submit(im)
        tier.step()
        assert tier.begin_rollout(pkg.params(new)) == 1
        for im in imgs[2:]:
            tier.submit(im)
        tier.step()
        tier.step()
        active = tier.rollout_active
        st = _tier_state(tier, tier.run())
        st["active_then_after"] = (active, tier.rollout_active)
        return st

    st = _both(case)
    assert st["dead"] == [1] and st["active_then_after"] == (True, False)
    assert st["engines"][1]["bank"][-1][0] == "abort"
    assert [st["results"][r][-1] for r in range(4)] == [0, 0, 1, 1]


# ---- env arming, random plans ---------------------------------------------

def test_env_plan_arms_both_packages_alike(monkeypatch):
    rng = np.random.default_rng(18)
    p = small_net(rng, (12, 6))
    imgs = rng.integers(0, 256, (4, 12), dtype=np.uint8)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "seed=3,dispatch=0.2")

    def case(pkg):
        eng = _engine(pkg, p, _cfg(pkg), batch_size=2, chunk_steps=2,
                      patience=10_000, seed=9, backend="reference")
        for im in imgs:
            eng.submit(im)
        return {"results": _results(eng.run()), **_engine_state(eng)}

    st = _both(case)
    assert st["consults"] > 0 and st["health"]["total_faults"] > 0


@pytest.mark.parametrize("seed,kill,kchunk,rate,state_lost", [
    (0, 0, 1, 0.1, False), (77, 1, 3, 0.15, True), (4242, 1, 2, 0.05, False),
])
def test_random_plans_partition_alike(seed, kill, kchunk, rate, state_lost):
    rng = np.random.default_rng(seed)
    p = small_net(rng, (12, 6))
    n = int(rng.integers(4, 10))
    imgs = rng.integers(0, 256, (n, 12), dtype=np.uint8)

    def case(pkg):
        tier = _tier(pkg, p, _cfg(pkg), num_engines=2, lanes_per_engine=2,
                     chunk_steps=2, patience=1, seed=seed,
                     backend="reference", default_deadline_steps=40,
                     queue_limit=3,
                     fault_plan=_plan(pkg, [dict(
                         kind="device_loss", engine=kill, first_chunk=kchunk,
                         state_lost=state_lost)], seed=seed,
                         dispatch_rate=rate))
        for im in imgs:
            tier.submit(im)
        return _tier_state(tier, tier.run())

    _partition_ok(_both(case), range(n))


# ---- grammar, policy, estimators ------------------------------------------

@pytest.mark.parametrize("spec", [
    "seed=7,dispatch=0.1,worker_kill=1@3,worker_hang=0@2,coordinator_kill=5,"
    "worker_kill=0@9",
    "seed=11,dispatch=0.03,telemetry=0.02", "", " seed=2 , ",
    "seed=11,dipsatch=0.03", "worker_kill=1", "worker_kill=a@3",
    "worker_hang=0@", "worker_kill=-1@3", "coordinator_kill=x",
    "coordinator_kill=-2", "dispatch=1.5", "seed=abc", "seed",
])
def test_from_spec_matches_jax(spec):
    def case(pkg):
        try:
            plan = pkg.serve.FaultPlan.from_spec(spec)
        except pkg.serve.FaultPlanSpecError as e:
            return ("error", e.key, str(e))
        return ("plan", plan.seed, plan.dispatch_rate, plan.telemetry_rate,
                [dataclasses.asdict(ev) for ev in plan.events],
                [plan.worker_kill(w, r) is not None
                 for w in range(2) for r in range(10)],
                [plan.coordinator_kill(r) for r in range(10)],
                [plan.engine_relevant(e) for e in range(3)])

    _both(case)
    assert tserve.faults.FAULT_PLAN_GRAMMAR == jserve.faults.FAULT_PLAN_GRAMMAR


@pytest.mark.parametrize("bad", [
    dict(heartbeat_interval_s=0.0),
    dict(heartbeat_deadline_s=0.05, heartbeat_interval_s=0.1),
    dict(max_respawns=-1), dict(watchdog_chunks=0), dict(max_retries=-1),
    dict(fail_after=0), dict(backoff_max=0),
])
def test_fault_tolerance_config_validates_alike(bad):
    def case(pkg):
        with pytest.raises(ValueError) as ei:
            pkg.serve.FaultToleranceConfig(**bad)
        return str(ei.value)

    _both(case)
    assert dataclasses.asdict(tserve.FaultToleranceConfig()) == \
        dataclasses.asdict(jserve.FaultToleranceConfig())


def test_router_estimators_equal_jax_floats():
    rng = np.random.default_rng(123)
    edge = [0.0, -3.5, float("nan"), float("inf"), float("-inf")]
    for i in range(400):
        lanes = int(rng.integers(1, 65))
        rec = (lanes, int(rng.integers(0, lanes + 1)),
               int(rng.integers(0, 129)),
               float(rng.uniform(0.5, 200.0)) if i % 4 else
               edge[i // 4 % len(edge)],
               int(rng.integers(0, 1000)), None,
               int(rng.integers(0, 9)), int(rng.integers(0, 3)),
               None if i % 3 else int(rng.integers(0, 5)), bool(i % 7))
        j, t = jtel.EngineLoad(*rec), ttel.EngineLoad(*rec)
        for fn in ("load_score", "estimate_eta_steps",
                   "_effective_service_steps"):
            a, b = getattr(jtel, fn)(j), getattr(ttel, fn)(t)
            assert a == b or (a != a and b != b), (fn, rec)
        assert t.occupancy == j.occupancy
        wire = ttel.engine_load_to_wire(t)
        assert wire == jtel.engine_load_to_wire(j)
        back = ttel.engine_load_from_wire(wire)
        assert back == t or rec[3] != rec[3]


def test_tier_knobs_resolve_alike():
    def case(pkg):
        knobs = pkg.cfgs.SNNServingTierConfig(
            max_respawns=3, heartbeat_interval_s=0.01,
            heartbeat_deadline_s=2.0)
        errs = []
        for bad in (dict(fault_cfg=pkg.serve.FaultToleranceConfig(),
                         max_respawns=2),
                    dict(heartbeat_interval_s=1.0,
                         heartbeat_deadline_s=0.5)):
            with pytest.raises(ValueError) as ei:
                pkg.cfgs.SNNServingTierConfig(**bad)
            errs.append(str(ei.value))
        return (dataclasses.asdict(knobs.resolve_fault_cfg()),
                pkg.cfgs.SNNServingTierConfig().resolve_fault_cfg(), errs,
                pkg.cfgs.TIER_PRIORITY_CLASSES)

    _both(case)


# ---- the port alone: kernel errors and placed forms -------------------------

def test_kernel_error_is_not_a_fault(monkeypatch):
    """An error the chunk raises under an armed injector propagates as it
    is; the harness never takes it for a fault or walks the ladder."""
    rng = np.random.default_rng(19)
    cfg = _cfg(TORCH, (16, 8), 8)
    eng = _engine(TORCH, small_net(rng, (16, 8)), cfg, batch_size=2,
                  chunk_steps=2, patience=10_000, seed=4, backend="fused",
                  injector=tserve.FaultInjector(_plan(TORCH, seed=5,
                                                      dispatch_rate=0.0), 0))
    eng.submit(rng.integers(0, 256, 16, dtype=np.uint8))

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tops, "fused_snn_stack_op", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.step()
    assert dataclasses.asdict(eng.health) == dataclasses.asdict(
        tserve.EngineHealthState())
    assert eng.backend_effective == "fused" and eng.injector.consults == 1
    assert eng.controller.history == []


def test_demoted_engine_packs_no_weights_per_chunk(monkeypatch):
    """The bank places every ladder rung's form once per version: a demoted
    ``fused → fused_streamed`` engine runs on planes packed at
    construction and at the rollout, never per chunk."""
    rng = np.random.default_rng(20)
    sizes = (16, 12, 8)
    p, new = small_net(rng, sizes), small_net(np.random.default_rng(5), sizes)
    imgs = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    packs = []
    pack = tfused.pack_weights

    def counting_pack(w):
        packs.append(tuple(w.shape))
        return pack(w)

    monkeypatch.setattr(tengine, "pack_weights", counting_pack)
    monkeypatch.setattr(tfused, "pack_weights", counting_pack)
    plan = _plan(TORCH, [dict(kind="dispatch", first_chunk=0,
                              last_chunk=10_000, backends=("fused",))])
    eng = _engine(TORCH, p, _cfg(TORCH, sizes, 8), batch_size=4,
                  chunk_steps=2, patience=10_000, seed=8, backend="fused",
                  injector=tserve.FaultInjector(plan, 0),
                  fault_cfg=tserve.FaultToleranceConfig(
                      demote_after=1, promote_after=1000))
    assert len(packs) == 2                     # one version, two layers
    for im in imgs[:4]:
        eng.submit(im)
    eng.step()
    assert eng.backend_effective == "fused_streamed"
    assert all(tfused.is_planes(w) for w in eng.weights)
    eng.begin_rollout(TORCH.params(new))
    assert len(packs) == 4                     # two versions placed
    for im in imgs[4:]:
        eng.submit(im)
    res = eng.run()
    assert len(packs) == 4 and eng.dispatches > 4
    ref = _engine(TORCH, p, _cfg(TORCH, sizes, 8), batch_size=4,
                  chunk_steps=2, patience=10_000, seed=8, backend="reference")
    for im in imgs[:4]:
        ref.submit(im)
    ref.step()
    ref.begin_rollout(TORCH.params(new))
    for im in imgs[4:]:
        ref.submit(im)
    assert _results(res) == _results(ref.run())


def test_telemetry_check_on_tensors():
    tel = ttel.ChunkTelemetry(n_spk=torch.ones(2, 1, 3, dtype=torch.int32),
                              n_en=torch.ones(2, 1, 3, dtype=torch.int32),
                              tiles_skipped=torch.zeros(2, 1, 1,
                                                        dtype=torch.int32))
    ok = tserve.faults.telemetry_ok
    assert ok(tel) and not ok(None)
    assert not ok(tel._replace(n_en=tel.n_en.float()))
    assert not ok(tel._replace(n_spk=tel.n_spk > 0))
    inj = tserve.FaultInjector(_plan(TORCH, [dict(kind="telemetry")]), 0)
    inj.consults = 1
    bad = inj.filter_telemetry(tel)
    assert bad.n_spk.dtype == torch.int32 and not ok(bad)
    assert int(bad.n_spk.max()) == -2
