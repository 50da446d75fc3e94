"""Process-level failover of the port (``repro_torch.serve.cluster``), on the
CPU: every cluster case of ``tests/test_cluster.py`` at its sizes, with the
workers' engines on ``device="cpu"``, each run held against the JAX
package's no-fault single-engine baseline.

Contracts under test:
  * **process failover == no-fault run** — with a seeded plan killing a
    worker process mid-window and the coordinator once, the recovered
    cluster run equals the JAX baseline prediction for prediction
    (reference AND fused backends, the latter through the kernels' plain
    version on the CPU);
  * **restart-and-readopt** — a hung or killed worker is detected by the
    heartbeat, respawned, re-probed and re-enters routing; with the
    respawn budget spent the survivors absorb its lanes;
  * **crash-proof accounting** — the write-ahead ledger restores
    ``results ∪ shed ∪ faulted`` as an exact partition after the
    coordinator dies (mid-evacuation too), rollouts replay, deadlines
    survive recovery;
  * **never-silent loss** — ``state_lost`` kills surface as
    ``FaultRecord("state_lost")``, and a replay reproduces every record;
  * **config threading** — the recovery knobs resolve into one
    ``FaultToleranceConfig`` for the in-process tier and the cluster.

``test_torch_cluster_records.py`` holds the rollout, state-loss and replay
cases, ``test_torch_cluster_cross.py`` the cases across the packages.
"""

import pytest

from repro_torch.configs.snn_mnist import (SNNClusterConfig,
                                           SNNServingTierConfig,
                                           make_cluster, make_serving_tier)
from repro_torch.serve import (ClusterCoordinator, CoordinatorCrash,
                               FaultToleranceConfig, Ledger, read_ledger)
from repro_torch.serve.wire import array_to_wire
from test_torch_cluster_common import (CFG, IMGS, KW, PARAMS,  # noqa: F401
                                       _assert_matches_baseline, _dead_slot,
                                       _partition_ok, _worker_env, as_tuple,
                                       baseline, make_co)


# ---- cluster: no-fault ----------------------------------------------------

def test_cluster_matches_single_engine(tmp_path):
    with make_co(tmp_path) as co:
        assert [h.backend for h in co.workers] == ["reference"] * 2
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        res = co.run()
        assert {r: as_tuple(v) for r, v in res.items()} == baseline()
        _partition_ok(co, range(len(IMGS)))
        assert not co.faulted and not co.shed
        # the coordinator's own round counters: one entry per round, and
        # every step reply's RPC inside a round's host time
        tel = co.telemetry
        assert tel["rounds"] == co.round == len(tel["active_lanes"])
        assert [r for r, _ in tel["active_lanes"]] == list(range(co.round))
        assert all(len(lanes) == KW["num_workers"]
                   for _, lanes in tel["active_lanes"])
        assert 0 < tel["step_replies"] <= 2 * co.round
        assert tel["step_replies"] * 4 < tel["step_reply_bytes"]
        assert tel["step_reply_max_bytes"] <= tel["step_reply_bytes"]
        assert 0 < tel["step_rpc_max_s"] <= tel["step_rpc_s"] \
            <= tel["host_s"]
    recs = read_ledger(str(tmp_path / "coordinator.jsonl"))
    assert {r["rid"] for r in recs if r["kind"] == "submit"} == set(
        range(len(IMGS)))
    assert all("deadline_steps" in r for r in recs if r["kind"] == "submit")
    wrecs = [r for i in range(KW["num_workers"])
             for r in read_ledger(str(tmp_path / f"worker-{i}.jsonl"))]
    assert {r["rid"] for r in wrecs if r["kind"] == "result"} == set(
        range(len(IMGS)))


# ---- cluster: the process-failover contract -------------------------------

CONTRACT_PLAN = "seed=0,worker_kill=1@2,coordinator_kill=4"


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_process_failover_contract(tmp_path, backend):
    """Worker 1 killed mid-window at round 2, coordinator killed at round
    4; ledger recovery re-runs the outstanding ids — final accounting is
    a lossless, bit-identical match of the no-fault run."""
    co = make_co(tmp_path, backend, plan=CONTRACT_PLAN)
    try:
        assert [h.backend for h in co.workers] == [backend] * 2
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        with pytest.raises(CoordinatorCrash):
            co.run()
        assert co.stats["workers_failed"] >= 1
        assert co.stats["evacuated"] >= 1
        recs = read_ledger(str(tmp_path / "coordinator.jsonl"))
        assert {r["rid"] for r in recs if r["kind"] == "submit"} == set(
            range(len(IMGS)))
        with ClusterCoordinator.recover(
                PARAMS, CFG, ledger_dir=str(tmp_path), backend=backend,
                fault_plan=CONTRACT_PLAN, **KW) as co2:
            co2.run()
            _partition_ok(co2, range(len(IMGS)))
            assert not co2.faulted and not co2.shed
            _assert_matches_baseline(co2)
    finally:
        co.close()


def test_worker_hang_detected_by_heartbeat(tmp_path):
    """A worker that stops responding mid-round trips the heartbeat
    deadline on the host's clock, is killed and respawned, and its lanes
    resume losslessly from the shipped checkpoints."""
    cfg = FaultToleranceConfig(heartbeat_interval_s=0.02,
                               heartbeat_deadline_s=1.5)
    with make_co(tmp_path, plan="seed=0,worker_hang=0@2",
                 fault_cfg=cfg) as co:
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        co.run()
        assert co.stats["workers_failed"] == 1
        assert co.stats["respawned"] == 1
        _partition_ok(co, range(len(IMGS)))
        assert not co.faulted
        _assert_matches_baseline(co)


def test_respawn_budget_exhausted_survivors_absorb(tmp_path):
    cfg = FaultToleranceConfig(max_respawns=0)
    with make_co(tmp_path, plan="seed=0,worker_kill=1@2",
                 fault_cfg=cfg) as co:
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        co.run()
        assert co.stats["respawned"] == 0
        assert [i for i, h in enumerate(co.workers) if h.alive] == [0]
        _partition_ok(co, range(len(IMGS)))
        assert not co.faulted
        _assert_matches_baseline(co)


def test_coordinator_crash_mid_evacuation_exactly_once(tmp_path):
    """The coordinator dies after landing ONE evacuated lane — recovery
    accounts every id exactly once."""
    co = make_co(tmp_path, plan="seed=0,worker_kill=1@2")
    co._crash_after_evacuations = 1
    try:
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        with pytest.raises(CoordinatorCrash):
            co.run()
        with ClusterCoordinator.recover(
                PARAMS, CFG, ledger_dir=str(tmp_path),
                backend="reference", fault_plan="seed=0,worker_kill=1@2",
                **KW) as co2:
            co2.run()
            _partition_ok(co2, range(len(IMGS)))
            _assert_matches_baseline(co2)
    finally:
        co.close()


def test_begin_rollout_requires_live_workers(tmp_path, monkeypatch):
    """With zero live workers the rollout fails loudly with a typed
    RuntimeError."""
    monkeypatch.setattr(ClusterCoordinator, "_spawn", _dead_slot)
    co = ClusterCoordinator(PARAMS, CFG, ledger_dir=str(tmp_path), **KW)
    with pytest.raises(RuntimeError, match="no live worker"):
        co.begin_rollout(PARAMS)
    co.close()


def test_recover_redispatch_preserves_deadline(tmp_path, monkeypatch):
    """deadline_steps rides the write-ahead submit record: recovery
    re-dispatches an outstanding SLO-bounded request with it."""
    led = Ledger(str(tmp_path / "coordinator.jsonl"))
    led.append({"kind": "submit", "rid": 0, "px": array_to_wire(IMGS[0]),
                "deadline_steps": 7})
    led.append({"kind": "submit", "rid": 1, "px": array_to_wire(IMGS[1]),
                "deadline_steps": None})
    led.close()
    captured = {}

    def fake_dispatch(self, rid, px, *, deadline_steps=None, **kw):
        captured[rid] = deadline_steps

    monkeypatch.setattr(ClusterCoordinator, "_spawn", _dead_slot)
    monkeypatch.setattr(ClusterCoordinator, "_dispatch", fake_dispatch)
    co = ClusterCoordinator.recover(PARAMS, CFG, ledger_dir=str(tmp_path),
                                    **KW)
    co.close()
    assert captured == {0: 7, 1: None}


# ---- config threading -----------------------------------------------------

def test_tier_config_recovery_knob_validation():
    with pytest.raises(ValueError, match="heartbeat_deadline_s"):
        SNNServingTierConfig(heartbeat_interval_s=0.5,
                             heartbeat_deadline_s=0.1)
    with pytest.raises(ValueError, match="watchdog_chunks"):
        SNNServingTierConfig(watchdog_chunks=0)
    with pytest.raises(ValueError, match="one source of truth"):
        SNNServingTierConfig(fault_cfg=FaultToleranceConfig(),
                             demote_after=2)
    knobs = SNNServingTierConfig(watchdog_chunks=5, demote_after=2,
                                 heartbeat_interval_s=0.01,
                                 heartbeat_deadline_s=3.0)
    eff = knobs.resolve_fault_cfg()
    assert eff.watchdog_chunks == 5 and eff.demote_after == 2
    assert eff.heartbeat_deadline_s == 3.0
    assert eff.max_retries == FaultToleranceConfig().max_retries


def test_tier_config_threads_fault_cfg_to_engines():
    knobs = SNNServingTierConfig(num_engines=1, lanes_per_engine=2,
                                 chunk_steps=2, shedding=False,
                                 watchdog_chunks=7)
    tier = make_serving_tier(PARAMS, CFG, knobs, patience=10_000, seed=0,
                             backend="reference", device="cpu")
    assert tier.fault_cfg.watchdog_chunks == 7
    assert all(e.fault_cfg.watchdog_chunks == 7 for e in tier.engines)


def test_cluster_config_validation_and_factory(tmp_path):
    with pytest.raises(ValueError, match="num_workers"):
        SNNClusterConfig(num_workers=0)
    with pytest.raises(ValueError, match="lanes_per_worker"):
        SNNClusterConfig(lanes_per_worker=0)
    with pytest.raises(ValueError, match="ledger_dir"):
        make_cluster(PARAMS, CFG, SNNClusterConfig(num_workers=1),
                     device="cpu")
    knobs = SNNClusterConfig(num_workers=1, lanes_per_worker=2,
                             chunk_steps=2, backend="reference",
                             ledger_dir=str(tmp_path))
    tier_knobs = SNNServingTierConfig(heartbeat_interval_s=0.01,
                                      heartbeat_deadline_s=5.0)
    with make_cluster(PARAMS, CFG, knobs, tier_knobs,
                      patience=10_000, seed=0, device="cpu") as co:
        assert co.fault_cfg.heartbeat_deadline_s == 5.0
        assert co.device == "cpu"
        co.submit(IMGS[0], request_id=0)
        res = co.run()
        assert as_tuple(res[0]) == baseline()[0]
