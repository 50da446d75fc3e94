"""Process-level failover of the port, continued (see
``test_torch_cluster.py``): weight rollouts that survive a coordinator
crash, state-losing kills that surface as fault records, and a replay of
one plan that reproduces every record."""

import numpy as np
import pytest

from repro_torch.serve import (ClusterCoordinator, CoordinatorCrash,
                               FaultEvent, FaultPlan, read_ledger)
from test_torch_cluster_common import (CFG, IMGS, KW, PARAMS,  # noqa: F401
                                       _assert_matches_baseline,
                                       _partition_ok, _worker_env, as_tuple,
                                       make_co)
from test_torch_tier_common import small_net


def test_rollout_survives_coordinator_crash(tmp_path):
    """Weight rollouts are ledgered and replayed on recovery: the four
    requests outstanding at the crash re-run at the pre-crash version."""
    params2 = small_net(np.random.default_rng(99), CFG.layer_sizes)
    co = make_co(tmp_path)
    try:
        for i, im in enumerate(IMGS[:4]):
            co.submit(im, request_id=i)
        assert co.begin_rollout(params2) == 1
        with pytest.raises(CoordinatorCrash):
            co._crash(co.round)
    finally:
        co.close()
    recs = read_ledger(str(tmp_path / "coordinator.jsonl"))
    assert [r["version"] for r in recs if r["kind"] == "rollout"] == [1]
    with ClusterCoordinator.recover(
            PARAMS, CFG, ledger_dir=str(tmp_path), backend="reference",
            **KW) as co2:
        assert co2._current_version == 1
        res = co2.run()
        assert set(res) == set(range(4))
        assert all(r.weight_version == 1 for r in res.values())
    recs = read_ledger(str(tmp_path / "coordinator.jsonl"))
    assert [r["version"] for r in recs if r["kind"] == "rollout"] == [1]


STATE_LOST_PLAN = FaultPlan(events=(
    FaultEvent(kind="worker_kill", engine=1, first_chunk=2, last_chunk=2,
               state_lost=True),))


def test_state_lost_kill_records_fault_records(tmp_path):
    """A kill that also destroys the replica checkpoint surfaces every
    lost window as FaultRecord("state_lost") — never a silent drop."""
    with make_co(tmp_path, plan=STATE_LOST_PLAN) as co:
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        co.run()
        _partition_ok(co, range(len(IMGS)))
        assert co.faulted, "worker 1 had in-flight lanes at round 2"
        assert all(f.reason == "state_lost" and f.replay_seed == rid
                   for rid, f in co.faulted.items())
        _assert_matches_baseline(co)


def test_replay_reproduces_every_record_exactly(tmp_path):
    """Same plan, same submissions, fresh cluster: identical results,
    FaultRecords and routing stats."""
    runs = []
    for sub in ("a", "b"):
        d = tmp_path / sub
        d.mkdir()
        with make_co(d, plan=STATE_LOST_PLAN) as co:
            for i, im in enumerate(IMGS):
                co.submit(im, request_id=i)
            co.run()
            runs.append(({r: as_tuple(v) for r, v in co.results.items()},
                         dict(co.faulted), dict(co.shed), co.stats))
    assert runs[0] == runs[1]
