"""The port's cluster against the JAX package's, across processes.

A coordinator of either package that dies by ``coordinator_kill`` is
recovered by the other package's ``ClusterCoordinator.recover`` on the
same ``ledger_dir``, which finishes every outstanding id with results
equal to the JAX no-fault baseline.  Lane rows a JAX engine checkpoints
mid-window, encoded by the JAX wire codec, go through the port
coordinator's ``adopt`` RPC into a port worker process and finish
bit-identically.  The port spawns its own workers, and a worker with no
card never serves on the CPU by itself.
"""

import dataclasses
import json
import os
import subprocess

import pytest

import repro.serve as jserve
import repro.serve.wire as jwire
from repro_torch.serve import ClusterCoordinator, CoordinatorCrash
from repro_torch.serve import cluster as tcluster
from test_torch_cluster_common import (CFG, IMGS, KW, PARAMS,  # noqa: F401
                                       _assert_matches_baseline,
                                       _partition_ok, _worker_env, as_tuple,
                                       baseline)
from test_torch_tier_common import JAX

CONTRACT_PLAN = "seed=0,worker_kill=1@2,coordinator_kill=4"
JCFG = dataclasses.replace(JAX.cfgs.SNN_CONFIG, layer_sizes=CFG.layer_sizes,
                           num_steps=CFG.num_steps)
JKW = {k: v for k, v in KW.items() if k != "device"}


def _crash(co):
    try:
        for i, im in enumerate(IMGS):
            co.submit(im, request_id=i)
        with pytest.raises(CoordinatorCrash if isinstance(
                co, ClusterCoordinator) else jserve.CoordinatorCrash):
            co.run()
        assert co.stats["workers_failed"] >= 1
    finally:
        co.close()


def _finish(co):
    with co:
        co.run()
        _partition_ok(co, range(len(IMGS)))
        assert not co.faulted and not co.shed
        _assert_matches_baseline(co)


def test_port_recovers_a_jax_coordinator(tmp_path):
    _crash(jserve.ClusterCoordinator(
        JAX.params(PARAMS), JCFG, backend="reference",
        fault_plan=CONTRACT_PLAN, ledger_dir=str(tmp_path), **JKW))
    _finish(ClusterCoordinator.recover(
        PARAMS, CFG, ledger_dir=str(tmp_path), backend="fused",
        fault_plan=CONTRACT_PLAN, **KW))


def test_jax_recovers_a_port_coordinator(tmp_path):
    _crash(ClusterCoordinator(
        PARAMS, CFG, backend="fused", fault_plan=CONTRACT_PLAN,
        ledger_dir=str(tmp_path), **KW))
    _finish(jserve.ClusterCoordinator.recover(
        JAX.params(PARAMS), JCFG, ledger_dir=str(tmp_path),
        backend="reference", fault_plan=CONTRACT_PLAN, **JKW))


def test_jax_checkpoint_rows_adopted_by_a_port_worker(tmp_path):
    """A JAX engine's mid-window rows, as JAX's ``lane_to_wire`` writes
    them, are adopted over the port coordinator's RPC (``ensure_version``
    where needed, then ``adopt``) by a port worker process and finish
    bit-identically."""
    jeng = JAX.serve.SNNStreamEngine(
        JAX.params(PARAMS), JCFG, batch_size=4, chunk_steps=2,
        patience=10_000, seed=0, backend="reference")
    for i, im in enumerate(IMGS[:6]):
        jeng.submit(im, request_id=i)
    jeng.step()
    jeng.step()
    rows = [(rid, json.loads(json.dumps(jwire.lane_to_wire(row))))
            for rid, row in jeng.checkpoint_lanes()]
    assert len(rows) == 4
    finished = jeng.run()
    want = {rid: as_tuple(finished[rid]) for rid, _ in rows}
    assert want == {rid: baseline()[rid] for rid, _ in rows}
    with ClusterCoordinator(PARAMS, CFG, num_workers=1, lanes_per_worker=4,
                            chunk_steps=3, patience=10_000, seed=0,
                            backend="fused", device="cpu",
                            ledger_dir=str(tmp_path)) as co:
        for rid, row in rows:
            co._order.append(rid)
            co._submitted.add(rid)
            co._evacuate(rid, row, None, "rows of a JAX engine", co.round)
        assert co.stats["evacuated"] == len(rows)
        res = co.run()
    assert {rid: as_tuple(r) for rid, r in res.items()} == want


def test_spawn_command_names_the_port(tmp_path, monkeypatch):
    """Workers start as ``python -c`` importing
    ``repro_torch.serve.cluster._worker_main``, with the checkout's
    ``src`` first on their path and no fault plan in their environment
    (the coordinator ships the plan over RPC)."""
    calls = []
    popen = subprocess.Popen

    def record(args, **kw):
        calls.append((args, kw["env"]))
        return popen(args, **kw)

    monkeypatch.setattr(tcluster.subprocess, "Popen", record)
    monkeypatch.setenv("REPRO_FAULT_PLAN", "seed=1,dispatch=0.5")
    with ClusterCoordinator(PARAMS, CFG, num_workers=1, lanes_per_worker=2,
                            chunk_steps=2, backend="reference",
                            device="cpu", ledger_dir=str(tmp_path)) as co:
        assert co.workers[0].alive and co.workers[0].backend == "reference"
    (args, env), = calls
    assert args[1] == "-c"
    assert "from repro_torch.serve.cluster import _worker_main" in args[2]
    assert "repro.serve" not in args[2]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(tcluster.__file__))))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == src
    assert "REPRO_FAULT_PLAN" not in env


def test_no_worker_serves_on_the_cpu_without_a_card(tmp_path, monkeypatch):
    """``device=None`` is the card: a worker that sees none fails ``init``
    with the port's no-CUDA error and its slot stays dead, so a request
    is dropped as a fault record instead of being served on the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with ClusterCoordinator(PARAMS, CFG, num_workers=2, lanes_per_worker=2,
                            chunk_steps=2, backend=None,
                            ledger_dir=str(tmp_path)) as co:
        assert co.device is None
        assert [h.alive for h in co.workers] == [False, False]
        assert all("no CUDA device" in h.error for h in co.workers)
        co.submit(IMGS[0], request_id=0)
        assert co.run() == {}
        assert co.faulted[0].reason == "no_capacity"
