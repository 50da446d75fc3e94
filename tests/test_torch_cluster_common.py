"""Shared helpers of the port's cluster tests (this file holds no test):
the JAX cluster tests' sizes, the port coordinator on the CPU, and the
JAX package's no-fault single-engine baseline every run is held to.

Each worker is a fresh interpreter that imports torch; ``OMP_NUM_THREADS``
is 1 so that workers running beside other tests do not oversubscribe the
cores, and the cold-start RPC timeout is lowered so a broken worker fails
its test instead of the run."""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs.snn_mnist import SNN_CONFIG
from repro_torch.serve import ClusterCoordinator
from repro_torch.serve import cluster as tcluster
from test_torch_tier_common import JAX, small_net

_RNG = np.random.default_rng(17)
CFG = dataclasses.replace(SNN_CONFIG, layer_sizes=(12, 6), num_steps=8)
PARAMS = small_net(_RNG, CFG.layer_sizes)
IMGS = _RNG.integers(0, 256, (10, 12), dtype=np.uint8)
KW = dict(num_workers=2, lanes_per_worker=2, chunk_steps=2,
          patience=10_000, seed=0, device="cpu")

_BASELINE: dict = {}


@pytest.fixture(autouse=True)
def _worker_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    monkeypatch.delenv("REPRO_DISPATCH_CACHE", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tcluster, "_RPC_LONG_TIMEOUT_S", 60.0)


def as_tuple(r):
    return (int(r.pred), int(r.steps), int(r.adds), bool(r.early_exit),
            np.asarray(r.spike_counts).tolist())


def baseline():
    """The JAX package's no-fault single-engine signatures."""
    if not _BASELINE:
        cfg = dataclasses.replace(JAX.cfgs.SNN_CONFIG,
                                  layer_sizes=CFG.layer_sizes,
                                  num_steps=CFG.num_steps)
        eng = JAX.serve.SNNStreamEngine(
            JAX.params(PARAMS), cfg, batch_size=2, chunk_steps=2,
            patience=10_000, seed=0, backend="reference")
        for i, im in enumerate(IMGS):
            eng.submit(im, request_id=i)
        _BASELINE.update({r: as_tuple(v) for r, v in eng.run().items()})
    return _BASELINE


def make_co(ledger_dir, backend="reference", plan=None, fault_cfg=None):
    return ClusterCoordinator(PARAMS, CFG, backend=backend, fault_plan=plan,
                              fault_cfg=fault_cfg, ledger_dir=str(ledger_dir),
                              **KW)


def _partition_ok(co, submitted):
    res, shed, faulted = set(co.results), set(co.shed), set(co.faulted)
    assert res | shed | faulted == set(submitted)
    assert not (res & shed) and not (res & faulted) and not (shed & faulted)


def _assert_matches_baseline(co):
    base = baseline()
    assert set(co.results) == set(base) - set(co.faulted) - set(co.shed)
    for rid, r in co.results.items():
        assert as_tuple(r) == base[rid], rid


def _dead_slot(self, idx, incarnation=0):
    return tcluster.WorkerHandle(proc=None, rfd=-1, wfd=-1, alive=False)
