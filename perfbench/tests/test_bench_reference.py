"""The benchmark's frozen reference against the port at a tiny size, bit
for bit: the lane seeding (per seed, and a whole call's lanes from one
seed as the bulk caller seeds them) and the whole-window
``snn_apply_int`` (prediction, spike counts, first-spike times, final
membranes, final lanes), on the port's ``reference`` backend and on its
stack kernels' plain versions.  The test imports the port; the
reference does not."""

import copy

import numpy as np
import pytest
import torch

from perfbench.entries import _snn
from perfbench.reference import snn as ref
from perfbench.traffic.digits import render_pool

CFG = {"layer_sizes": [784, 10], "num_steps": 20,
       "lif": {"decay_shift": 4, "v_threshold": 128, "v_rest": 0,
               "v_min": -1048576, "v_max": 1048575},
       "code_range": [-256, 255], "readout": "count",
       "active_pruning": False, "sparse_skip": True,
       "weights": {"init": "normal", "std": 24.0, "base_seed": 0}}
DEEP = dict(CFG, layer_sizes=[784, 48, 32, 10],
            weights={"init": "normal_fan_in", "scale": 170.0,
                     "base_seed": 0})
SEED = 2**31 + 12345


def _variants():
    out = [("count", CFG), ("wide", DEEP)]
    for readout, prune in (("first_spike", True), ("membrane", False)):
        c = copy.deepcopy(CFG)
        c.update(readout=readout, active_pruning=prune)
        out.append((readout, c))
    return out


VARIANTS = _variants()


def test_seed_states_equal_the_port():
    from repro_torch.core import prng
    seeds = [0, 1, 77, 2**31 - 1, 2**31 + 5, 2**32 + 9]
    got = ref.seed_states(torch.tensor(seeds, dtype=torch.int64), 784)
    for row, s in zip(got, seeds):
        want = prng.seed_state(s, (784,), device="cpu")
        assert torch.equal(row.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("steps", [0, 1, 20, 20 * 37 + 3])
def test_advance_equals_stepping(steps):
    from repro_torch.core import prng
    lanes = prng.seed_state(SEED, (3, 784), device="cpu")
    want = lanes
    for _ in range(steps):
        want = prng.xorshift32_step(want)
    got = ref.advance(lanes, steps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_carried_lanes_equal_the_reference(backend):
    """Three calls of ``snn_apply_int``, each on the lanes the one before
    returned, as the batch entry makes them, against the reference's own
    preload advanced ``num_steps`` a call."""
    from repro_torch.core import prng
    from repro_torch.core.snn import snn_apply_int
    codes = _snn.make_codes(DEEP, SEED, "cpu")
    pool = torch.from_numpy(render_pool(SEED, 12))
    params = {"layers": [{"w_q": w} for w in codes]}
    lanes = prng.seed_state(SEED, (4, 784), device="cpu")
    want_lanes = ref.seed_states(torch.tensor([SEED]), 4 * 784).reshape(4,
                                                                      784)
    for c in range(3):
        px = pool[4 * c:4 * c + 4]
        got = snn_apply_int(params, px, lanes, _snn.program_config(DEEP),
                            backend=backend)
        want = ref.window(px, ref.advance(want_lanes, 20 * c),
                          [w.to(torch.int32) for w in codes], DEEP)
        assert torch.equal(got["spike_counts"], want["counts"])
        assert torch.equal(got["prng_state"].view(torch.int32),
                           want["lanes"].view(torch.int32))
        lanes = got["prng_state"]


def test_8bit_codes_drop_the_low_bit():
    w = torch.tensor([-256, -255, -3, -1, 0, 1, 2, 3, 254, 255])
    assert ref.to_8bit_codes(w).tolist() == [-256, -256, -4, -2, 0, 0, 2,
                                             2, 254, 254]


@pytest.mark.parametrize("batch", [1, 3, 500])
def test_call_lanes_equal_the_port(batch):
    from repro_torch.core import prng
    seed = SEED + 7 * batch
    got = ref.seed_states(torch.tensor([seed], dtype=torch.int64),
                          batch * 784).reshape(batch, 784)
    want = prng.seed_state(seed, (batch, 784), device="cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("name,cfg", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_snn_apply_int_equals_the_reference(name, cfg, backend):
    from repro_torch.core.snn import snn_apply_int
    codes = _snn.make_codes(cfg, SEED + 1, "cpu")
    pool = render_pool(SEED, 9)
    ids = torch.arange(9, dtype=torch.int64)
    px = torch.from_numpy(pool)
    lanes = ref.seed_states(SEED + ids, 784)
    got = snn_apply_int({"layers": [{"w_q": w} for w in codes]}, px, lanes,
                        _snn.program_config(cfg), backend=backend)
    want = ref.window(px, lanes, [w.to(torch.int32) for w in codes], cfg)
    assert torch.equal(got["pred"], want["pred"])
    assert torch.equal(got["spike_counts"], want["counts"])
    assert torch.equal(got["first_spike_t"], want["first"])
    assert torch.equal(got["v_final"], want["v_last"])
    assert torch.equal(got["prng_state"].view(torch.int32),
                       want["lanes"].view(torch.int32))
    # the control's codes change the answers
    low = ref.window(px, lanes, [ref.to_8bit_codes(w) for w in codes], cfg)
    assert not torch.equal(low["counts"], want["counts"])


def test_every_seed_runs_the_same_network_relabelled():
    """Two seeds' weights, their input rows put back in one order, give
    the same answers on the same inputs: the hidden neurons are only
    relabelled.  (Relabelling the inputs, as the pool's pixels are,
    changes which xorshift lane meets which pixel: the answers change, the
    work's distribution does not.)"""
    pool = render_pool(SEED, 6)
    ids = torch.arange(6, dtype=torch.int64)
    px, lanes = torch.from_numpy(pool), ref.seed_states(SEED + ids, 784)
    runs = []
    for seed in (5, 6):
        codes = _snn.make_codes(DEEP, seed, "cpu")
        back = torch.from_numpy(np.argsort(_snn.relabelling(DEEP, seed)[0]))
        w = [codes[0][back]] + list(codes[1:])
        runs.append((codes, ref.window(px, lanes, [c.to(torch.int32)
                                                  for c in w], DEEP)))
    (a, ra), (b, rb) = runs
    assert not all(torch.equal(x, y) for x, y in zip(a, b))
    for k in ("pred", "counts", "first", "lanes"):
        assert torch.equal(ra[k], rb[k]), k


def test_pool_is_one_set_in_an_order_from_the_seed():
    tr = {"pool": 8, "pool_seed": 3}
    a, b = _snn.make_pool(CFG, tr, 1), _snn.make_pool(CFG, tr, 2)
    assert not np.array_equal(a, b)
    unlabel = [p[:, np.argsort(_snn.relabelling(CFG, s)[0])]
               for p, s in ((a, 1), (b, 2))]
    assert np.array_equal(np.sort(unlabel[0], axis=0),
                          np.sort(unlabel[1], axis=0))
    assert np.array_equal(a, _snn.make_pool(CFG, tr, 1))
