"""The port's CUDA stack kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc; without a card they skip
(decided inside the fixture, so every worker collects the same tests).
Run them on a machine with a card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  Every comparison is integer equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import snn_mnist as cfgs
from repro_torch.core.prng import seed_state
from repro_torch.kernels import fused_snn, ops
from repro_torch.serve import SNNStreamEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [] if x is None else [x]


def _assert_equal(got, want, what):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, i)


def _problem(cfg, b, dev, seed):
    rng = np.random.default_rng(seed)
    sizes = cfg.layer_sizes
    ws = tuple(torch.from_numpy(np.clip(np.round(rng.normal(6, 40, (i, o))),
                                        -256, 255).astype(np.int16)).to(dev)
               for i, o in zip(sizes[:-1], sizes[1:]))
    px = rng.integers(0, 256, (b, sizes[0]), dtype=np.uint8)
    px[:, : sizes[0] // 3] = 0
    return (torch.from_numpy(px).to(dev),
            seed_state(seed, (b, sizes[0]), device=dev), ws)


_CASES = [(name, readout, gated, ss)
          for name, readout in [("SNN_CONFIG", "count"),
                                ("SNN_CONFIG_PRUNED", "first_spike"),
                                ("SNN_CONFIG_DEEP", "count"),
                                ("SNN_CONFIG", "membrane")]
          for gated in (False, True) for ss in (True, False)]


@pytest.mark.parametrize("name,readout,gated,sparse_skip", _CASES)
def test_kernel_equals_plain_chunked(card, name, readout, gated,
                                     sparse_skip):
    cfg = dataclasses.replace(getattr(cfgs, name), readout=readout)
    b = 61
    px, st, ws = _problem(cfg, b, card, seed=len(name))
    lif = cfg.lif
    kw = dict(window_steps=cfg.num_steps, decay_shift=lif.decay_shift,
              v_threshold=lif.v_threshold, v_rest=lif.v_rest,
              v_min=lif.v_min, v_max=lif.v_max,
              active_pruning=cfg.active_pruning, patience=2,
              readout=readout, sparse_skip=sparse_skip)
    gate = None
    if gated:
        act = torch.ones(b, dtype=torch.bool, device=card)
        act[::7] = False
        gate = {"active": act,
                "prev": torch.full((b,), -1, dtype=torch.int32, device=card),
                "streak": torch.zeros(b, dtype=torch.int32, device=card)}
    init = None
    for _ in range(cfg.num_steps // 4):
        args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                        v_rest=lif.v_rest, init=init,
                                        gate=gate)
        before = fused_snn.fused_snn_stack.launches
        got = fused_snn.fused_snn_stack(*args, chunk_steps=4,
                                        block_b=meta["block_b"], **kw)
        torch.cuda.synchronize()
        assert fused_snn.fused_snn_stack.launches == before + 1
        want = fused_snn.fused_snn_stack_plain(*args, chunk_steps=4,
                                               block_b=meta["block_b"], **kw)
        _assert_equal(got, want, name)
        res = ops.stack_results(got, meta)
        st = res["prng_state"]
        init = {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
                "counts": res["spike_counts"], "first": res["first_spike_t"],
                "steps": res["steps"]}
        gate = res.get("gate")


def test_kernel_refuses_bad_operands(card):
    cfg = cfgs.SNN_CONFIG
    px, st, ws = _problem(cfg, 8, card, seed=1)
    args, meta = ops.stack_operands(px, st, ws, num_steps=20)
    kw = dict(chunk_steps=2, window_steps=20, decay_shift=4, v_threshold=128,
              block_b=meta["block_b"])
    bad = list(args)
    bad[0] = args[0][:, :500].contiguous()
    with pytest.raises(ValueError):
        fused_snn.fused_snn_stack(*bad, **kw)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        fused_snn.fused_snn_stack(*bad, **kw)


def test_engine_fused_equals_reference_on_card(card):
    rng = np.random.default_rng(4)
    cfg = cfgs.SNN_CONFIG_PRUNED
    p = {"layers": [{"w_q": np.clip(np.round(rng.normal(6, 40, (784, 10))),
                                    -256, 255).astype(np.int16)}]}
    imgs = rng.integers(0, 256, (40, 784), dtype=np.uint8)
    res = {}
    for backend in ("fused", "reference"):
        eng = SNNStreamEngine(p, cfg, batch_size=16, chunk_steps=4,
                              patience=2, seed=3, backend=backend)
        for im in imgs:
            eng.submit(im)
        before = fused_snn.fused_snn_stack.launches
        res[backend] = eng.run()
        launched = fused_snn.fused_snn_stack.launches - before
        assert launched == (eng.dispatches if backend == "fused" else 0)
    assert sorted(res["fused"]) == list(range(40))
    for rid, r in res["reference"].items():
        f = res["fused"][rid]
        assert (f.pred, f.steps, f.adds, f.early_exit) == \
            (r.pred, r.steps, r.adds, r.early_exit)
        np.testing.assert_array_equal(f.spike_counts, r.spike_counts)
