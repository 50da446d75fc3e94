"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 and K2 (the resident and the weight-streaming stack kernels), K3 (the
partial contraction of a model shard), K4 (the encoder), K5 (the LIF
layer) and K6 (the spike matmul), and the backends and engines built on
them.  Every
test here needs an NVIDIA GPU and nvcc; without a card they skip (decided
inside the fixture, so every worker collects the same tests).  Run them on
a machine with a card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  Every comparison is integer equality.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import snn_mnist as cfgs
from repro_torch.core import snn
from repro_torch.core.prng import seed_state
from repro_torch.kernels import (fused_snn, lif_step, ops, poisson_encode,
                                 spike_matmul)
from repro_torch.serve import SNNStreamEngine

pytestmark = pytest.mark.cuda

# chip_smoke.py's K2 edge cases (K2_CASES, k2_edge_case) run here too
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


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


def _problem(cfg, b, dev, seed, fan_in_scale=None):
    """Seeded pixels, PRNG state and codes; ``fan_in_scale`` draws the
    codes from normal(0, scale / sqrt(fan-in)) (for the wide stack)."""
    rng = np.random.default_rng(seed)
    sizes = cfg.layer_sizes

    def code(i, o):
        mean, std = (6, 40) if fan_in_scale is None else \
            (0, fan_in_scale / np.sqrt(i))
        return np.clip(np.round(rng.normal(mean, std, (i, o))), -256, 255)

    ws = tuple(torch.from_numpy(code(i, o).astype(np.int16)).to(dev)
               for i, o in zip(sizes[:-1], sizes[1:]))
    px = rng.integers(0, 256, (b, sizes[0]), dtype=np.uint8)
    px[:, : sizes[0] // 3] = 0
    return (torch.from_numpy(px).to(dev),
            seed_state(seed, (b, sizes[0]), device=dev), ws)


_CASES = [(name, readout, gated, ss, None)
          for name, readout in [("SNN_CONFIG", "count"),
                                ("SNN_CONFIG_PRUNED", "first_spike"),
                                ("SNN_CONFIG_DEEP", "count"),
                                ("SNN_CONFIG", "membrane")]
          for gated in (False, True) for ss in (True, False)]
# chip_smoke.K1_CASES: ragged widths (k0 of 100, 64, 208, 1,040 and
# 3,072; layers of 37, 130 and 300 columns; heads of 10 and 7), 24, 200
# and 1,021 lanes, frozen lanes with sparse_skip on, the widest
# one-hidden-layer stacks of the earlier and the present shared-memory
# layouts, and codes in ±2,000
_CASES += [(None, None, None, None, i)
           for i in range(len(chip_smoke.K1_CASES))]


def _check_chunks(card, kernel, cfg, px, st, ws, readout, gated,
                  sparse_skip):
    """Five gated or ungated 4-step launches of ``kernel``, each equal to
    the plain version on the same operands."""
    b = px.shape[0]
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
    streamed = kernel is fused_snn.fused_snn_stack_streamed
    for _ in range(cfg.num_steps // 4):
        args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                        v_rest=lif.v_rest, init=init,
                                        gate=gate, streamed=streamed)
        before = kernel.launches
        got = kernel(*args, chunk_steps=4, block_b=meta["block_b"], **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = fused_snn.fused_snn_stack_plain(*args, chunk_steps=4,
                                               block_b=meta["block_b"], **kw)
        _assert_equal(got, want, cfg.layer_sizes)
        res = ops.stack_results(got, meta)
        st = res["prng_state"]
        init = {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
                "counts": res["spike_counts"], "first": res["first_spike_t"],
                "steps": res["steps"]}
        gate = res.get("gate")


@pytest.mark.parametrize("name,readout,gated,sparse_skip,edge", _CASES)
def test_kernel_equals_plain_chunked(card, name, readout, gated,
                                     sparse_skip, edge):
    if edge is not None:
        case = chip_smoke.K1_CASES[edge]
        assert chip_smoke.k1_edge_case(card, case, seed=70 + edge) > 0
        return
    cfg = dataclasses.replace(getattr(cfgs, name), readout=readout)
    px, st, ws = _problem(cfg, 61, card, seed=len(name))
    _check_chunks(card, fused_snn.fused_snn_stack, cfg, px, st, ws, readout,
                  gated, sparse_skip)


@pytest.mark.parametrize("name,readout,prune,scale,gated,sparse_skip", [
    ("SNN_CONFIG_WIDE", "count", False, 170, False, True),
    ("SNN_CONFIG_WIDE", "first_spike", True, 350, True, False),
    ("SNN_CONFIG_DEEP", "count", False, None, True, True),
    ("SNN_CONFIG", "membrane", False, None, False, False),
])
def test_streamed_kernel_equals_plain_chunked(card, name, readout, prune,
                                              scale, gated, sparse_skip):
    cfg = dataclasses.replace(getattr(cfgs, name), readout=readout,
                              active_pruning=prune)
    px, st, ws = _problem(cfg, 37, card, seed=len(name) + 1,
                          fan_in_scale=scale)
    _check_chunks(card, fused_snn.fused_snn_stack_streamed, cfg, px, st, ws,
                  readout, gated, sparse_skip)


def test_streamed_kernel_equals_resident(card):
    """K2 on padded operands and K1 at the real widths give the same
    results once the op cuts K2's padding off."""
    cfg = cfgs.SNN_CONFIG_DEEP
    px, st, ws = _problem(cfg, 45, card, seed=2)
    args, meta = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps)
    planes, _ = ops.stack_operands(px, st, ws, num_steps=cfg.num_steps,
                                   streamed=True)
    kw = dict(chunk_steps=20, window_steps=20, decay_shift=4,
              v_threshold=128, active_pruning=True, block_b=meta["block_b"])
    k2 = ops.stack_results(fused_snn.fused_snn_stack_streamed(*planes, **kw),
                           meta)
    k1 = ops.stack_results(fused_snn.fused_snn_stack(*args, **kw), meta)
    assert k2.keys() == k1.keys()
    for key in k1:
        _assert_equal(k2[key], k1[key], f"K2 vs K1: {key}")


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("case", chip_smoke.K2_CASES, ids=lambda c: "-".join(
    [str(c[0]), "x".join(map(str, c[1]))] + list(c[2:4]) + [str(c[4])]))
def test_streamed_kernel_edge_cases(card, case, gated):
    """K2 on planes placed once against the plain version on the codes, two
    4-step chunks from a carried state whose enables may be dead in whole
    tiles, every output equal (``chip_smoke.k2_edge_case``)."""
    assert chip_smoke.k2_edge_case(card, case, gated, seed=case[0]) > 0


def test_streamed_kernel_refuses_misaligned_weights(card):
    cfg = cfgs.SNN_CONFIG
    px, st, ws = _problem(cfg, 8, card, seed=3)
    args, meta = ops.stack_operands(px, st, ws, num_steps=20, streamed=True)
    w = args[2][0]
    flat = torch.empty(w.numel() + 1, dtype=torch.int8, device=card)
    shifted = flat[1:].view(w.shape)          # contiguous, 1-byte offset
    shifted.copy_(w)
    bad = list(args)
    bad[2] = (shifted,)
    before = fused_snn.fused_snn_stack_streamed.launches
    with pytest.raises(ValueError, match="16-byte"):
        fused_snn.fused_snn_stack_streamed(*bad, chunk_steps=2,
                                           window_steps=20, decay_shift=4,
                                           v_threshold=128,
                                           block_b=meta["block_b"])
    assert fused_snn.fused_snn_stack_streamed.launches == before


@pytest.mark.parametrize("b,n,t", [(13, 200, 7), (8, 784, 20)])
def test_encoder_kernel_equals_plain(card, b, n, t):
    rng = np.random.default_rng(b)
    px = torch.from_numpy(rng.integers(0, 256, (b, n), dtype=np.uint8)) \
        .to(card)
    st = seed_state(b, (b, n), device=card)
    before = poisson_encode.poisson_encode.launches
    got = ops.poisson_encode_op(px, st, t)
    torch.cuda.synchronize()
    assert poisson_encode.poisson_encode.launches == before + 1
    _assert_equal(got, poisson_encode.poisson_encode_plain(px, st, t), "K4")


# chip_smoke.K5_CASES (spike bytes 0/1/2/255, int16 extremes in every
# column, 1,021 / 1,000 / 24 lanes, K = 784 and 64, N = 10 padded to 128,
# T = 1 and 20, pruning, K splits of 1, 4 and 8, the 2^31 wrap), then the
# earlier cases: 16 lanes, K = 200 (padded to 208), codes of 9 bits and
# ±2000.
_K5_CASES = chip_smoke.K5_CASES + [
    (6, 16, 200, 256, 0.5, "0/1", codes, prune)
    for codes in ("9-bit", "±2000") for prune in (False, True)]


@pytest.mark.parametrize("i", range(len(_K5_CASES)))
def test_lif_kernel_equals_plain(card, i):
    """K5 on the int8 tensor cores equals the plain version bit for bit on
    spikes, trace and final membrane, one launch per call, and fires."""
    assert chip_smoke.k5_case(card, _K5_CASES[i], seed=100 + i) > 0


def test_lif_kernel_refuses_bad_operands(card):
    """The kernel copies 16-byte pieces of spike rows: K not a multiple of
    16 and a view off a 16-byte boundary are refused before the launch;
    nothing is counted."""
    kw = dict(decay_shift=4, v_threshold=128)
    w = torch.zeros((200, 128), dtype=torch.int16, device=card)
    buf = torch.zeros(2 * 8 * 208 + 16, dtype=torch.uint8, device=card)
    before = lif_step.lif_forward.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        lif_step.lif_forward(torch.zeros((2, 8, 200), dtype=torch.uint8,
                                         device=card), w, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        lif_step.lif_forward(buf[8:8 + 2 * 8 * 208].view(2, 8, 208),
                             torch.zeros((208, 128), dtype=torch.int16,
                                         device=card), **kw)
    assert lif_step.lif_forward.launches == before


@pytest.mark.parametrize("b,n,t", [(16, 208, 7), (8, 784, 20),
                                   (24, 4112, 3), (13, 100, 70)])
def test_encoder_tallies_equal_plain(card, b, n, t):
    """K4 adds the plain version's spike counts and live tiles into layer
    0 of zeroed tallies, beside its train and state: 4,112 pixels are 33
    tiles; 70 steps are three groups of 32, the last ragged; 13 lanes
    leave part of a block."""
    rng = np.random.default_rng(b + n)
    px = torch.from_numpy(rng.integers(0, 256, (b, n), dtype=np.uint8)) \
        .to(card)
    st = seed_state(b, (b, n), device=card)
    tal = ops.staged_tallies(t, 2, b, card)
    before = poisson_encode.poisson_encode.launches
    got = poisson_encode.poisson_encode(px, st, t, tal)
    torch.cuda.synchronize()
    assert poisson_encode.poisson_encode.launches == before + 1
    want = ops.staged_tallies(t, 2, b, "cpu")
    plain = poisson_encode.poisson_encode(px.cpu(), st.cpu(), t, want)
    _assert_equal(got, tuple(x.to(card) for x in plain), "K4")
    for f in want._fields:
        _assert_equal(getattr(tal, f), getattr(want, f).to(card), f)
    assert int(tal.n_spk.sum()) > 0 and int(tal.live_k.sum()) > 0


# (T, lanes, valid lanes, K, N, valid columns, pruning, last layer,
# threshold): padding that fires (threshold -1) is left out of the
# tallies; K = 1,024 over one tile splits over 4, K = 16,384 over 8
_K5_READOUT = [(6, 16, 13, 208, 256, 200, False, False, -1),
               (6, 16, 13, 208, 256, 200, True, True, -1),
               (3, 264, 260, 784, 384, 300, True, True, 128),
               (5, 8, 8, 1024, 128, 100, True, False, -1),
               (5, 24, 21, 16384, 128, 10, False, True, 128),
               (5, 24, 21, 16384, 128, 10, True, False, -1)]


@pytest.mark.parametrize("case", _K5_READOUT, ids=lambda c: "-".join(
    map(str, c)))
def test_lif_readout_kernel_equals_plain(card, case):
    """K5's readout launch equals its plain twin: spikes, peaks, the last
    layer's trace, final membrane, counts and first spikes, and every
    tally added into zeroed views, at K splits of 1, 4 and 8."""
    T, B, bv, K, N, nv, prune, last, th = case
    rng = np.random.default_rng(K + N + T)
    spikes = torch.from_numpy(
        (rng.random((T, B, K)) < 0.3).astype(np.uint8)).to(card)
    hi = 4 if K > 4096 else 120
    w = torch.from_numpy(rng.integers(-hi // 3, hi, (K, N))
                         .astype(np.int16)).to(card)
    kw = dict(decay_shift=4, v_threshold=th, active_pruning=prune)
    tal = ops.staged_tallies(T, 2, B, card)
    layer = 1 if last else 0
    views = dict(n_spk=tal.n_spk[:, 1], live_k=tal.live_k[:, 1],
                 n_en=tal.n_en[:, layer], live_n=tal.live_n[:, layer])
    before = lif_step.lif_forward_readout.launches
    got = lif_step.lif_forward_readout(spikes, w, tal, layer=layer,
                                       b_valid=bv, n_valid=nv, **kw)
    torch.cuda.synchronize()
    assert lif_step.lif_forward_readout.launches == before + 1
    want = lif_step.lif_forward_readout_plain(spikes, w, b_valid=bv,
                                              n_valid=nv, last=last, **kw)
    keys = ("spikes", "v_peak") + (("v_trace", "v_final") if last else ())
    assert sorted(got) == sorted(keys + (("counts", "first") if last
                                         else ()))
    for key in keys:
        _assert_equal(got[key], want[key], key)
    if last:
        for key in ("counts", "first"):
            _assert_equal(got[key][:, :nv], want[key][:, :nv], key)
    for key, view in views.items():
        if (key == "n_en" and not prune) or (key in ("n_spk", "live_k")
                                             and last):
            assert not view.any(), key
        else:
            _assert_equal(view, want[key], key)
    assert int(want["n_spk"].sum()) > 0


def _readout_launches():
    return (poisson_encode.poisson_encode.launches,
            lif_step.lif_forward_readout.launches,
            lif_step.lif_forward.launches)


_STAGED_KEYS = ("pred", "spike_counts", "v_trace", "first_spike_t",
                "v_final", "active_adds", "prng_state", "v_peak",
                "telemetry")


def test_staged_backend_equals_reference_on_card(card):
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, readout="first_spike",
                              active_pruning=True)
    px, st, ws = _problem(cfg, 21, card, seed=5)
    p = {"layers": [{"w_q": w} for w in ws]}
    before = _readout_launches()
    got = snn.snn_apply_int(p, px, st, cfg, backend="staged")
    assert _readout_launches() == (before[0] + 1, before[1] + 3) + before[2:]
    want = snn.snn_apply_int(p, px, st, cfg, backend="reference")
    for key in _STAGED_KEYS:
        _assert_equal(got[key], want[key], key)


# (layer sizes, lanes, steps): the wide stack at 1,000 lanes, a ragged one
# (13 lanes, 200 inputs, 96 hidden), and a head the kernel splits over K
_STAGED_CARD = {"wide": ((784, 2048, 2048, 10), 1000, 20),
                "ragged": ((200, 256, 96, 10), 13, 7),
                "split-head": ((784, 16384, 10), 24, 20)}


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("name", list(_STAGED_CARD))
def test_staged_readouts_equal_reference_on_card(card, name, prune):
    """Every field of a staged call, the telemetry and every layer's peak
    included, equals the reference backend's: the readout launches' tallies
    equal ``_derive_stack_telemetry`` on the reference's trains."""
    sizes, b, t = _STAGED_CARD[name]
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=sizes,
                              num_steps=t, active_pruning=prune,
                              sparse_skip=True)
    px, st, ws = _problem(cfg, b, card, seed=len(name) + t,
                          fan_in_scale=170)
    p = {"layers": [{"w_q": w} for w in ws]}
    before = _readout_launches()
    got = snn.snn_apply_int(p, px, st, cfg, backend="staged")
    assert _readout_launches() == (before[0] + 1,
                                   before[1] + len(sizes) - 1) + before[2:]
    want = snn.snn_apply_int(p, px, st, cfg, backend="reference")
    for key in _STAGED_KEYS:
        _assert_equal(got[key], want[key], key)
    _assert_equal(got["input_spikes"], want["input_spikes"].to(torch.uint8),
                  "input_spikes")
    assert int(got["telemetry"].n_spk[:, -1].sum()) > 0   # the head's input


def test_staged_call_moves_no_train_outside_the_kernels(card):
    """Under ``torch.profiler`` a staged call at 784 -> 2048 -> 2048 -> 10
    runs K4 once and K5 three times, and no PyTorch kernel or copy has an
    operand of T * B * 2048 or T * B * 784 elements."""
    cfg = cfgs.SNN_CONFIG_WIDE
    T, B = cfg.num_steps, 1000
    px, st, ws = _problem(cfg, B, card, seed=12, fan_in_scale=170)
    p = {"layers": [{"w_q": w} for w in ws]}
    snn.snn_apply_int(p, px, st, cfg, backend="staged")      # builds
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA],
                                record_shapes=True) as prof:
        snn.snn_apply_int(p, px, st, cfg, backend="staged")
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events if e.device_type.name == "CUDA"]
    assert sum("poisson_encode_kernel" in n for n in names) == 1
    assert sum("lif_forward_kernel" in n for n in names) == 3
    launched = [e for e in events
                if e.device_type.name == "CPU" and e.kernels]
    assert launched                      # the profiler links ops to kernels
    trains = {T * B * 2048, T * B * 784}
    for e in launched:
        for shape in e.input_shapes or []:
            n = int(np.prod(shape)) if shape else 0
            assert n not in trains, (e.name, shape,
                                     [k.name for k in e.kernels])


def test_auto_chain_on_card(card):
    """auto: the narrow nine-layer stack goes to the staged kernels in
    snn_apply_int, and the engine and the chunked window refuse it."""
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=(64,) * 10)
    px, st, ws = _problem(cfg, 9, card, seed=6, fan_in_scale=170)
    p = {"layers": [{"w_q": w} for w in ws]}
    before = _readout_launches()
    got = snn.snn_apply_int(p, px, st, cfg)
    assert _readout_launches() == (before[0] + 1, before[1] + 9) + before[2:]
    want = snn.snn_apply_int(p, px, st, cfg, backend="reference")
    _assert_equal(got["spike_counts"], want["spike_counts"], "9 x 64")
    with pytest.raises(ValueError, match="cannot resume"):
        snn.snn_window_chunk(p, px, snn.snn_window_init(p, st, cfg), cfg,
                             chunk_steps=4)
    with pytest.raises(ValueError, match="no resumable stack kernel"):
        SNNStreamEngine(p, cfg)


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
    # pixels that do not start on a 16-byte boundary are refused before the
    # launch (the op copies such pixels), and nothing is counted
    buf = torch.zeros(8 * 784 + 16, dtype=torch.uint8, device=card)
    bad = list(args)
    bad[0] = buf[8:8 + 8 * 784].view(8, 784)
    before = fused_snn.fused_snn_stack.launches
    with pytest.raises(ValueError, match="16-byte"):
        fused_snn.fused_snn_stack(*bad, **kw)
    assert fused_snn.fused_snn_stack.launches == before


@pytest.mark.parametrize("name,backend,kernel", [
    ("SNN_CONFIG_PRUNED", "fused", fused_snn.fused_snn_stack),
    ("SNN_CONFIG_WIDE", "fused_streamed", fused_snn.fused_snn_stack_streamed),
])
def test_engine_fused_equals_reference_on_card(card, name, backend, kernel):
    rng = np.random.default_rng(4)
    cfg = getattr(cfgs, name)
    sizes = cfg.layer_sizes
    wide = name == "SNN_CONFIG_WIDE"        # codes scaled to fan-in there
    p = {"layers": [{"w_q": np.clip(np.round(rng.normal(
        0 if wide else 6, 170 / np.sqrt(i) if wide else 40, (i, o))),
        -256, 255).astype(np.int16)} for i, o in zip(sizes[:-1], sizes[1:])]}
    imgs = rng.integers(0, 256, (40, 784), dtype=np.uint8)
    res = {}
    for b in (None, "reference"):
        eng = SNNStreamEngine(p, cfg, batch_size=16, chunk_steps=4,
                              patience=2, seed=3, backend=b)
        assert eng.backend == (backend if b is None else b)
        for im in imgs:
            eng.submit(im)
        before = kernel.launches
        res[b] = eng.run()
        launched = kernel.launches - before
        assert launched == (eng.dispatches if b is None else 0)
    assert sorted(res[None]) == list(range(40))
    for rid, r in res["reference"].items():
        f = res[None][rid]
        assert (f.pred, f.steps, f.adds, f.early_exit) == \
            (r.pred, r.steps, r.adds, r.early_exit)
        np.testing.assert_array_equal(f.spike_counts, r.spike_counts)


@pytest.mark.parametrize("sparse_skip", [True, False])
@pytest.mark.parametrize("B,n_in,n_out,density,enables,codes", [
    (1021, 784, 512, 0.14, "80%", "random"),
    (64, 2048, 512, 0.06, "dead", "random"),
    (40, 2048, 10, 1.0, "80%", "random"),
    (24, 784, 5, 0.0, "dead", "random"),
    (1000, 2048, 512, 0.10, "dead", "random"),   # not a multiple of 64
    (24, 2048, 512, 0.14, "dead", "random"),
    (1024, 4096, 512, 0.10, "dead", "random"),
    (1024, 2048, 5, 1.0, "dead", "extremes"),
    (1024, 2048, 10, 1.0, "80%", "extremes")])
def test_partial_contraction_kernel_equals_plain(card, B, n_in, n_out,
                                                 density, enables, codes,
                                                 sparse_skip):
    """K3 through the op, int16 codes packed per call, against the op on
    the CPU; "dead" kills every other 8-lane block (one half of each
    16-lane MMA fragment) in every other 128-column tile."""
    rng = np.random.default_rng(n_in + n_out + B)
    x = torch.from_numpy(rng.random((B, n_in)) < density).to(card)
    en = rng.random((B, n_out)) < 0.8
    if enables == "dead":
        for b in range(0, B, 16):
            for c in range(0, n_out, 256):
                en[b:b + 8, c:c + 128] = False
    en = torch.from_numpy(en).to(card)
    w = rng.integers(-256, 256, (n_in, n_out)).astype(np.int16)
    if codes == "extremes":
        w[0::3], w[1::3] = -256, 255
    w = torch.from_numpy(w).to(card)
    before = fused_snn.partial_contraction.launches
    got = ops.partial_contraction_op(x, en, w, sparse_skip=sparse_skip)
    torch.cuda.synchronize()
    assert fused_snn.partial_contraction.launches == before + 1
    want = ops.partial_contraction_op(x.cpu(), en.cpu(), w.cpu(),
                                      sparse_skip=sparse_skip)
    _assert_equal(tuple(t.cpu() for t in got), want, "K3")


def test_partial_contraction_kernel_on_placed_planes(card):
    """A placed packed shard goes to the kernel as it is; columns past
    n_valid come back 0, the skip counts equal the plain version's."""
    rng = np.random.default_rng(7)
    B, n_in, n_out = 1024, 2048, 10
    x = (torch.from_numpy(rng.random((B, n_in)) < 0.06)
         .to(torch.uint8).to(card))
    en = torch.ones((B, 128), dtype=torch.uint8, device=card)
    w = torch.zeros((n_in, 128), dtype=torch.int16)
    w[:, :n_out] = torch.from_numpy(
        rng.integers(-256, 256, (n_in, n_out)).astype(np.int16))
    wp = fused_snn.pack_weights(w).to(card)
    got = fused_snn.partial_contraction(x, en, wp, n_valid=n_out)
    torch.cuda.synchronize()
    want = fused_snn.partial_contraction_plain(x.cpu(), en.cpu(), wp.cpu(),
                                               n_valid=n_out)
    _assert_equal(tuple(t.cpu() for t in got), want, "K3 placed")
    assert not got[0][:, 16:].any()
    buf = torch.zeros(B * n_in + 16, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        fused_snn.partial_contraction(buf[8:8 + B * n_in].view(B, n_in), en,
                                      wp, n_valid=n_out)


def _k6_operands(rng, B, K, N, density, codes, spikes):
    """Spikes non-zero at ``density``, of value 1 or (``"bytes"``) 1, 2
    or 255; codes in ±2000, over all of int16, or (``"extremes"``) with
    every column holding -32768 and 32767."""
    on = rng.random((B, K)) < density
    s = on.astype(np.uint8) if spikes == "01" else np.where(
        on, rng.choice(np.array([1, 2, 255], np.uint8), (B, K)), 0)
    lo, hi = (-2000, 2001) if codes == "wide" else (-(1 << 15), 1 << 15)
    w = rng.integers(lo, hi, (K, N)).astype(np.int16)
    if codes == "extremes":
        w[0::3], w[1::3] = -(1 << 15), (1 << 15) - 1
    return torch.from_numpy(s.astype(np.uint8)), torch.from_numpy(w)


@pytest.mark.parametrize("mode", ["masked", "dot", "auto_masked",
                                  "auto_dot"])
@pytest.mark.parametrize("B,K,N,density,codes,spikes", [
    (1024, 2048, 2048, 0.058, "wide", "01"),
    (1021, 784, 10, 0.2, "wide", "01"),
    (1000, 2048, 512, 0.058, "extremes", "bytes"),
    (24, 784, 10, 0.2, "int16", "bytes"),
    (1024, 4096, 256, 0.058, "extremes", "01"),
    (1024, 2048, 512, 0.0, "int16", "01"),
    (1024, 2048, 512, 0.001, "int16", "bytes"),
    (1024, 2048, 512, 1.0, "extremes", "bytes"),
])
def test_spike_matmul_kernel_equals_plain(card, B, K, N, density, codes,
                                          spikes, mode):
    """K6 on the int8 tensor cores equals the plain version bit for bit:
    int16 extremes, spike bytes of 2 and 255 (dot multiplies by them,
    masked counts 1), lanes that are not multiples of its 128-lane tile,
    K = 4,096 and densities 0, 0.1% and 100%; ``auto`` on both sides of
    the threshold, telemetry equal."""
    rng = np.random.default_rng(K + B)
    s, w = _k6_operands(rng, B, K, N, density, codes, spikes)
    kw = dict(mode=mode[:4] if mode.startswith("auto") else mode,
              density_threshold={"auto_masked": 1.5, "auto_dot": 0.0}.get(
                  mode, 0.1), with_telemetry=True)
    before = spike_matmul.spike_matmul.launches
    got, tel = ops.spike_matmul_op(s.to(card), w.to(card), **kw)
    torch.cuda.synchronize()
    assert spike_matmul.spike_matmul.launches == before + 1
    want, want_tel = ops.spike_matmul_op(s, w, **kw)
    assert bool(want_tel.used_masked) == mode.endswith("masked")
    _assert_equal(got.cpu(), want, "K6")
    _assert_equal(tuple(t.cpu() for t in tel), tuple(want_tel), "K6 tel")


def test_spike_matmul_kernel_refuses_misaligned_operands(card):
    """The kernel copies 16-byte pieces; a view that starts off a 16-byte
    boundary is refused before the launch, and nothing is counted."""
    buf = torch.zeros(8 * 128 + 16, dtype=torch.uint8, device=card)
    w = torch.zeros((128, 128), dtype=torch.int16, device=card)
    flag = torch.tensor(True, device=card)
    before = spike_matmul.spike_matmul.launches
    with pytest.raises(ValueError, match="16-byte"):
        spike_matmul.spike_matmul(buf[8:8 + 8 * 128].view(8, 128), w, flag)
    assert spike_matmul.spike_matmul.launches == before


def test_model_sharded_engine_equals_single_on_card(card):
    """784→64→10 on a 1×2 mesh of the card (both layers sharded): K3 runs
    every contraction and the results equal the single-device engine's."""
    from repro_torch.configs.snn_mnist import (SNNStreamMeshConfig,
                                               make_stream_engine)
    rng = np.random.default_rng(8)
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=(784, 64, 10))
    p = {"layers": [{"w_q": np.clip(np.round(rng.normal(0, 170 / np.sqrt(i),
                                                        (i, o))), -256, 255)
                     .astype(np.int16)} for i, o in ((784, 64), (64, 10))]}
    imgs = rng.integers(0, 256, (40, 784), dtype=np.uint8)
    knobs = SNNStreamMeshConfig(num_devices=1, model_devices=2,
                                lanes_per_device=16)
    eng = make_stream_engine(p, cfg, knobs, devices=[card] * 2, patience=2,
                             seed=3)
    assert eng.backend == "fused" and eng.model_ways == (2, 2)
    ref = SNNStreamEngine(p, cfg, batch_size=16, patience=2, seed=3)
    for im in imgs:
        eng.submit(im)
        ref.submit(im)
    before = (fused_snn.partial_contraction.launches,
              fused_snn.fused_snn_stack.launches)
    got = eng.run()
    assert fused_snn.partial_contraction.launches > before[0]
    assert fused_snn.fused_snn_stack.launches == before[1]
    want = ref.run()
    assert sorted(got) == sorted(want) == list(range(40))
    for rid, r in want.items():
        g = got[rid]
        assert (g.pred, g.steps, g.adds, g.early_exit) == \
            (r.pred, r.steps, r.adds, r.early_exit)
        np.testing.assert_array_equal(g.spike_counts, r.spike_counts)


def test_speculation_on_a_side_stream_changes_nothing_on_card(card):
    """784→64→10 on a 1×2 mesh of the card with speculation on (the
    default) and off: chunk k+1 runs on the engine's side stream, some
    speculations are used and some wasted, and the results are equal."""
    from repro_torch.configs.snn_mnist import (SNNStreamMeshConfig,
                                               make_stream_engine)
    rng = np.random.default_rng(9)
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=(784, 64, 10))
    p = {"layers": [{"w_q": np.clip(np.round(rng.normal(0, 170 / np.sqrt(i),
                                                        (i, o))), -256, 255)
                     .astype(np.int16)} for i, o in ((784, 64), (64, 10))]}
    imgs = rng.integers(0, 256, (96, 784), dtype=np.uint8)
    runs = {}
    for overlap in (True, False):
        knobs = SNNStreamMeshConfig(num_devices=1, model_devices=2,
                                    lanes_per_device=16, chunk_steps=2,
                                    overlap=overlap)
        eng = make_stream_engine(p, cfg, knobs, devices=[card] * 2,
                                 patience=2, seed=3)
        for im in imgs:
            eng.submit(im)
        runs[overlap] = eng.run()
        if overlap:
            assert eng.stats["spec_used"] > 0 and \
                eng.stats["spec_wasted"] > 0, eng.stats
            assert [d.type for d in eng._side] == ["cuda"]
        else:
            assert eng.stats["spec_used"] == eng.stats["spec_wasted"] == 0
    assert sorted(runs[True]) == sorted(runs[False]) == list(range(96))
    for rid, r in runs[False].items():
        g = runs[True][rid]
        assert (g.pred, g.steps, g.adds, g.early_exit) == \
            (r.pred, r.steps, r.adds, r.early_exit)
        np.testing.assert_array_equal(g.spike_counts, r.spike_counts)


def test_reduced_qwen3_decode_placed_over_one_nccl_rank(card):
    """Reduced qwen3 (float32) placed on a 1×1 mesh over a one-rank
    ``nccl`` group serves the same tokens, and logits within float32
    rounding, as the unplaced model."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.partition import (batch_specs, param_specs,
                                                   place, to_shardings)
    from repro_torch.distributed.sharding import (make_device_mesh,
                                                  make_rules, use_rules)
    from repro_torch.models import lm_init
    from repro_torch.serve import make_decode_step, make_prefill

    cfg = get_reduced("qwen3-4b")
    gen = torch.Generator(device=card).manual_seed(0)
    model = lm_init(cfg, generator=gen, device=card)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 12),
                                     generator=gen, device=card,
                                     dtype=torch.int32)}

    def serve(m, b):
        st, logits = make_prefill(cfg, max_len=20)(m, b)
        out = [logits[:, -1]]
        for _ in range(4):
            st, lg = make_decode_step(cfg)(m, st)
            out.append(lg)
        return out, st.last_token

    want, want_tok = serve(model, batch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"), devices=[card])
        rules = make_rules(mesh, fsdp=False)
        with use_rules(rules):
            model = place(model, to_shardings(
                mesh, rules, param_specs(cfg, model), model), mesh)
            placed = place(batch, to_shardings(
                mesh, rules, batch_specs(batch), batch), mesh)
            got, got_tok = serve(model, placed)
            got = [g.full_tensor() for g in got]
            got_tok = got_tok.full_tensor()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got_tok, want_tok)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_reduced_jamba_decode_placed_over_one_nccl_rank(card):
    """Reduced jamba (float32: the hybrid stack, Mamba-2 and attention
    caches, MoE every second layer) placed on a 1×1 mesh over a one-rank
    ``nccl`` group serves the same tokens, and logits within float32
    rounding, as the unplaced model."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.partition import (batch_specs, param_specs,
                                                   place, to_shardings)
    from repro_torch.distributed.sharding import (make_device_mesh,
                                                  make_rules, use_rules)
    from repro_torch.models import lm_init
    from repro_torch.serve import make_decode_step, make_prefill

    cfg = get_reduced("jamba-v0.1-52b")
    gen = torch.Generator(device=card).manual_seed(0)
    model = lm_init(cfg, generator=gen, device=card)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=gen, device=card,
                                     dtype=torch.int32)}

    def serve(m, b):
        st, logits = make_prefill(cfg, max_len=24)(m, b)
        out = [logits[:, -1]]
        for _ in range(4):
            st, lg = make_decode_step(cfg)(m, st)
            out.append(lg)
        return out, st.last_token

    want, want_tok = serve(model, batch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"), devices=[card])
        rules = make_rules(mesh, fsdp=False)
        with use_rules(rules):
            model = place(model, to_shardings(
                mesh, rules, param_specs(cfg, model), model), mesh)
            placed = place(batch, to_shardings(
                mesh, rules, batch_specs(batch), batch), mesh)
            got, got_tok = serve(model, placed)
            got = [g.full_tensor() for g in got]
            got_tok = got_tok.full_tensor()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got_tok, want_tok)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
