"""The staged call's readouts from the kernels' tallies, on the CPU.

``snn_apply_int(backend="staged")`` takes its telemetry, peaks and last
layer's counts from the encoder's tallies and the LIF kernel's readout
launches (on CPU tensors their plain versions), never from a pass over a
(T, B, width) train.  Every field it returns is held here to the
reference backend's, whose telemetry and peaks are ``_derive_stack_telemetry`` and
``layer_tile_skips`` on the materialised trains: pruning on and off, the
tile skip on and off, batches that are not a multiple of 8, inputs that
are not a multiple of 16 or 128, depths 2 to 4, heads of 10 and a layer
that never fires.  The encoder's and the LIF readout twin's tallies are
held to the same oracle directly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import snn_mnist as cfgs
from repro_torch.core import snn
from repro_torch.core.prng import seed_state
from repro_torch.core.telemetry import layer_tile_skips
from repro_torch.kernels import lif_step, ops, poisson_encode

_LIF = dict(decay_shift=4, v_threshold=128, v_rest=0, v_min=-(1 << 20),
            v_max=(1 << 20) - 1)

# (layer sizes, lanes, steps)
_STACKS = {
    "2-layers-200": ((200, 96, 10), 13, 7),
    "3-layers-200": ((200, 256, 96, 10), 21, 7),
    "4-layers-100": ((100, 130, 64, 40, 10), 9, 6),
    "3-layers-37": ((37, 300, 128, 10), 16, 5),
}


def _params(sizes, seed, silent=None):
    """Codes from normal(6, 300 / sqrt(fan-in)) clipped to 9 bits; layer
    ``silent`` all -256, so that it never fires."""
    rng = np.random.default_rng(seed)
    layers = []
    for l, (i, o) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = np.clip(np.round(rng.normal(6, 300 / np.sqrt(i), (i, o))),
                    -256, 255)
        if l == silent:
            w[:] = -256
        layers.append({"w_q": torch.from_numpy(w.astype(np.int16))})
    return {"layers": layers}


def _equal(got, want, what):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
        return
    assert got.shape == want.shape, what
    if got.dtype == torch.uint32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.to(torch.int64), want.to(torch.int64)), what


@pytest.mark.parametrize("sparse_skip", [True, False])
@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("stack,silent", [(k, None) for k in _STACKS]
                         + [("3-layers-200", 1), ("2-layers-200", 0)])
def test_staged_readouts_equal_the_reference(stack, silent, prune,
                                             sparse_skip):
    sizes, b, t = _STACKS[stack]
    cfg = dataclasses.replace(cfgs.SNN_CONFIG_DEEP, layer_sizes=sizes,
                              num_steps=t, active_pruning=prune,
                              sparse_skip=sparse_skip, readout="membrane")
    params = _params(sizes, b + t, silent)
    rng = np.random.default_rng(b)
    px = torch.from_numpy(rng.integers(0, 256, (b, sizes[0]),
                                       dtype=np.uint8))
    st = seed_state(b, (b, sizes[0]), device="cpu")
    launches = (poisson_encode.poisson_encode.launches,
                lif_step.lif_forward_readout.launches)
    got = snn.snn_apply_int(params, px, st, cfg, backend="staged")
    assert (poisson_encode.poisson_encode.launches,
            lif_step.lif_forward_readout.launches) == launches  # plain twins
    want = snn.snn_apply_int(params, px, st, cfg, backend="reference")
    assert sorted(got) == sorted(want)
    for key in ("pred", "spike_counts", "v_trace", "v_final", "active_adds",
                "first_spike_t", "prng_state", "input_spikes", "v_peak"):
        _equal(got[key], want[key], key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _equal(getattr(got["telemetry"], f), getattr(want["telemetry"], f), f)
    tel = got["telemetry"]
    assert tuple(tel.n_spk.shape) == (t, len(sizes) - 1, b)
    assert tuple(tel.tiles_skipped.shape) == (t, len(sizes) - 1, -(-b // 8))
    fired = int(got["spike_counts"].sum())
    assert (fired == 0) == (silent is not None)
    if not sparse_skip:
        assert not tel.tiles_skipped.any()


def _live(skipped, n_tiles):
    """Live tiles from ``layer_tile_skips`` against a one-tile partner
    that is live everywhere: skipped = n_tiles - live."""
    return n_tiles - skipped


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("b_valid,n_valid,k", [(13, 200, 208), (16, 96, 128),
                                               (9, 10, 256), (8, 300, 64)])
def test_lif_readout_plain_tallies(b_valid, n_valid, k, prune):
    """The LIF readout twin's tallies and peaks against the trace twin's
    outputs, with ``layer_tile_skips`` for the tiles, padding left out."""
    rng = np.random.default_rng(k + n_valid)
    bp = b_valid + (-b_valid) % 8
    n = n_valid + (-n_valid) % 128
    t = 6
    spikes = torch.from_numpy(rng.integers(0, 2, (t, bp, k), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(-40, 120, (k, n)).astype(np.int16))
    kw = dict(_LIF, v_threshold=-1, active_pruning=prune)  # padding fires
    r = lif_step.lif_forward_readout_plain(spikes, w, b_valid=b_valid,
                                           n_valid=n_valid, last=True, **kw)
    spk, vtr, vfin = lif_step.lif_forward_plain(spikes, w, **kw)
    for key, want in (("spikes", spk), ("v_trace", vtr), ("v_final", vfin),
                      ("v_peak", vtr.amax(0)),
                      ("counts", spk.sum(0, dtype=torch.int32))):
        _equal(r[key], want, key)
    t_idx = torch.arange(t, dtype=torch.int32)[:, None, None]
    _equal(r["first"], torch.where(spk != 0, t_idx, t).amin(0), "first")
    x = spk[:, :b_valid, :n_valid] != 0
    if prune:
        s = spk[:, :b_valid, :n_valid].to(torch.int32)
        en = (torch.cumsum(s, 0) - s) == 0
    else:
        en = torch.ones_like(x)
    pad = torch.zeros((t, bp - b_valid), dtype=torch.int32)
    _equal(r["n_spk"], torch.cat([x.sum(-1, dtype=torch.int32), pad], 1),
           "n_spk")
    if prune:
        _equal(r["n_en"], torch.cat([en.sum(-1, dtype=torch.int32), pad], 1),
               "n_en")
    else:
        assert r["n_en"] is None
    one = torch.ones((t, b_valid, 1), dtype=torch.bool)
    nt = -(-n_valid // 128)
    _equal(r["live_k"], _live(layer_tile_skips(x, one, sparse_skip=True), nt),
           "live_k")
    _equal(r["live_n"], _live(layer_tile_skips(one, en, sparse_skip=True),
                              nt), "live_n")
    assert int(r["n_spk"].sum()) > 0
    hidden = lif_step.lif_forward_readout_plain(
        spikes, w, b_valid=b_valid, n_valid=n_valid, last=False, **kw)
    assert sorted(hidden) == ["live_k", "live_n", "n_en", "n_spk", "spikes",
                              "v_peak"]


@pytest.mark.parametrize("b,n,t", [(8, 784, 5), (16, 208, 3), (24, 16, 1),
                                   (8, 400, 0), (13, 100, 4)])
def test_encoder_readout_plain_tallies(b, n, t):
    """The encoder's tallies on the CPU, added into layer 0 of zeroed
    tallies, against ``layer_tile_skips``; the train and state are the
    plain version's, with or without tallies."""
    rng = np.random.default_rng(b + n)
    px = torch.from_numpy(rng.integers(0, 256, (b, n), dtype=np.uint8))
    st = seed_state(n, (b, n), device="cpu")
    tal = ops.staged_tallies(t, 2, b, "cpu")
    spikes, state = poisson_encode.poisson_encode(px, st, t, tal)
    want = poisson_encode.poisson_encode_plain(px, st, t)
    _equal((spikes, state), want, "train")
    _equal(poisson_encode.poisson_encode(px, st, t), want, "no tallies")
    bp = b + (-b) % 8
    counts = spikes.sum(-1, dtype=torch.int32)
    _equal(tal.n_spk[:, 0, :b], counts, "n_spk")
    assert not tal.n_spk[:, 0, b:].any()
    one = torch.ones((t, b, 1), dtype=torch.bool)
    _equal(tal.live_k[:, 0], _live(layer_tile_skips(spikes != 0, one,
                                                     sparse_skip=True),
                                   -(-n // 128)), "live")
    assert tuple(tal.live_k.shape) == (t, 2, bp // 8)
    for rest in (tal.n_spk[:, 1], tal.live_k[:, 1], tal.n_en, tal.live_n):
        assert not rest.any()


def test_readout_launches_check_their_tallies():
    """The launchers refuse tallies of the wrong lanes, steps, dtype or
    layout, a layer outside the stack and padding past one lane block."""
    tal = ops.staged_tallies(3, 2, 13, "cpu")
    assert tuple(tal.n_spk.shape) == (3, 2, 16)
    assert tuple(tal.live_k.shape) == (3, 2, 2)
    spikes = torch.zeros((3, 16, 208), dtype=torch.uint8)
    w = torch.zeros((208, 128), dtype=torch.int16)
    kw = dict(_LIF, layer=0, b_valid=13, n_valid=100)
    assert sorted(lif_step.lif_forward_readout(spikes, w, tal, **kw)) == \
        ["spikes", "v_peak"]
    assert "v_trace" in lif_step.lif_forward_readout(spikes, w, tal,
                                                     **dict(kw, layer=1))
    wide = ops.staged_tallies(3, 2, 24, "cpu")
    for bad_tal, bad in ((ops.staged_tallies(4, 2, 16, "cpu"), {}),
                         (wide, {}),
                         (tal._replace(n_en=tal.n_en.to(torch.int64)), {}),
                         (tal._replace(live_n=torch.zeros(
                             (2, 3, 2), dtype=torch.int32).transpose(0, 1)),
                          {}),
                         (tal, dict(layer=2)), (tal, dict(b_valid=8)),
                         (tal, dict(n_valid=129))):
        with pytest.raises(ValueError):
            lif_step.lif_forward_readout(spikes, w, bad_tal,
                                         **dict(kw, **bad))
    px = torch.zeros((13, 200), dtype=torch.uint8)
    st = torch.zeros((13, 200), dtype=torch.int32).view(torch.uint32)
    poisson_encode.poisson_encode(px, st, 3, tal)
    for bad_tal in (wide, ops.staged_tallies(2, 2, 13, "cpu")):
        with pytest.raises(ValueError, match="tallies"):
            poisson_encode.poisson_encode(px, st, 3, bad_tal)
