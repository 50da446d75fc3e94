"""Parity of the port's staged backend and its two kernels' ops with the JAX
package, on the CPU.

On CPU tensors ``poisson_encode_op`` and ``lif_forward_op`` run their
kernels' plain versions; they are held, integer for integer, against the
JAX package's Pallas kernels in interpret mode, including int16 codes
outside the fused kernels' signed 9-bit range and a sum that wraps in 32
bits.  ``snn_apply_int(backend="staged")`` is held against the JAX staged
backend on every readout, and both packages refuse the same things: wide
codes on the fused backends, and ``staged`` in the chunked window.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.core import prng as jprng
from repro.core import snn as jsnn
from repro.kernels import ops as jops
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import snn as tsnn
from repro_torch.kernels import lif_step as tlif
from repro_torch.kernels import ops as tops
from repro_torch.kernels import poisson_encode as tenc
from repro_torch.serve import SNNStreamEngine

_LIF = dict(decay_shift=4, v_threshold=128)
_SIZES = (200, 256, 96, 10)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _same(got, want, msg=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{msg}[{i}]")
        return
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("b,n,t", [(1, 784, 5), (9, 200, 8), (16, 128, 1),
                                   (5, 3, 4)])
def test_poisson_encode_op_matches_jax(b, n, t):
    rng = np.random.default_rng(b + n)
    px = rng.integers(0, 256, (b, n), dtype=np.uint8)
    st = np.array(jprng.seed_state(77, (b, n)))
    want = jops.poisson_encode_op(jnp.asarray(px), jnp.asarray(st), t,
                                  interpret=True)
    before = tenc.poisson_encode.launches
    got = tops.poisson_encode_op(torch.from_numpy(px),
                                 torch.from_numpy(st.copy()), t)
    assert tenc.poisson_encode.launches == before      # CPU: plain version
    assert got[0].dtype == torch.uint8 and tuple(got[0].shape) == (t, b, n)
    _same(got, want)


def _spike_train(rng, shape, kind):
    """0/1 spikes, or (``"bytes"``) bytes of 0, 1, 2 and 255, which the
    JAX kernel's dot counts by value."""
    if kind == "01":
        return rng.integers(0, 2, shape, dtype=np.uint8)
    return rng.choice(np.array([0, 1, 2, 255], np.uint8), shape)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("b,n_in,n_out,t,lo,hi,spikes", [
    pytest.param(4, 200, 96, 8, -256, 255, "01", id="4-200-96-8--256-255"),
    # wider than the 9-bit range
    pytest.param(9, 256, 130, 5, -2000, 2000, "01",
                 id="9-256-130-5--2000-2000"),
    # the whole int16 range
    pytest.param(3, 33, 10, 6, -32768, 32767, "01",
                 id="3-33-10-6--32768-32767"),
    # spike bytes of 2 and 255 count by value
    pytest.param(4, 200, 96, 8, -256, 255, "bytes",
                 id="4-200-96-8--256-255-bytes"),
    pytest.param(9, 256, 130, 5, -32768, 32767, "bytes",
                 id="9-256-130-5--32768-32767-bytes"),
    # n_in not a multiple of 16: the op pads it with zero spikes and rows
    pytest.param(5, 100, 130, 4, -32768, 32767, "bytes",
                 id="5-100-130-4--32768-32767-bytes"),
    pytest.param(8, 1, 10, 3, -256, 255, "01", id="8-1-10-3--256-255"),
])
def test_lif_forward_op_matches_jax(b, n_in, n_out, t, lo, hi, spikes,
                                    prune):
    rng = np.random.default_rng(n_in + n_out)
    spikes = _spike_train(rng, (t, b, n_in), spikes)
    w = rng.integers(lo, hi + 1, (n_in, n_out)).astype(np.int16)
    kw = dict(active_pruning=prune, v_min=-(1 << 24), v_max=(1 << 24) - 1,
              **_LIF)
    want = jops.lif_forward_op(jnp.asarray(spikes), jnp.asarray(w),
                               interpret=True, **kw)
    before = tlif.lif_forward.launches
    got = tops.lif_forward_op(torch.from_numpy(spikes), torch.from_numpy(w),
                              **kw)
    assert tlif.lif_forward.launches == before
    _same(got, want)
    assert int(got[0].sum()) > 0


def test_lif_forward_op_counts_spike_bytes_by_value():
    """A byte of 2 adds its code twice, as in the JAX kernel: the trace of
    bytes {0, 1, 2, 255} is not the trace of the same train binarised."""
    rng = np.random.default_rng(3)
    spikes = _spike_train(rng, (4, 8, 48), "bytes")
    w = rng.integers(-64, 64, (48, 16)).astype(np.int16)
    kw = dict(v_min=-(1 << 24), v_max=(1 << 24) - 1, **_LIF)
    want = jops.lif_forward_op(jnp.asarray(spikes), jnp.asarray(w),
                               interpret=True, **kw)
    got = tops.lif_forward_op(torch.from_numpy(spikes), torch.from_numpy(w),
                              **kw)
    _same(got, want)
    binary = tops.lif_forward_op(torch.from_numpy(spikes != 0),
                                 torch.from_numpy(w), **kw)
    assert not torch.equal(got[1], binary[1])


@pytest.mark.parametrize("dtype,bad", [(torch.int16, 256),
                                       (torch.int32, -1),
                                       (torch.int64, 1 << 40)])
def test_lif_forward_op_refuses_spikes_outside_uint8(dtype, bad):
    """A cast would wrap such spike values where the JAX op counts them
    exactly, so the port refuses them; values inside [0, 255] of a wider
    dtype go through as their bytes."""
    w = torch.ones((5, 3), dtype=torch.int16)
    spikes = torch.zeros((2, 4, 5), dtype=dtype)
    spikes[1, 2, 3] = bad
    before = tlif.lif_forward.launches
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        tops.lif_forward_op(spikes, w, **_LIF)
    assert tlif.lif_forward.launches == before
    spikes[1, 2, 3] = 255
    for a, b in zip(tops.lif_forward_op(spikes, w, **_LIF),
                    tops.lif_forward_op(spikes.to(torch.uint8), w, **_LIF)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_in,k", [(100, 112), (784, 784), (64, 64),
                                    (1, 16)])
def test_lif_forward_op_pads_k_to_16(monkeypatch, n_in, k):
    """The kernel copies 16-byte pieces of spike rows, so the op hands it
    n_in padded to a multiple of 16, and only where it is not one."""
    seen = []
    real = tlif.lif_forward

    def spy(spikes, w, **kw):
        seen.append((tuple(spikes.shape), tuple(w.shape)))
        return real(spikes, w, **kw)

    monkeypatch.setattr(tlif, "lif_forward", spy)
    rng = np.random.default_rng(n_in)
    spikes = torch.from_numpy(_spike_train(rng, (3, 5, n_in), "bytes"))
    w = torch.from_numpy(rng.integers(-300, 300, (n_in, 10))
                         .astype(np.int16))
    got = tops.lif_forward_op(spikes, w, **_LIF)
    assert seen == [((3, 8, k), (k, 128))]
    want = tlif.lif_forward_plain(spikes, w, **_LIF)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_lif_forward_plain_wraps_in_32_bits():
    """Σ W·S past 2^31 wraps in both packages (n_in · 32,767 ≥ 2^31)."""
    n_in = 65_600
    spikes = np.ones((1, 1, n_in), np.uint8)
    w = np.full((n_in, 2), 32767, np.int16)
    w[:, 1] = -32768
    kw = dict(decay_shift=30, v_threshold=1 << 30, v_min=-(1 << 31),
              v_max=(1 << 31) - 1)
    want = jops.lif_forward_op(jnp.asarray(spikes), jnp.asarray(w),
                               interpret=True, **kw)
    got = tops.lif_forward_op(torch.from_numpy(spikes), torch.from_numpy(w),
                              **kw)
    _same(got, want)
    wrapped = (n_in * 32767 + (1 << 31)) % (1 << 32) - (1 << 31)
    assert wrapped < 0
    assert int(got[1][0, 0, 0]) == wrapped - (wrapped >> 30)   # after leak


@pytest.mark.parametrize("readout", ["count", "first_spike", "membrane"])
def test_snn_apply_int_staged_matches_jax(readout):
    rng = np.random.default_rng(len(readout) + 40)
    prune = readout == "first_spike"
    jc = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=7, readout=readout,
                             active_pruning=prune)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=7, readout=readout,
                             active_pruning=prune)
    # codes up to ±1000: the staged backend takes them, the fused ones not
    p = {"layers": [{"w_q": np.clip(np.round(rng.normal(4, 300, (i, o))),
                                    -1000, 1000).astype(np.int16),
                     "scale": np.float32(1 / 128)}
                    for i, o in zip(_SIZES[:-1], _SIZES[1:])]}
    px = rng.integers(0, 256, (10, _SIZES[0]), dtype=np.uint8)
    st = np.array(jprng.seed_state(8, px.shape))
    jp = {"layers": [{"w_q": jnp.asarray(l["w_q"]), "scale": l["scale"]}
                     for l in p["layers"]]}
    want = jsnn.snn_apply_int(jp, jnp.asarray(px), jnp.asarray(st), jc,
                              backend="staged")
    tp = params_from_jax(p, device="cpu")
    got = tsnn.snn_apply_int(tp, torch.from_numpy(px), torch.from_numpy(st),
                             tc, backend="staged")
    for key in ("pred", "spike_counts", "v_trace", "first_spike_t",
                "v_final", "active_adds", "prng_state", "input_spikes",
                "v_peak"):
        _same(got[key], want[key], key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _same(getattr(got["telemetry"], f), getattr(want["telemetry"], f), f)
    ref = tsnn.snn_apply_int(tp, torch.from_numpy(px), torch.from_numpy(st),
                             tc, backend="reference")
    _same(got["spike_counts"], _np(ref["spike_counts"]), "vs reference")
    assert int(got["spike_counts"].sum()) > 0
    # both packages' fused backends refuse these codes with one message
    for backend in ("fused", "fused_streamed"):
        with pytest.raises(ValueError) as jerr:
            jsnn.snn_apply_int(jp, jnp.asarray(px), jnp.asarray(st), jc,
                               backend=backend)
        with pytest.raises(ValueError) as terr:
            tsnn.snn_apply_int(tp, torch.from_numpy(px),
                               torch.from_numpy(st), tc, backend=backend)
        assert str(terr.value) == str(jerr.value)
        assert "[-256, 255]" in str(terr.value)


def test_window_chunk_refuses_staged_like_jax():
    cfg_j = jcfgs.SNN_CONFIG
    cfg_t = tcfgs.SNN_CONFIG
    w = np.zeros((784, 10), np.int16)
    st = np.array(jprng.seed_state(1, (2, 784)))
    px = np.zeros((2, 784), np.uint8)
    jp = {"layers": [{"w_q": jnp.asarray(w)}]}
    tp = {"layers": [{"w_q": torch.from_numpy(w)}]}
    with pytest.raises(ValueError) as jerr:
        jsnn.snn_window_chunk(jp, jnp.asarray(px),
                              jsnn.snn_window_init(jp, jnp.asarray(st),
                                                   cfg_j),
                              cfg_j, chunk_steps=4, backend="staged")
    with pytest.raises(ValueError) as terr:
        tsnn.snn_window_chunk(tp, torch.from_numpy(px),
                              tsnn.snn_window_init(tp, torch.from_numpy(st),
                                                   cfg_t),
                              cfg_t, chunk_steps=4, backend="staged")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="cannot resume"):
        SNNStreamEngine(tp, cfg_t, backend="staged", device="cpu")


def test_staged_wrappers_check_operands():
    spikes = torch.zeros((2, 8, 5), dtype=torch.uint8)
    w = torch.zeros((5, 128), dtype=torch.int16)
    with pytest.raises(TypeError):
        tlif.lif_forward(spikes.bool(), w, **_LIF)
    with pytest.raises(ValueError, match="shape"):
        tlif.lif_forward(spikes, w[:4], **_LIF)
    with pytest.raises(ValueError, match="contiguous"):
        tlif.lif_forward(spikes.transpose(0, 1).contiguous().transpose(0, 1),
                         w, **_LIF)
    with pytest.raises(ValueError, match="device"):
        tlif.lif_forward(spikes.to("meta"), w.to("meta"), **_LIF)
    px = torch.zeros((8, 128), dtype=torch.uint8)
    st = torch.ones((8, 128), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(TypeError):
        tenc.poisson_encode(px, st.view(torch.int32), 3)
    with pytest.raises(ValueError, match="device"):
        tenc.poisson_encode(px.to("meta"), st.to("meta"), 3)
    spk, st_out = tenc.poisson_encode(px, st, 0)
    assert tuple(spk.shape) == (0, 8, 128)
    assert torch.equal(st_out.view(torch.int32), st.view(torch.int32))
