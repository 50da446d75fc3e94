"""Parity of the port's spike matmul (K6's plain version on CPU tensors)
with the JAX package's ``spike_matmul_op`` (its Pallas kernel in interpret
mode): every mode, the density dispatch on both sides of the threshold and
exactly at it, and the ``MatmulTelemetry`` side channel.  Integer
equality, and the density bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.telemetry import MatmulTelemetry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spike_matmul as tsm

_SHAPES = [(13, 300, 70), (8, 256, 128), (21, 784, 10)]


def _case(shape, density, seed=0, wide_codes=False):
    rng = np.random.default_rng(seed)
    B, K, N = shape
    s = (rng.random((B, K)) < density).astype(np.uint8)
    lo, hi = (-2000, 2000) if wide_codes else (-256, 255)
    w = rng.integers(lo, hi + 1, (K, N)).astype(np.int16)
    return s, w


def _both(s, w, **kw):
    want = jops.spike_matmul_op(jnp.asarray(s), jnp.asarray(w),
                                interpret=True, **{
                                    **kw, "mode": {"dot": "mxu"}.get(
                                        kw["mode"], kw["mode"])})
    got = tops.spike_matmul_op(torch.from_numpy(s), torch.from_numpy(w), **kw)
    return got, want


@pytest.mark.parametrize("mode", ["masked", "dot", "auto"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_spike_matmul_op_matches_jax(shape, mode):
    s, w = _case(shape, 0.1, seed=len(mode), wide_codes=mode == "dot")
    (got, tel), (want, jtel) = _both(s, w, mode=mode, with_telemetry=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape[::2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), s.astype(np.int64) @ w.astype(np.int64))
    assert isinstance(tel, MatmulTelemetry)
    assert tel.density.dtype == torch.float32
    assert tel.density.numpy().tobytes() == np.asarray(jtel.density).tobytes()
    assert bool(tel.used_masked) == bool(jtel.used_masked)


@pytest.mark.parametrize("side", ["below", "above", "at"])
@pytest.mark.parametrize("density", [0.058, 0.104])
def test_auto_dispatch_matches_jax(density, side):
    """The density threshold on either side of the observed density and
    exactly at it: ``density < threshold`` is false at equality in both
    packages, so the dot realisation runs."""
    s, w = _case((16, 512, 256), density, seed=3)
    # the reference's jitted mean: the count times float32(1 / (B·K))
    d = np.float32(np.count_nonzero(s)) * (np.float32(1) / np.float32(s.size))
    threshold = {"below": float(d) * 0.5, "above": float(d) * 2.0,
                 "at": float(d)}[side]
    (got, tel), (want, jtel) = _both(s, w, mode="auto",
                                     density_threshold=threshold,
                                     with_telemetry=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tel.density) == float(d) == float(jtel.density)
    assert bool(tel.used_masked) == bool(jtel.used_masked) == \
        (side == "above")


def test_threshold_resolves_from_env(monkeypatch):
    s, w = _case((8, 128, 128), 0.2, seed=4)
    for env, masked in (("0.5", True), ("0.05", False)):
        monkeypatch.setenv("REPRO_SPIKE_DENSITY_THRESHOLD", env)
        (_, tel), (_, jtel) = _both(s, w, mode="auto", with_telemetry=True)
        assert bool(tel.used_masked) == bool(jtel.used_masked) == masked


def test_plain_realisations_agree_and_wrap():
    """The two realisations of the plain version give the same bits on
    {0,1} spikes, wrapping past int32 as the kernel's adds do."""
    s = torch.ones((8, 70_000), dtype=torch.uint8)
    w = torch.full((70_000, 128), 32_000, dtype=torch.int16)
    outs = [tsm.spike_matmul_plain(s, w, torch.tensor(m)) for m in (True,
                                                                     False)]
    want = np.int64(70_000 * 32_000)
    want = np.int32(((want + 2**31) % 2**32) - 2**31)
    for out in outs:
        assert (out.numpy() == want).all()


def test_spike_matmul_refuses_bad_operands():
    s = torch.zeros((8, 128), dtype=torch.uint8)
    w = torch.zeros((128, 128), dtype=torch.int16)
    with pytest.raises(TypeError):
        tsm.spike_matmul(s, w.to(torch.int32), torch.tensor(True))
    with pytest.raises(ValueError):
        tsm.spike_matmul(s, torch.zeros((64, 128), dtype=torch.int16),
                         torch.tensor(True))
    with pytest.raises(ValueError, match="mode"):
        tops.spike_matmul_op(s, w, mode="mxu")


def _extreme_case(shape, seed):
    """Every column holds -32768 and 32767, and the spike bytes are 0, 1,
    2 and 255: dot multiplies by the byte, masked counts it as 1."""
    rng = np.random.default_rng(seed)
    B, K, N = shape
    w = rng.integers(-(1 << 15), 1 << 15, (K, N)).astype(np.int16)
    w[0::3], w[1::3] = -(1 << 15), (1 << 15) - 1
    s = rng.choice(np.array([0, 1, 2, 255], np.uint8), (B, K),
                   p=[0.6, 0.2, 0.1, 0.1])
    return s, w


@pytest.mark.parametrize("mode", ["masked", "dot", "auto"])
@pytest.mark.parametrize("shape", [(13, 96, 70), (24, 256, 128)])
def test_int16_extremes_and_spike_bytes_match_jax(shape, mode):
    s, w = _extreme_case(shape, seed=shape[1] + len(mode))
    (got, tel), (want, jtel) = _both(s, w, mode=mode, density_threshold=0.25,
                                     with_telemetry=True)
    masked = bool(jtel.used_masked)
    assert bool(tel.used_masked) == masked == (mode == "masked")
    x = (s != 0) if masked else s
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() < 2**31      # no int32 wrap on either side
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("bad", [1 << 15, -(1 << 15) - 1])
@pytest.mark.parametrize("op", ["spike_matmul_op", "lif_forward_op"])
def test_ops_refuse_codes_outside_int16(op, bad):
    """A cast would wrap such codes where the JAX op computes them
    exactly, so the port refuses them."""
    s = torch.zeros((8, 128), dtype=torch.uint8)
    w = torch.zeros((128, 16), dtype=torch.int32)
    w[5, 3] = bad
    with pytest.raises(ValueError, match="int16"):
        if op == "spike_matmul_op":
            tops.spike_matmul_op(s, w)
        else:
            tops.lif_forward_op(s[None], w, decay_shift=2, v_threshold=64)


def test_codes_inside_int16_pass_unchanged():
    s, w = _extreme_case((8, 128, 16), seed=5)
    w16 = torch.from_numpy(w)
    st = torch.from_numpy(s)
    assert torch.equal(tops.spike_matmul_op(st, w16.to(torch.int32)),
                       tops.spike_matmul_op(st, w16))
    kw = dict(decay_shift=2, v_threshold=64)
    for a, b in zip(tops.lif_forward_op((st != 0)[None], w16.to(torch.int64),
                                        **kw),
                    tops.lif_forward_op((st != 0)[None], w16, **kw)):
        assert torch.equal(a, b)
