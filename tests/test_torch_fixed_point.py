"""Parity of the port's fixed-point helpers (``repro_torch.core.
fixed_point``) with the JAX package's, on the CPU.

The same seeded numpy weights go through both packages.  ``choose_scale``
(per tensor and per axis), ``quantize``, ``dequantize``, ``fake_quant``
and ``int8_matmul`` are exactly equal; ``fake_quant``'s gradient is the
identity (the straight-through estimator); ``quantize_stochastic`` rounds
only to the floor or the ceiling and is unbiased (mean within 0.01 of
``w / scale`` over 20,000 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro_torch.core import fixed_point as tfp

SHAPES = [(784, 10), (64, 32), (5, 7, 3)]


def _w(shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, shape).astype(np.float32)
    # values on rounding ties of an 8-bit max-abs grid: half to even
    w.flat[:4] = np.float32([0.5, -1.5, 2.5, -0.5]) * np.abs(w).max() / 127
    return w


def _eq(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("bits", [4, 8, 9, 16])
def test_quant_params_match_jax(bits):
    j, t = jfp.QuantParams(bits=bits), tfp.QuantParams(bits=bits)
    assert (t.qmin, t.qmax) == (j.qmin, j.qmax)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [8, 9])
def test_choose_scale_quantize_dequantize_match_jax(shape, axis, bits):
    """Exactly equal (tolerance 0): scales, codes and their dtype, and the
    dequantised weights, per tensor and per axis."""
    w = _w(shape, sum(shape) + bits)
    jq, tq = jfp.QuantParams(bits=bits, axis=axis), \
        tfp.QuantParams(bits=bits, axis=axis)
    _eq(tfp.choose_scale(torch.from_numpy(w), tq),
        jfp.choose_scale(jnp.asarray(w), jq), "scale")
    q_t, s_t = tfp.quantize(torch.from_numpy(w), tq)
    q_j, s_j = jfp.quantize(jnp.asarray(w), jq)
    _eq(q_t, q_j, "codes")
    _eq(s_t, s_j, "scale")
    _eq(tfp.dequantize(q_t, s_t), jfp.dequantize(q_j, s_j), "dequantize")
    # an explicit scale is used as given
    s = np.float32(0.01)
    _eq(tfp.quantize(torch.from_numpy(w), tq, torch.tensor(s))[0],
        jfp.quantize(jnp.asarray(w), jq, jnp.float32(s))[0], "given scale")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_matches_jax_and_passes_the_gradient_straight(shape,
                                                                  bits):
    w = _w(shape, 3 * bits + len(shape))
    _eq(tfp.fake_quant(torch.from_numpy(w), bits),
        jfp.fake_quant(jnp.asarray(w), bits))
    # straight-through: d(Σ g·fq(w))/dw == g exactly, as the JAX vjp gives
    g = np.random.default_rng(bits).normal(size=shape).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    (tfp.fake_quant(wt, bits) * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda x: jfp.fake_quant(x, bits), jnp.asarray(w))
    np.testing.assert_array_equal(wt.grad.numpy(), g)
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(
        vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("dtype,lo,hi,b,k,n", [
    (np.int8, -128, 128, 32, 784, 10),
    (np.int8, -128, 128, 3, 64, 32),
    (np.int16, -256, 256, 16, 200, 12),
    # products and sums past 2^31: both wrap the int32 accumulator alike
    (np.int32, -(1 << 20), 1 << 20, 4, 300, 5),
])
def test_int8_matmul_matches_jax(dtype, lo, hi, b, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.integers(lo, hi, (b, k)).astype(dtype)
    w = rng.integers(lo, hi, (k, n)).astype(dtype)
    xs, ws = np.float32(0.02), np.float32(0.003)
    got = tfp.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          torch.tensor(xs), torch.tensor(ws))
    want = jfp.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.float32(xs),
                           jnp.float32(ws))
    _eq(got, want)
    if dtype == np.int32:                          # the case does wrap
        exact = x.astype(object) @ w.astype(object)
        assert np.abs(exact).max() > 2 ** 31


@pytest.mark.parametrize("frac", [0.1, 0.37, 0.5, 0.93])
def test_quantize_stochastic_rounds_to_neighbours_without_bias(frac):
    """Every code is floor or ceil of ``w / scale``; over 20,000 draws the
    mean code is within 0.01 of ``w / scale``."""
    scale = torch.tensor(np.float32(0.05))
    x = np.float32(3 + frac)
    w = torch.full((20_000,), float(x * np.float32(0.05)))
    g = torch.Generator()
    g.manual_seed(int(frac * 100))
    q, s = tfp.quantize_stochastic(w, tfp.QuantParams(bits=8), g, scale)
    assert q.dtype == torch.int8 and s is scale
    ratio = float((w / scale)[0])
    assert set(q.unique().tolist()) <= {np.floor(ratio), np.ceil(ratio)}
    assert abs(float(q.double().mean()) - ratio) < 0.01
    # the per-tensor scale is chosen as quantize chooses it
    _, s_auto = tfp.quantize_stochastic(w, tfp.QuantParams(bits=8), g)
    assert torch.equal(s_auto, tfp.choose_scale(w, tfp.QuantParams(bits=8)))
