"""Parity of the port's PRNG and encoder with the JAX package, on the CPU.

Inputs come from numpy with a seed and cross between the packages as numpy
arrays.  Every comparison is integer equality: the datapath is all-integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import prng as jprng
from repro_torch.core import encoding as tenc
from repro_torch.core import prng as tprng


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (3, (4, 33)),
                                        (2**31 + 5, (2, 3, 5)), (41, ())])
def test_seed_state_matches_jax(seed, shape):
    got = tprng.seed_state(seed, shape, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(jprng.seed_state(seed, shape)))


def test_seed_state_refuses_keys():
    with pytest.raises(TypeError):
        tprng.seed_state(np.zeros(2, np.uint32), (3,), device="cpu")


def test_xorshift_and_uniform_50_steps():
    rng = np.random.default_rng(11)
    s0 = rng.integers(0, 2**32, (5, 77), dtype=np.uint64).astype(np.uint32)
    s0[0, :3] = [0, 1, 0xFFFFFFFF]                  # fixed point and extremes
    js, ts = jnp.asarray(s0), torch.from_numpy(s0.copy())
    for step in range(50):
        js, ts = jprng.xorshift32_step(js), tprng.xorshift32_step(ts)
        np.testing.assert_array_equal(_u32(ts), np.asarray(js),
                                      err_msg=f"state, step {step}")
        np.testing.assert_array_equal(tprng.uniform_u8(ts).numpy(),
                                      np.asarray(jprng.uniform_u8(js)),
                                      err_msg=f"top byte, step {step}")
    assert int(_u32(ts)[0, 0]) == 0                 # zero stays zero


def test_xorshift_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tprng.xorshift32_step(torch.zeros(3, dtype=torch.int64))


def test_poisson_encode_hw_matches_jax():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (3, 784), dtype=np.uint8)
    s0 = np.asarray(jprng.seed_state(9, px.shape))
    jspk, jst = jenc.poisson_encode_hw(jnp.asarray(px), jnp.asarray(s0), 12)
    tspk, tst = tenc.poisson_encode_hw(torch.from_numpy(px),
                                       torch.from_numpy(s0.copy()), 12)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    np.testing.assert_array_equal(_u32(tst), np.asarray(jst))
    with pytest.raises(TypeError):
        tenc.poisson_encode_hw(torch.from_numpy(px).to(torch.int32),
                               torch.from_numpy(s0.copy()), 1)
