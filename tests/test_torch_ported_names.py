"""Parity of the port's smaller public names with the JAX package, on the CPU.

``kernels.ops.fused_snn_op`` (the one-layer wrapper over the stack op) and
the re-exports ``SPIKE_DENSITY_THRESHOLD`` / ``resolve_density_threshold``,
``core.prng.xorshift32_sequence``, ``core.encoding.spike_train_rates``,
``core.telemetry.ChunkTelemetry.densities`` and
``serve.early_exit.stability_init``: the same inputs, made with numpy,
through both packages, equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import prng as jprng
from repro.core import telemetry as jtel
from repro.kernels import ops as jops
from repro.serve import early_exit as jee
from repro_torch.core import encoding as tenc
from repro_torch.core import prng as tprng
from repro_torch.core import telemetry as ttel
from repro_torch.kernels import ops as tops
from repro_torch.serve import early_exit as tee


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("n_in,n_out,b,t,prune", [
    (784, 10, 5, 8, False),
    (100, 37, 9, 6, True),
])
def test_fused_snn_op_matches_jax(n_in, n_out, b, t, prune):
    rng = np.random.default_rng(n_in + b)
    w = np.clip(np.round(rng.normal(6, 40, (n_in, n_out))), -256,
                255).astype(np.int16)
    px = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    st = np.array(jprng.seed_state(b, (b, n_in)))
    kw = dict(num_steps=t, decay_shift=4, v_threshold=128,
              active_pruning=prune)
    want = jops.fused_snn_op(jnp.asarray(px), jnp.asarray(st),
                             jnp.asarray(w), interpret=True, **kw)
    got = tops.fused_snn_op(torch.from_numpy(px), torch.from_numpy(st.copy()),
                            torch.from_numpy(w), **kw)
    for key in ("spike_counts", "v_trace", "first_spike_t", "v_final",
                "active_adds", "prng_state", "steps"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]),
                                      err_msg=key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        np.testing.assert_array_equal(
            _np(getattr(got["telemetry"], f)),
            np.asarray(getattr(want["telemetry"], f)), err_msg=f)
    assert int(got["spike_counts"].sum()) > 0


def test_density_threshold_reexports_match_jax(monkeypatch):
    assert tops.SPIKE_DENSITY_THRESHOLD == jops.SPIKE_DENSITY_THRESHOLD
    monkeypatch.delenv("REPRO_SPIKE_DENSITY_THRESHOLD", raising=False)
    for explicit in (None, 0.0, 0.125, 0.9):
        assert tops.resolve_density_threshold(explicit) == \
            jops.resolve_density_threshold(explicit)
    monkeypatch.setenv("REPRO_SPIKE_DENSITY_THRESHOLD", "0.3")
    assert tops.resolve_density_threshold() == \
        jops.resolve_density_threshold() == 0.3
    assert tops.resolve_density_threshold(0.5) == 0.5


@pytest.mark.parametrize("t", [0, 1, 5])
def test_xorshift32_sequence_matches_jax(t):
    st = np.array(jprng.seed_state(7, (3, 33)))
    want_final, want_seq = jprng.xorshift32_sequence(jnp.asarray(st), t)
    final, seq = tprng.xorshift32_sequence(torch.from_numpy(st.copy()), t)
    assert final.dtype == seq.dtype == torch.uint32
    assert tuple(seq.shape) == (t, 3, 33)
    np.testing.assert_array_equal(_np(final), np.asarray(want_final))
    np.testing.assert_array_equal(_np(seq), np.asarray(want_seq))


@pytest.mark.parametrize("t", [1, 7, 13, 20, 92])
def test_spike_train_rates_matches_jax(t):
    """Bit for bit: XLA's float32 mean multiplies the sum by 1/T, which
    differs from a division in the last place at T = 13, 20, 92."""
    rng = np.random.default_rng(t)
    s = rng.random((t, 6, 50)) < 0.3
    want = np.asarray(jenc.spike_train_rates(jnp.asarray(s)))
    got = tenc.spike_train_rates(torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a spike train from the port's encoder: the same rates
    px = rng.integers(0, 256, (4, 20), dtype=np.uint8)
    st = tprng.seed_state(3, (4, 20), device="cpu")
    spikes, _ = tenc.poisson_encode_hw(torch.from_numpy(px), st, t)
    np.testing.assert_array_equal(
        tenc.spike_train_rates(spikes).numpy(),
        np.asarray(jenc.spike_train_rates(jnp.asarray(spikes.numpy()))))


def test_chunk_telemetry_densities_matches_jax():
    rng = np.random.default_rng(5)
    sizes = (784, 128, 64, 10)
    n_spk = rng.integers(0, 129, (4, 3, 11)).astype(np.int32)
    n_en = rng.integers(0, 65, (4, 3, 11)).astype(np.int32)
    tiles = rng.integers(0, 5, (4, 3, 2)).astype(np.int32)
    want = jtel.ChunkTelemetry(jnp.asarray(n_spk), jnp.asarray(n_en),
                               jnp.asarray(tiles)).densities(sizes)
    got = ttel.ChunkTelemetry(torch.from_numpy(n_spk), torch.from_numpy(n_en),
                              torch.from_numpy(tiles)).densities(sizes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [0, 1, 9])
def test_stability_init_matches_jax(batch):
    want = jee.stability_init(batch)
    got = tee.stability_init(batch, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one gate step from the fresh state agrees too
    pred = np.arange(batch, dtype=np.int32) % 3
    gs, gd = tee.stability_step(got, torch.from_numpy(pred), 1)
    ws, wd = jee.stability_step(want, jnp.asarray(pred), 1)
    np.testing.assert_array_equal(gs.prev.numpy(), np.asarray(ws.prev))
    np.testing.assert_array_equal(gs.streak.numpy(), np.asarray(ws.streak))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
