"""Parity of the port's active-pruning controller (``repro_torch.core.
pruning``) and energy model (``repro_torch.core.energy``) with the JAX
package's, on the CPU.

The same seeded numpy spikes, membranes and predictions go through both
packages.  Every pruning function is integer-equal; every energy
function gives equal counts, bytes and picojoules (tolerance 0), on numpy
inputs and on the port's tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jen
from repro.core import pruning as jpr
from repro_torch.core import energy as ten
from repro_torch.core import pruning as tpr


def _eq(got, want, what="", index=False):
    """Equal values and dtype; an argmax ``index`` is int64 in the port,
    as ``torch.argmax`` gives it (int32 in JAX)."""
    assert isinstance(got, torch.Tensor), what
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == (np.int64 if index else want.dtype), what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _counts(c):
    return type(c).__name__, dataclasses.astuple(c)


def _state_eq(got, want):
    for f in ("enable", "spike_reg", "first_spike_t"):
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("shape,horizon", [((4, 10), 20), ((3, 2, 7), 5)])
def test_init_pruning_state_matches_jax(shape, horizon):
    _state_eq(tpr.init_pruning_state(shape, horizon, device="cpu"),
              jpr.init_pruning_state(shape, horizon))


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_controller_run_and_readouts_match_jax(prune, density):
    """A T-step controller run on the same fired trains, then every
    readout of its state, the fired trains and a membrane trace."""
    rng = np.random.default_rng(int(density * 100) + prune)
    T, B, N = 12, 9, 10
    fired = rng.random((T, B, N)) < density
    vtr = rng.integers(-300, 300, (T, B, N)).astype(np.int32)
    vtr[:, 0, 3] = (1 << 24) + 5              # clipped below the fired tier
    ts = tpr.init_pruning_state((B, N), T, device="cpu")
    js = jpr.init_pruning_state((B, N), T)
    for t in range(T):
        ts = tpr.controller_step(ts, torch.from_numpy(fired[t]), t,
                                 prune=prune)
        js = jpr.controller_step(js, jnp.asarray(fired[t]), jnp.int32(t),
                                 prune=prune)
        _state_eq(ts, js)
    v_final = torch.from_numpy(vtr[-1])
    _eq(tpr.first_spike_readout(ts, v_final, T),
        jpr.first_spike_readout(js, jnp.asarray(vtr[-1]), T), index=True)
    _eq(tpr.count_readout(torch.from_numpy(fired)),
        jpr.count_readout(jnp.asarray(fired)), index=True)
    _eq(tpr.membrane_readout(torch.from_numpy(vtr)),
        jpr.membrane_readout(jnp.asarray(vtr)), index=True)
    _eq(tpr.peak_membrane_readout(torch.from_numpy(vtr)),
        jpr.peak_membrane_readout(jnp.asarray(vtr)), index=True)


@pytest.mark.parametrize("patience", [1, 2, 4, 30])
def test_stability_early_exit_matches_jax(patience):
    rng = np.random.default_rng(patience)
    T, B = 20, 64
    pred = rng.integers(0, 3, (T, B)).astype(np.int32)
    pred[:, :16] = pred[-1, :16]                    # stable from step 0
    pred[10:, 16:32] = pred[-1, 16:32]              # stable from step 10
    _eq(tpr.stability_early_exit(torch.from_numpy(pred), patience),
        jpr.stability_early_exit(jnp.asarray(pred), patience))


@pytest.mark.parametrize("n_in,n_out,hidden", [(784, 10, (32,)),
                                               (100, 7, ()),
                                               (784, 10, (128, 64))])
def test_static_counts_and_bytes_match_jax(n_in, n_out, hidden):
    assert _counts(ten.ann_op_counts(n_in, n_out, hidden)) == \
        _counts(jen.ann_op_counts(n_in, n_out, hidden))
    assert ten.ann_memory_bytes(n_in, n_out, hidden) == \
        jen.ann_memory_bytes(n_in, n_out, hidden)
    for bits in (8, 9):
        assert ten.snn_memory_bytes(n_in, n_out, bits) == \
            jen.snn_memory_bytes(n_in, n_out, bits)


def test_paper_table_ii_numbers():
    """784→32→10: 25,408 mults, 25,450 adds, 101,800 B; 784×10×9 bits."""
    ann = ten.ann_op_counts()
    assert (ann.multiplications, ann.additions) == (25_408, 25_450)
    assert ten.ann_memory_bytes() == 101_800.0
    assert ten.snn_memory_bytes() == 784 * 10 * 9 / 8


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("ndim", [1, 2])
def test_snn_op_counts_and_energy_match_jax(ndim, as_tensor):
    rng = np.random.default_rng(ndim)
    adds = rng.integers(0, 5000, (20,) + (8,) * (ndim - 1)).astype(np.int32)
    en = rng.integers(0, 11, 20).astype(np.int32)
    arg = torch.from_numpy(adds) if as_tensor else adds
    en_arg = torch.from_numpy(en) if as_tensor else en
    for kw in ({}, {"num_steps": 10}, {"enabled_per_step": en_arg},
               {"n_neurons": 7}):
        jkw = {k: (en if k == "enabled_per_step" else v)
               for k, v in kw.items()}
        got = ten.snn_op_counts(arg, **kw)
        want = jen.snn_op_counts(jnp.asarray(adds), **jkw)
        assert _counts(got) == _counts(want), kw
        for mult, add in (("int8_mult", "int32_add"),
                          ("fp32_mult", "fp32_add")):
            assert got.energy_pj(mult, add) == want.energy_pj(mult, add)
        tm = ten.EnergyModel(ann=ten.ann_op_counts(), snn=got)
        jm = jen.EnergyModel(ann=jen.ann_op_counts(), snn=want)
        assert (tm.ann_energy_pj, tm.snn_energy_pj, tm.energy_ratio) == \
            (jm.ann_energy_pj, jm.snn_energy_pj, jm.energy_ratio)
    assert ten.snn_op_counts(arg).multiplications == 0
