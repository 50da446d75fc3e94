"""Parity of the port's ``SNNConfig`` fields ``weight_bits``,
``fuse_encoder`` and ``emit_trace`` with the JAX package, on the CPU
(the training fields ``qat``, ``surrogate_slope`` and ``train_threshold``
default alike too).

The speculative-dispatch default (``overlap``) of the mesh config and the
sharded engine equals the JAX package's.

The reference backend's ``snn_apply_int`` of both packages on the same
seeded numpy inputs, in all four (``fuse_encoder``, ``emit_trace``)
settings, on one layer (where the fused-encoder scan runs and
``emit_trace`` off drops the trace) and on two (where both packages run
the per-layer scans whatever the fields say).  Every output is
integer-equal, and None exactly where the JAX result is None.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.core import prng as jprng
from repro.core import snn as jsnn
from repro.serve import snn_engine as jeng
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import snn as tsnn
from repro_torch.serve import snn_engine as teng

_KEYS = ("pred", "spike_counts", "v_trace", "first_spike_t", "v_final",
         "active_adds", "prng_state", "input_spikes", "v_peak")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want, msg):
    if want is None:
        assert got is None, msg
        return
    assert got is not None, msg
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{msg}[{i}]")
        return
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=msg)


def test_config_fields_default_as_in_jax():
    t, j = tsnn.SNNConfig(), jsnn.SNNConfig()
    for f in ("weight_bits", "fuse_encoder", "emit_trace", "qat",
              "surrogate_slope", "train_threshold"):
        assert getattr(t, f) == getattr(j, f), f


def test_overlap_defaults_as_in_jax():
    """Speculation is on by default in both packages: the mesh config's
    field and the sharded engine's argument."""
    assert tcfgs.SNNStreamMeshConfig().overlap == \
        jcfgs.SNNStreamMeshConfig().overlap is True

    def default(cls):
        return inspect.signature(cls).parameters["overlap"].default

    assert default(teng.ShardedSNNStreamEngine) == \
        default(jeng.ShardedSNNStreamEngine) is True


@pytest.mark.parametrize("readout", ["count", "first_spike"])
@pytest.mark.parametrize("sizes", [(200, 12), (200, 24, 12)])
@pytest.mark.parametrize("emit_trace", [True, False])
@pytest.mark.parametrize("fuse_encoder", [False, True])
def test_snn_apply_int_fields_match_jax(fuse_encoder, emit_trace, sizes,
                                        readout):
    rng = np.random.default_rng(sum(sizes) + 2 * fuse_encoder + emit_trace)
    kw = dict(layer_sizes=sizes, readout=readout, backend="reference",
              fuse_encoder=fuse_encoder, emit_trace=emit_trace,
              active_pruning=readout == "first_spike")
    jc = dataclasses.replace(jcfgs.SNN_CONFIG, **kw)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG, **kw)
    p = {"layers": [
        {"w_q": np.clip(np.round(rng.normal(8, 40, (i, o))), -256, 255)
         .astype(np.int16), "scale": np.float32(1 / 128)}
        for i, o in zip(sizes[:-1], sizes[1:])]}
    px = rng.integers(0, 256, (5, sizes[0]), dtype=np.uint8)
    st = np.array(jprng.seed_state(11, (5, sizes[0])))
    want = jsnn.snn_apply_int(
        {"layers": [{"w_q": jnp.asarray(l["w_q"]),
                     "scale": jnp.float32(l["scale"])}
                    for l in p["layers"]]},
        jnp.asarray(px), jnp.asarray(st), jc)
    got = tsnn.snn_apply_int(params_from_jax(p, device="cpu"),
                             torch.from_numpy(px), torch.from_numpy(st), tc)
    for key in _KEYS:
        _assert_same(got[key], want[key], key)
    if want["telemetry"] is None:
        assert got["telemetry"] is None
    else:
        for f in ("n_spk", "n_en", "tiles_skipped"):
            _assert_same(getattr(got["telemetry"], f),
                         getattr(want["telemetry"], f), f)
    # the trace is dropped only where the fused-encoder scan runs
    dropped = fuse_encoder and not emit_trace and len(sizes) == 2
    assert (got["v_trace"] is None) == dropped
    assert int(got["spike_counts"].sum()) > 0       # the test has spikes
