"""Parity of the port's integer SNN (``repro_torch.core``) with the JAX
package, on the CPU.

Same seeded numpy inputs through ``repro.core.snn`` and
``repro_torch.core.snn``; every output, telemetry leaf included, must be
integer-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snn_mnist as jcfgs
from repro.core import lif as jlif
from repro.core import prng as jprng
from repro.core import snn as jsnn
from repro.kernels import ops as jops
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import lif as tlif
from repro_torch.core import snn as tsnn
from repro_torch.kernels import ops as tops

_CONFIGS = ["SNN_CONFIG", "SNN_CONFIG_PRUNED", "SNN_CONFIG_DEEP"]


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _codes(rng, sizes):
    """Seeded signed 9-bit codes, centred so that some neurons fire."""
    return {"layers": [
        {"w_q": np.clip(np.round(rng.normal(6, 40, (i, o))), -256, 255)
         .astype(np.int16), "scale": np.float32(1 / 128)}
        for i, o in zip(sizes[:-1], sizes[1:])]}


def _jax_params(p):
    return {"layers": [{"w_q": jnp.asarray(l["w_q"]),
                        "scale": jnp.float32(l["scale"])}
                       for l in p["layers"]]}


def _inputs(rng, b, n_in, seed):
    px = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    px[:, : n_in // 4] = 0                            # MNIST-like dark border
    return px, np.array(jprng.seed_state(seed, (b, n_in)))


def _assert_same(got, want, msg=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{msg}[{i}]")
        return
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("name", _CONFIGS + ["SNN_CONFIG_WIDE"])
def test_configs_match_jax(name):
    j, t = getattr(jcfgs, name), getattr(tcfgs, name)
    for f in dataclasses.fields(t):
        if f.name == "lif":
            assert dataclasses.asdict(t.lif) == dataclasses.asdict(j.lif)
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("prune", [False, True])
def test_run_lif_int_matches_jax(prune):
    rng = np.random.default_rng(1)
    spikes = rng.random((9, 4, 60)) < 0.3
    w = np.clip(np.round(rng.normal(10, 50, (60, 12))), -256, 255) \
        .astype(np.int16)
    cfg = jlif.LIFConfig(decay_shift=3, v_threshold=100)
    want = jlif.run_lif_int(jnp.asarray(spikes), jnp.asarray(w), cfg,
                            active_pruning=prune)
    got = tlif.run_lif_int(torch.from_numpy(spikes), torch.from_numpy(w),
                           tlif.LIFConfig(decay_shift=3, v_threshold=100),
                           active_pruning=prune)
    for key in ("spikes", "v_trace", "active_adds"):
        _assert_same(got[key], want[key], key)
    _assert_same(got["state"].v, want["state"].v, "v")
    _assert_same(got["state"].enable, want["state"].enable, "enable")


@pytest.mark.parametrize("readout", ["count", "first_spike", "membrane"])
@pytest.mark.parametrize("name", _CONFIGS)
def test_snn_apply_int_reference_matches_jax(name, readout):
    rng = np.random.default_rng(len(name) + len(readout))
    jc = dataclasses.replace(getattr(jcfgs, name), readout=readout,
                             backend="reference")
    tc = dataclasses.replace(getattr(tcfgs, name), readout=readout,
                             backend="reference")
    p = _codes(rng, jc.layer_sizes)
    px, st = _inputs(rng, 6, jc.n_in, seed=7)
    want = jsnn.snn_apply_int(_jax_params(p), jnp.asarray(px),
                              jnp.asarray(st), jc)
    got = tsnn.snn_apply_int(params_from_jax(p, device="cpu"),
                             torch.from_numpy(px), torch.from_numpy(st), tc)
    for key in ("pred", "spike_counts", "v_trace", "first_spike_t",
                "v_final", "active_adds", "prng_state", "input_spikes",
                "v_peak"):
        _assert_same(got[key], want[key], key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _assert_same(getattr(got["telemetry"], f),
                     getattr(want["telemetry"], f), f)
    assert int(got["spike_counts"].sum()) > 0       # the test has spikes


@pytest.mark.parametrize("name", _CONFIGS)
def test_fused_backend_on_cpu_equals_reference(name):
    """``backend="fused"`` on CPU tensors runs the kernel's plain version
    through the same op wrapper the card uses."""
    rng = np.random.default_rng(3)
    cfg = getattr(tcfgs, name)
    p = params_from_jax(_codes(rng, cfg.layer_sizes), device="cpu")
    px, st = _inputs(rng, 5, cfg.n_in, seed=2)
    outs = {b: tsnn.snn_apply_int(p, torch.from_numpy(px),
                                  torch.from_numpy(st), cfg, backend=b)
            for b in ("reference", "fused")}
    for key in ("pred", "spike_counts", "v_trace", "first_spike_t",
                "v_final", "active_adds", "prng_state", "v_peak"):
        _assert_same(outs["fused"][key], _np_tree(outs["reference"][key]),
                     key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _assert_same(getattr(outs["fused"]["telemetry"], f),
                     _np(getattr(outs["reference"]["telemetry"], f)), f)
    assert outs["fused"]["input_spikes"] is None


def _np_tree(x):
    return tuple(_np(a) for a in x) if isinstance(x, tuple) else _np(x)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("prune", [False, True])
def test_window_chunks_match_jax_one_shot(backend, prune):
    """The port's chunked window (4 + 3 + 2 + 1 steps) walks through the
    same state as the JAX package's one-shot window."""
    rng = np.random.default_rng(17)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, num_steps=10,
                             active_pruning=prune)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG_DEEP, num_steps=10,
                             active_pruning=prune)
    p = _codes(rng, jc.layer_sizes)
    px, st = _inputs(rng, 4, jc.n_in, seed=23)
    jp = _jax_params(p)
    jstate = jsnn.snn_window_init(jp, jnp.asarray(st), jc)
    jstate, jout = jsnn.snn_window_chunk(jp, jnp.asarray(px), jstate, jc,
                                         chunk_steps=10, backend="reference")
    tp = params_from_jax(p, device="cpu")
    tstate = tsnn.snn_window_init(tp, torch.from_numpy(st), tc)
    traces, adds, tels = [], [], []
    for n in (4, 3, 2, 1):
        tstate, out = tsnn.snn_window_chunk(tp, torch.from_numpy(px), tstate,
                                            tc, chunk_steps=n,
                                            backend=backend)
        traces.append(out["v_trace"])
        adds.append(out["active_adds"])
        tels.append(out["telemetry"])
    for field in tsnn.SNNWindowState._fields:
        _assert_same(getattr(tstate, field), getattr(jstate, field), field)
    _assert_same(torch.cat(traces), jout["v_trace"], "v_trace")
    _assert_same(torch.cat(adds), jout["active_adds"], "active_adds")
    from repro_torch.core.telemetry import concat_telemetry
    tel = concat_telemetry(tels)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _assert_same(getattr(tel, f), getattr(jout["telemetry"], f), f)


def test_readout_pred_ties_and_long_windows():
    counts = torch.tensor([[1, 0], [2, 2]], dtype=torch.int32)
    first = torch.tensor([[0, 4096], [3, 3]], dtype=torch.int32)
    v_final = torch.tensor([[0, (1 << 24) - 2], [5, 5]], dtype=torch.int32)
    for T in (20, 128, 4096):
        for readout in ("count", "first_spike"):
            got = tsnn.readout_pred(counts, first, v_final, readout, T)
            want = jsnn.readout_pred(jnp.asarray(counts.numpy()),
                                     jnp.asarray(first.numpy()),
                                     jnp.asarray(v_final.numpy()),
                                     readout, T)
            _assert_same(got, want, f"{readout} T={T}")
        assert tsnn.readout_pred(counts, first, v_final, "first_spike",
                                 T).tolist() == [0, 0]


def test_resolve_backend_hopper_model():
    """On a CUDA device ``auto`` walks fused → fused_streamed → staged by the
    kernels' shared-memory model (pure logic, no card needed); the engine
    and the chunked window stop at fused_streamed and raise past it; plain
    PyTorch runs on the card only when named."""
    import types
    from repro_torch.serve import SNNStreamEngine
    cfg = tcfgs.SNN_CONFIG
    assert tsnn.resolve_backend(cfg, device="cpu") == "reference"
    assert tsnn.resolve_backend(cfg, device="cuda",
                                layer_sizes=cfg.layer_sizes) == "fused"
    deep = tcfgs.SNN_CONFIG_DEEP
    assert tsnn.resolve_backend(deep, n_layers=3, device="cuda") == "fused"
    wide = tcfgs.SNN_CONFIG_WIDE
    assert tsnn.fused_unsupported_reason(wide, 3) is not None
    assert tsnn.fused_unsupported_reason(wide, 3, streamed=True) is None
    for b in (None, "auto", "fused_streamed"):
        assert tsnn.resolve_backend(wide, b, 3,
                                    device="cuda") == "fused_streamed"
    with pytest.raises(ValueError, match="does not support.*fused_streamed"):
        tsnn.resolve_backend(wide, "fused", 3, device="cuda")
    # nine layers of 64: past both stack kernels' 8-layer parameter block
    narrow = (64,) * 10
    ncfg = dataclasses.replace(deep, layer_sizes=narrow)
    for streamed in (False, True):
        assert "8-layer" in tsnn.fused_unsupported_reason(ncfg, 9,
                                                          streamed=streamed)
    assert tsnn.resolve_backend(ncfg, n_layers=9, device="cuda") == "staged"
    with pytest.raises(ValueError, match="fused_streamed.*'staged'"):
        tsnn.resolve_backend(ncfg, "fused_streamed", 9, device="cuda")
    p = {"layers": [{"w_q": np.zeros((64, 64), np.int16)}] * 9}
    with pytest.raises(ValueError, match="no resumable stack kernel"):
        SNNStreamEngine(p, ncfg, device="cuda")
    on_card = types.SimpleNamespace(shape=(4, 64), device=torch.device("cuda"))
    state = tsnn.snn_window_init(p, torch.ones((4, 64), dtype=torch.int32)
                                 .view(torch.uint32), ncfg)
    for b in (None, "staged"):
        with pytest.raises(ValueError, match="cannot resume mid-window"):
            tsnn.snn_window_chunk(p, on_card, state, ncfg, chunk_steps=4,
                                  backend=b)
    with pytest.raises(ValueError, match="cannot resume"):
        SNNStreamEngine(p, ncfg, backend="staged", device="cpu")
    # reference on the card only by name
    for c, n in ((cfg, 1), (wide, 3), (ncfg, 9)):
        assert tsnn.resolve_backend(c, "reference", n,
                                    device="cuda") == "reference"
        assert tsnn.resolve_backend(c, n_layers=n, device="cpu") == \
            "reference"
    with pytest.raises(ValueError, match="unknown"):
        tsnn.resolve_backend(cfg, "nope", device="cuda")
    assert tsnn.fused_unsupported_reason(cfg, 0) is not None


@pytest.mark.parametrize("bad", [256, -257, 1000])
def test_validate_weight_codes_matches_jax(bad):
    """Trap: codes outside [-256, 255] are refused by both packages with
    the same message."""
    w = np.zeros((5, 3), np.int16)
    w[2, 1] = bad
    with pytest.raises(ValueError) as jerr:
        jops.validate_weight_codes((jnp.asarray(w),))
    with pytest.raises(ValueError) as terr:
        tops.validate_weight_codes((torch.from_numpy(w),))
    assert str(terr.value) == str(jerr.value)
    tops.validate_weight_codes((torch.full((2, 2), -256,
                                           dtype=torch.int16),
                                torch.full((2, 2), 255, dtype=torch.int16)))


def test_params_from_jax_roundtrip():
    rng = np.random.default_rng(0)
    p = _codes(rng, (20, 7, 3))
    got = params_from_jax(p, device="cpu")
    assert [l["w_q"].dtype for l in got["layers"]] == [torch.int16] * 2
    for g, w in zip(got["layers"], p["layers"]):
        np.testing.assert_array_equal(g["w_q"].numpy(), w["w_q"])
        assert g["scale"] == pytest.approx(float(w["scale"]))
    with pytest.raises(TypeError):
        params_from_jax({"layers": [{"w_q": np.zeros((2, 2)),
                                     "scale": 1.0}]}, device="cpu")
