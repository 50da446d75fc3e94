"""Parity of the port's ``fused_streamed`` backend with the JAX package's, on
the CPU.

On CPU tensors the weight-streaming launcher runs the stack kernel's plain
version; it is held, integer for integer on every output and telemetry
leaf, against the JAX package's weight-streaming Pallas kernel in
interpret mode: the stack op gated and ungated, chunked and one-shot;
``snn_apply_int`` and the chunked window on every readout; and the
streaming engine across a weight rollout.
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
from repro.serve import SNNStreamEngine as JaxEngine
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import snn as tsnn
from repro_torch.core.telemetry import concat_telemetry
from repro_torch.kernels import fused_snn as tfused
from repro_torch.kernels import ops as tops
from repro_torch.serve import SNNStreamEngine

_LIF = dict(decay_shift=4, v_threshold=128)
# widths ≤ 256, one of them not a multiple of 128
_SIZES = (200, 256, 96, 10)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _codes(rng, sizes, mean=4.0, std=30.0):
    return [np.clip(np.round(rng.normal(mean, std, (i, o))), -256, 255)
            .astype(np.int16) for i, o in zip(sizes[:-1], sizes[1:])]


def _params(ws):
    return {"layers": [{"w_q": w, "scale": np.float32(1 / 128)} for w in ws]}


def _jax_params(ws):
    return {"layers": [{"w_q": jnp.asarray(w), "scale": jnp.float32(1 / 128)}
                       for w in ws]}


def _inputs(rng, b, n_in, seed):
    px = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    px[:, : n_in // 3] = 0
    return px, np.array(jprng.seed_state(seed, (b, n_in)))


def _same(got, want, msg):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{msg}[{i}]")
        return
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=msg)


def _compare(got, want, keys):
    for key in keys:
        _same(got[key], want[key], key)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _same(getattr(got["telemetry"], f), getattr(want["telemetry"], f), f)


_OP_KEYS = ("spike_counts", "v_trace", "first_spike_t", "v_final",
            "active_adds", "prng_state", "steps", "v", "en", "v_peak")


def _carry(res):
    return {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
            "counts": res["spike_counts"], "first": res["first_spike_t"],
            "steps": res["steps"]}


def _to_jax(tree):
    return None if tree is None else {
        k: (tuple(jnp.asarray(_np(a)) for a in v) if isinstance(v, tuple)
            else jnp.asarray(_np(v))) for k, v in tree.items()}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("readout,prune,sparse_skip", [
    ("count", False, True), ("first_spike", True, False),
    ("membrane", False, True)])
def test_streamed_op_chunks_match_jax_one_shot(gated, readout, prune,
                                               sparse_skip):
    """Four chunks of two steps through the port's streamed op equal one
    8-step launch of the JAX weight-streaming kernel, leaf for leaf."""
    rng = np.random.default_rng(len(readout) + 2 * gated)
    ws = _codes(rng, _SIZES)
    b = 11
    px, st = _inputs(rng, b, _SIZES[0], seed=5)
    gate = None
    if gated:
        active = np.ones(b, bool)
        active[[1, 7]] = False
        gate = {"active": active, "prev": np.full(b, -1, np.int32),
                "streak": np.zeros(b, np.int32)}
    kw = dict(active_pruning=prune, readout=readout, patience=2,
              sparse_skip=sparse_skip, **_LIF)
    want = jops.fused_snn_stack_op(
        jnp.asarray(px), jnp.asarray(st), tuple(jnp.asarray(w) for w in ws),
        num_steps=8, gate=_to_jax(gate), streamed=True, interpret=True, **kw)
    tw = tuple(torch.from_numpy(w) for w in ws)
    tgate = None if gate is None else {k: torch.from_numpy(v)
                                       for k, v in gate.items()}
    state, init, outs = torch.from_numpy(st.copy()), None, []
    before = tfused.fused_snn_stack_streamed.launches
    for _ in range(4):
        res = tops.fused_snn_stack_op(torch.from_numpy(px), state, tw,
                                      num_steps=8, chunk_steps=2, init=init,
                                      gate=tgate, streamed=True, **kw)
        outs.append(res)
        state, init, tgate = res["prng_state"], _carry(res), res.get("gate")
    assert tfused.fused_snn_stack_streamed.launches == before  # CPU: plain
    last = dict(outs[-1])
    for key in ("v_trace", "active_adds"):
        last[key] = torch.cat([o[key] for o in outs])
    last["telemetry"] = concat_telemetry(o["telemetry"] for o in outs)
    _compare(last, want, _OP_KEYS)
    if gated:
        for key in ("active", "prev", "streak"):
            _same(last["gate"][key], want["gate"][key], f"gate.{key}")
    assert int(last["spike_counts"].sum()) > 0


@pytest.mark.parametrize("readout", ["count", "first_spike", "membrane"])
def test_snn_apply_int_streamed_matches_jax(readout):
    rng = np.random.default_rng(len(readout))
    jc = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=6, readout=readout,
                             active_pruning=readout == "first_spike")
    tc = dataclasses.replace(tcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=6, readout=readout,
                             active_pruning=readout == "first_spike")
    ws = _codes(rng, _SIZES)
    px, st = _inputs(rng, 9, _SIZES[0], seed=3)
    want = jsnn.snn_apply_int(_jax_params(ws), jnp.asarray(px),
                              jnp.asarray(st), jc, backend="fused_streamed")
    got = tsnn.snn_apply_int(params_from_jax(_params(ws), device="cpu"),
                             torch.from_numpy(px), torch.from_numpy(st), tc,
                             backend="fused_streamed")
    _compare(got, want, ("pred", "spike_counts", "v_trace", "first_spike_t",
                         "v_final", "active_adds", "prng_state", "v_peak"))
    assert got["input_spikes"] is None


def test_window_chunks_streamed_match_jax():
    """The chunked window on ``fused_streamed`` (3 + 3 + 2 steps) walks
    through the JAX package's one-shot window state."""
    rng = np.random.default_rng(21)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=8, active_pruning=True)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=8, active_pruning=True)
    ws = _codes(rng, _SIZES)
    px, st = _inputs(rng, 5, _SIZES[0], seed=9)
    jp = _jax_params(ws)
    jstate = jsnn.snn_window_init(jp, jnp.asarray(st), jc)
    jstate, jout = jsnn.snn_window_chunk(jp, jnp.asarray(px), jstate, jc,
                                         chunk_steps=8,
                                         backend="fused_streamed")
    tp = params_from_jax(_params(ws), device="cpu")
    tstate = tsnn.snn_window_init(tp, torch.from_numpy(st), tc)
    chunks = []
    for n in (3, 3, 2):
        tstate, out = tsnn.snn_window_chunk(tp, torch.from_numpy(px), tstate,
                                            tc, chunk_steps=n,
                                            backend="fused_streamed")
        chunks.append(out)
    for field in tsnn.SNNWindowState._fields:
        _same(getattr(tstate, field), getattr(jstate, field), field)
    for key in ("v_trace", "active_adds"):
        _same(torch.cat([c[key] for c in chunks]), jout[key], key)
    tel = concat_telemetry(c["telemetry"] for c in chunks)
    for f in ("n_spk", "n_en", "tiles_skipped"):
        _same(getattr(tel, f), getattr(jout["telemetry"], f), f)


def _assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        for f in ("pred", "steps", "adds", "early_exit", "weight_version"):
            assert getattr(g, f) == getattr(w, f), (rid, f)
        np.testing.assert_array_equal(g.spike_counts,
                                      np.asarray(w.spike_counts))


def test_streamed_engine_matches_jax_across_rollout():
    rng = np.random.default_rng(30)
    jc = dataclasses.replace(jcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=8)
    tc = dataclasses.replace(tcfgs.SNN_CONFIG_DEEP, layer_sizes=_SIZES,
                             num_steps=8)
    old, new = _codes(rng, _SIZES), _codes(rng, _SIZES, mean=-1.0)
    imgs = rng.integers(0, 256, (8, _SIZES[0]), dtype=np.uint8)
    kw = dict(batch_size=3, chunk_steps=3, patience=2, seed=4,
              backend="fused_streamed")
    jeng = JaxEngine(_jax_params(old), jc, **kw)
    teng = SNNStreamEngine(params_from_jax(_params(old), device="cpu"), tc,
                           device="cpu", **kw)
    assert teng.backend == "fused_streamed"
    results = []
    for eng, new_p in ((jeng, _jax_params(new)),
                       (teng, params_from_jax(_params(new), device="cpu"))):
        for im in imgs[:4]:
            eng.submit(im)
        eng.step()
        eng.begin_rollout(new_p)
        for im in imgs[4:]:
            eng.submit(im)
        results.append(eng.run())
    _assert_results_equal(results[1], results[0])
    assert {r.weight_version for r in results[1].values()} == {0, 1}
    assert any(r.early_exit for r in results[1].values())


def test_streamed_smem_model():
    """The streamed carve-up holds WIDE, which the resident one refuses,
    and keeps its layout's arithmetic."""
    wide = (896, 2048, 2048, 128)
    assert tfused.stack_smem_bytes(wide) > tfused.SMEM_LIMIT_BYTES
    need = tfused.stack_streamed_smem_bytes(wide)
    assert need == (3 * 64 * 128 * 2 + 8 * (896 * 5 + 2 * 64 * 4 + 2048 * 2)
                    + 4 * (7 + 16 + 16 + 16 + 16 + 1) + 4 * 16 + 16
                    + 2048 * 2)
    assert need <= tfused.SMEM_LIMIT_BYTES
    wider = (896, 16384, 128)
    assert tfused.stack_streamed_smem_bytes(wider) > tfused.SMEM_LIMIT_BYTES
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=(784, 16384, 10))
    assert "streamed working set" in tsnn.fused_unsupported_reason(
        cfg, 2, streamed=True)
    assert tsnn.resolve_backend(cfg, n_layers=2, device="cuda") == "staged"
