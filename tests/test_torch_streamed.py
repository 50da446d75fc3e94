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
    """The streamed carve-up holds WIDE, which the resident one refuses, and
    keeps its layout's arithmetic: a ring of 2 × 4 chunks of 256 A
    fragments of 16 bytes, a word of enable bits per thread and 256-column
    pass (two passes per 2,048-wide hidden layer in a cluster of 6, one
    for the head), two bitmaps of 64 lanes at a row stride of 2 mod 32
    words, per-layer lane and block counters, one N-tile bit word per
    8-lane block and layer (rank 0's and the CTA's own), five per-lane
    ints, and, only where the whole fits, 16 warps' stages of 64 lanes ×
    16 columns of v and v_peak.  Without the stages it holds every stack
    with a head of at most 128 columns that the slab kernel it replaced
    held, at one hidden layer and at seven."""
    wide = (896, 2048, 2048, 128)
    stage, ring = 16 * 2 * 64 * 16, 2 * 4 * 256 * 4
    limit = tfused.SMEM_LIMIT_BYTES
    assert tfused.stack_smem_bytes(wide) > limit
    need = tfused.stack_streamed_smem_bytes(wide)
    assert need == 4 * (stage + ring + 512 * (2 + 2 + 1) + 2 * 64 * (64 + 2)
                        + 3 * (2 * 64 + 8) + 2 * 8 * 3 + 5 * 64)
    assert need == 210_976 <= limit
    # the stride pads 28 words (896 bits) to 34; a 4,096-wide layer takes
    # 3 passes in a cluster of 6 and its 32 N tiles one bit word per block;
    # with its stages it would need 241,088 B, so it has none
    assert [tfused._stream_passes(n) for n in (128, 2048, 4096, 7168)] == \
        [1, 2, 3, 5]
    rest = 4 * (ring + 512 * (3 + 1) + 2 * 64 * (128 + 2) + 2 * (2 * 64 + 8)
                + 2 * 8 * (1 + 1) + 5 * 64)
    assert rest + 4 * stage == 241_088 > limit
    assert tfused.stack_streamed_smem_bytes((896, 4096, 128)) == rest
    assert tfused.stack_streamed_smem_bytes((896, 7168, 128)) == 4 * (
        ring + 512 * (5 + 1) + 2 * 64 * (224 + 2) + 2 * (2 * 64 + 8)
        + 2 * 8 * (2 + 1) + 5 * 64) == 163_328
    assert tfused.stack_streamed_smem_bytes((896, 128)) == 4 * (
        stage + ring + 512 + 2 * 64 * 34 + (2 * 64 + 8) + 2 * 8 + 5 * 64)
    # the widest stacks with stages, and without: 3,072 and 10,240 columns
    # at one hidden layer (a 3,200-wide one is far below the 128 KB stages)
    assert tfused.stack_streamed_smem_bytes((896, 3072, 128)) == 4 * (
        stage + ring + 512 * (2 + 1) + 2 * 64 * (96 + 2) + 2 * (2 * 64 + 8)
        + 2 * 8 * (1 + 1) + 5 * 64) <= limit
    assert tfused.stack_streamed_smem_bytes((896, 3200, 128)) < 4 * stage
    held = [n for n in range(128, 16385, 128)
            if tfused.stack_streamed_smem_bytes((896, n, 128)) <= limit]
    assert max(held) == 10240 and held == list(range(128, 10241, 128))

    def slab_kernel(sizes):                 # the carve-up K2 had before
        k0, outs = sizes[0], sizes[1:]
        w = max(sizes)
        flags = sum(k // 128 for k in sizes[:-1]) + sum(n // 128 for n in outs)
        return (3 * 64 * 128 * 2 + 8 * (k0 * 5 + 2 * (w // 32) * 4 + w * 2)
                + 4 * flags + 4 * (w // 128) + 16 + w * 2)

    for hidden in (1, 7):
        for n in range(128, 16385, 128):
            sizes = (896,) + (n,) * hidden + (128,)
            if slab_kernel(sizes) <= limit:
                assert tfused.stack_streamed_smem_bytes(sizes) <= limit, sizes
    wider = (896, 16384, 128)
    assert tfused.stack_streamed_smem_bytes(wider) > limit
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG, layer_sizes=(784, 16384, 10))
    assert "streamed working set" in tsnn.fused_unsupported_reason(
        cfg, 2, streamed=True)
    assert tsnn.resolve_backend(cfg, n_layers=2, device="cuda") == "staged"


def _padded_planes(ws):
    """Each layer's codes LANE-padded and packed, as the engine places them."""
    out = []
    for w in ws:
        k, n = w.shape
        pad = np.zeros((k + (-k) % 128, n + (-n) % 128), np.int16)
        pad[:k, :n] = w
        out.append(tfused.pack_weights(torch.from_numpy(pad)))
    return tuple(out)


@pytest.mark.parametrize("gated", [False, True])
def test_streamed_plain_on_planes_equals_codes_and_jax(gated):
    """The stack's plain version on packed planes equals it on the codes,
    output for output, and, cut back by the op, the JAX package's
    weight-streaming kernel (interpret mode) on the same inputs; codes at
    -256 and 255 in every column exercise both planes' extremes."""
    rng = np.random.default_rng(40 + gated)
    ws = _codes(rng, _SIZES)
    ws[1][0::3], ws[1][1::3] = -256, 255
    b = 13
    px, st = _inputs(rng, b, _SIZES[0], seed=6)
    gate = None
    if gated:
        active = np.ones(b, bool)
        active[[0, 9]] = False
        gate = {"active": active, "prev": np.full(b, -1, np.int32),
                "streak": np.zeros(b, np.int32)}
    tgate = None if gate is None else {k: torch.from_numpy(v)
                                       for k, v in gate.items()}
    args, meta = tops.stack_operands(
        torch.from_numpy(px), torch.from_numpy(st.copy()),
        tuple(torch.from_numpy(w) for w in ws), num_steps=6, gate=tgate,
        streamed=True)
    kw = dict(chunk_steps=6, window_steps=6, patience=2, readout="count",
              block_b=meta["block_b"], **_LIF)
    codes = tuple(torch.from_numpy(np.pad(w, ((0, (-w.shape[0]) % 128),
                                              (0, (-w.shape[1]) % 128))))
                  for w in ws)
    on_codes = tfused.fused_snn_stack_plain(*args[:2], codes, *args[3:],
                                            **kw)
    planes = _padded_planes(ws)
    for w, c in zip(planes, codes):
        assert tfused.is_planes(w)
        np.testing.assert_array_equal(tfused.unpack_weights(w).numpy(),
                                      c.numpy())
    on_planes = tfused.fused_snn_stack_plain(*args[:2], planes, *args[3:],
                                             **kw)
    _same(list(on_planes[:10]), list(on_codes[:10]), "planes vs codes")
    if gated:
        _same(on_planes[10], on_codes[10], "gate")
    want = jops.fused_snn_stack_op(
        jnp.asarray(px), jnp.asarray(st), tuple(jnp.asarray(w) for w in ws),
        num_steps=6, gate=_to_jax(gate), streamed=True, interpret=True,
        patience=2, **_LIF)
    got = tops.stack_results(on_planes, meta)
    _compare(got, want, _OP_KEYS)
    if gated:
        for key in ("active", "prev", "streak"):
            _same(got["gate"][key], want["gate"][key], f"gate.{key}")
    assert int(got["spike_counts"].sum()) > 0


def test_streamed_op_takes_codes_or_planes():
    """``fused_snn_stack_op(streamed=True)`` gives the same results on the
    codes and on their placed planes with the true widths; planes without
    the widths, planes of the wrong shape and planes for the resident
    kernel are refused, and so are codes handed to the streamed kernel's
    wrapper."""
    rng = np.random.default_rng(44)
    ws = _codes(rng, _SIZES)
    px, st = _inputs(rng, 9, _SIZES[0], seed=8)
    kw = dict(num_steps=5, chunk_steps=3, active_pruning=True, **_LIF)
    tpx, tst = torch.from_numpy(px), torch.from_numpy(st)
    codes = tuple(torch.from_numpy(w) for w in ws)
    planes = _padded_planes(ws)
    want = tops.fused_snn_stack_op(tpx, tst, codes, streamed=True, **kw)
    got = tops.fused_snn_stack_op(tpx, tst, planes, streamed=True,
                                  layer_sizes=_SIZES, **kw)
    _compare(got, {k: _np(v) if isinstance(v, torch.Tensor) else v
                   for k, v in want.items()}, _OP_KEYS)
    with pytest.raises(ValueError, match="layer_sizes"):
        tops.fused_snn_stack_op(tpx, tst, planes, streamed=True, **kw)
    with pytest.raises(ValueError, match="placed planes"):
        tops.fused_snn_stack_op(tpx, tst, planes, streamed=True,
                                layer_sizes=(200, 256, 200, 10), **kw)
    with pytest.raises(ValueError, match="resident"):
        tops.fused_snn_stack_op(tpx, tst, planes, layer_sizes=_SIZES, **kw)
    # the streamed kernel's wrapper itself takes planes only
    args, meta = tops.stack_operands(tpx, tst, codes, num_steps=5)
    with pytest.raises(ValueError, match="int8 planes"):
        tfused.fused_snn_stack_streamed(*args, chunk_steps=3, window_steps=5,
                                        decay_shift=4, v_threshold=128,
                                        block_b=meta["block_b"])


def test_wide_streamed_engine_places_planes_once():
    """A WIDE-shaped engine on ``fused_streamed`` places each weight
    version once as LANE-padded int8 planes, packs and pads no weight in
    any chunk, and returns the reference backend's results id for id,
    across a rollout."""
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.serve import snn_engine

    rng = np.random.default_rng(46)
    cfg = dataclasses.replace(tcfgs.SNN_CONFIG_WIDE, num_steps=8)
    sizes = cfg.layer_sizes

    def params(mean):
        return _params([np.clip(np.round(rng.normal(
            mean, 170 / np.sqrt(i), (i, o))), -256, 255).astype(np.int16)
            for i, o in zip(sizes[:-1], sizes[1:])])

    old, new = params(0.0), params(0.5)
    imgs = rng.integers(0, 256, (12, sizes[0]), dtype=np.uint8)
    imgs[:, ::3] = 0
    packs, weight_pads = [], []
    pack, pad2 = snn_engine.pack_weights, ops_mod._pad2

    def counting_pack(w):
        packs.append(tuple(w.shape))
        return pack(w)

    def watching_pad2(x, rows, lanes):
        if x.dtype in (torch.int8, torch.int16):
            weight_pads.append(tuple(x.shape))
        return pad2(x, rows, lanes)

    runs = {}
    for backend in ("fused_streamed", "reference"):
        kw = dict(batch_size=8, chunk_steps=4, patience=2, seed=5,
                  backend=backend, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(snn_engine, "pack_weights", counting_pack)
            mp.setattr(tfused, "pack_weights", counting_pack)
            mp.setattr(ops_mod, "_pad2", watching_pad2)
            eng = SNNStreamEngine(old, cfg, **kw)
            placed = len(packs)
            for im in imgs[:6]:
                eng.submit(im)
            eng.step()
            eng.begin_rollout(new)
            rolled = len(packs)
            for im in imgs[6:]:
                eng.submit(im)
            runs[backend] = eng.run()
            assert len(packs) == rolled and not weight_pads
        if backend == "fused_streamed":
            assert (placed, rolled) == (3, 6)
            for w, (i, o) in zip(eng.weights, zip(sizes[:-1], sizes[1:])):
                assert tfused.is_planes(w) and w.is_contiguous()
                assert tuple(w.shape) == (2, o + (-o) % 128, i + (-i) % 128)
        else:                                 # codes, nothing packed
            assert (placed, rolled) == (0, 0)
        packs.clear()
    _assert_results_equal(runs["fused_streamed"], runs["reference"])
    assert {r.weight_version for r in runs["reference"].values()} == {0, 1}


def test_data_mesh_places_planes_for_the_streamed_kernel():
    """Without a model axis, ``shard_weights(planes=True)`` places each
    layer once per device as its LANE-padded planes, which unpack to the
    padded codes."""
    from repro_torch.serve import shard_weights

    rng = np.random.default_rng(48)
    ws = _codes(rng, _SIZES)
    cpu = torch.device("cpu")
    placed = shard_weights(tuple(torch.from_numpy(w) for w in ws),
                           [[cpu], [cpu]], None, planes=True)
    for layer, w, want in zip(placed[0], ws, _padded_planes(ws)):
        assert tfused.is_planes(layer) and layer.is_contiguous()
        np.testing.assert_array_equal(layer.numpy(), want.numpy())
        np.testing.assert_array_equal(
            tfused.unpack_weights(layer).numpy()[:w.shape[0], :w.shape[1]], w)
    assert placed[1][0] is placed[0][0]
