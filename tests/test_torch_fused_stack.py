"""Parity of the port's encode→LIF stack op with the JAX package, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.fused_snn_stack_op`` runs the
kernel's plain version (``fused_snn_stack_plain``).  It is held, integer for
integer on every output and telemetry leaf, against the JAX package's
``fused_snn_stack_op`` (Pallas in interpret mode, as the JAX tests run it)
and its independent oracle ``fused_snn_stack_ref``: gated and ungated,
chunked and one-shot, ``sparse_skip`` on and off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.core import snn as tsnn
from repro_torch.kernels import fused_snn as tfused
from repro_torch.kernels import ops as tops

_LIF = dict(decay_shift=4, v_threshold=128)
_KEYS = ("spike_counts", "v_trace", "first_spike_t", "v_final",
         "active_adds", "prng_state", "steps")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _weights(rng, sizes, mean=6.0):
    return [np.clip(np.round(rng.normal(mean, 40, (i, o))), -256, 255)
            .astype(np.int16) for i, o in zip(sizes[:-1], sizes[1:])]


def _inputs(rng, b, n_in, seed):
    px = rng.integers(0, 256, (b, n_in), dtype=np.uint8)
    px[:, : n_in // 3] = 0
    return px, np.array(jprng.seed_state(seed, (b, n_in)))


def _to_jax(tree):
    if tree is None:
        return None
    return {k: (tuple(jnp.asarray(_np(a)) for a in v) if isinstance(v, tuple)
                else jnp.asarray(_np(v))) for k, v in tree.items()}


def _to_torch(tree):
    if tree is None:
        return None
    conv = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {k: (tuple(conv(a) for a in v) if isinstance(v, tuple)
                else conv(v)) for k, v in tree.items()}


def _compare(got, want, *, gated):
    for key in _KEYS:
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("v", "en", "v_peak"):
        for l, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_array_equal(_np(g), np.asarray(w),
                                          err_msg=f"{key}[{l}]")
    for f in ("n_spk", "n_en", "tiles_skipped"):
        np.testing.assert_array_equal(_np(getattr(got["telemetry"], f)),
                                      np.asarray(getattr(want["telemetry"],
                                                         f)), err_msg=f)
    if gated:
        for key in ("active", "prev", "streak"):
            np.testing.assert_array_equal(_np(got["gate"][key]),
                                          np.asarray(want["gate"][key]),
                                          err_msg=f"gate.{key}")


def _both(px, st, ws, **kw):
    """Run the port's op (CPU) and the JAX op (interpret mode)."""
    jkw = dict(kw, init=_to_jax(kw.get("init")), gate=_to_jax(kw.get("gate")))
    want = jops.fused_snn_stack_op(jnp.asarray(px), jnp.asarray(st),
                                   tuple(jnp.asarray(w) for w in ws),
                                   interpret=True, **jkw)
    tkw = dict(kw, init=_to_torch(kw.get("init")),
               gate=_to_torch(kw.get("gate")))
    before = tfused.fused_snn_stack.launches
    got = tops.fused_snn_stack_op(torch.from_numpy(px),
                                  torch.from_numpy(st.copy()),
                                  tuple(torch.from_numpy(w) for w in ws),
                                  **tkw)
    assert tfused.fused_snn_stack.launches == before   # CPU: no kernel
    return got, want


def _carry(res):
    return {"v": res["v"], "en": res["en"], "v_peak": res["v_peak"],
            "counts": res["spike_counts"], "first": res["first_spike_t"],
            "steps": res["steps"]}


@pytest.mark.parametrize("sparse_skip", [True, False])
@pytest.mark.parametrize("sizes,b,t,prune", [
    ((784, 10), 5, 8, False),
    ((784, 10), 12, 6, True),
    ((784, 128, 64, 10), 3, 5, False),
    ((200, 40, 10), 9, 6, True),
    # real widths through the resident kernel's operands: 100 inputs (the
    # op pads them to 112), 37 and 130 columns (no padding)
    ((100, 37, 10), 11, 8, False),
    ((784, 130, 10), 10, 6, True),
])
def test_ungated_matches_jax_kernel_and_oracle(sizes, b, t, prune,
                                               sparse_skip):
    rng = np.random.default_rng(b * 31 + t)
    ws = _weights(rng, sizes)
    px, st = _inputs(rng, b, sizes[0], seed=b)
    kw = dict(num_steps=t, active_pruning=prune, sparse_skip=sparse_skip,
              **_LIF)
    got, want = _both(px, st, ws, **kw)
    _compare(got, want, gated=False)
    oracle = jref.fused_snn_stack_ref(jnp.asarray(px), jnp.asarray(st),
                                      tuple(jnp.asarray(w) for w in ws), **kw)
    _compare(got, oracle, gated=False)
    assert int(got["spike_counts"].sum()) > 0
    if not sparse_skip:
        assert int(got["telemetry"].tiles_skipped.abs().sum()) == 0


@pytest.mark.parametrize("sparse_skip", [True, False])
def test_chunked_equals_jax_one_shot(sparse_skip):
    """Five chunks of four steps on the port == one 20-step JAX launch."""
    rng = np.random.default_rng(4)
    sizes = (784, 64, 10)
    ws = _weights(rng, sizes)
    px, st = _inputs(rng, 7, 784, seed=12)
    kw = dict(active_pruning=True, sparse_skip=sparse_skip, **_LIF)
    want = jops.fused_snn_stack_op(jnp.asarray(px), jnp.asarray(st),
                                   tuple(jnp.asarray(w) for w in ws),
                                   num_steps=20, interpret=True, **kw)
    tw = tuple(torch.from_numpy(w) for w in ws)
    state, init, outs = torch.from_numpy(st.copy()), None, []
    for _ in range(5):
        res = tops.fused_snn_stack_op(torch.from_numpy(px), state, tw,
                                      num_steps=20, chunk_steps=4,
                                      init=init, **kw)
        outs.append(res)
        state, init = res["prng_state"], _carry(res)
    last = dict(outs[-1])
    last["v_trace"] = torch.cat([o["v_trace"] for o in outs])
    last["active_adds"] = torch.cat([o["active_adds"] for o in outs])
    from repro_torch.core.telemetry import concat_telemetry
    last["telemetry"] = concat_telemetry(o["telemetry"] for o in outs)
    _compare(last, want, gated=False)


def _gate(b, active=None):
    act = np.ones(b, bool) if active is None else np.asarray(active, bool)
    return {"active": act, "prev": np.full(b, -1, np.int32),
            "streak": np.zeros(b, np.int32)}


@pytest.mark.parametrize("readout,prune,sizes", [
    ("count", False, (784, 10)),
    ("first_spike", True, (784, 10)),
    ("membrane", False, (784, 10)),
    ("count", False, (784, 128, 64, 10)),
    ("first_spike", True, (150, 48, 10)),
    ("count", False, (100, 37, 10)),
    ("membrane", True, (784, 130, 10)),
])
@pytest.mark.parametrize("sparse_skip", [True, False])
def test_gated_chunks_match_jax(readout, prune, sizes, sparse_skip):
    """Gated launches, chunk after chunk, with two lanes frozen from the
    start; the JAX kernel carries its own state, the port its own."""
    rng = np.random.default_rng(len(sizes) * 7 + len(readout))
    ws = _weights(rng, sizes)
    b = 11
    px, st = _inputs(rng, b, sizes[0], seed=3)
    active = np.ones(b, bool)
    active[[2, 9]] = False
    kw = dict(num_steps=20, chunk_steps=4, active_pruning=prune,
              readout=readout, patience=2, sparse_skip=sparse_skip, **_LIF)
    jstate, tstate = st, st.copy()
    jinit = tinit = None
    jgate, tgate = _gate(b, active), _gate(b, active)
    retired = 0
    for _ in range(5):
        want = jops.fused_snn_stack_op(
            jnp.asarray(px), jnp.asarray(jstate),
            tuple(jnp.asarray(w) for w in ws), init=jinit,
            gate=_to_jax(jgate), interpret=True,
            **{k: v for k, v in kw.items()})
        got = tops.fused_snn_stack_op(
            torch.from_numpy(px), torch.from_numpy(np.array(_np(tstate))),
            tuple(torch.from_numpy(w) for w in ws), init=tinit,
            gate=_to_torch(tgate), **kw)
        _compare(got, want, gated=True)
        jstate, jinit, jgate = want["prng_state"], _carry(want), want["gate"]
        tstate, tinit, tgate = got["prng_state"], _carry(got), got["gate"]
        retired = int((~_np(got["gate"]["active"])).sum())
    # the two lanes frozen from the start never moved
    for lane in (2, 9):
        assert int(_np(tinit["steps"])[lane]) == 0
        np.testing.assert_array_equal(_np(tstate)[lane], st[lane])
        assert int(_np(tinit["counts"])[lane].sum()) == 0
    assert retired > 2                  # some lanes retired early or finished


def test_gate_ties_go_to_first_index():
    """Identical weight columns make every output tie: the prediction is
    class 0 in both packages, under every readout."""
    rng = np.random.default_rng(8)
    col = np.clip(np.round(rng.normal(10, 30, (784, 1))), -256, 255)
    ws = [np.repeat(col, 10, axis=1).astype(np.int16)]
    px, st = _inputs(rng, 4, 784, seed=5)
    for readout in ("count", "first_spike", "membrane"):
        got, want = _both(px, st, ws, num_steps=20, chunk_steps=6,
                          readout=readout, patience=1, gate=_gate(4), **_LIF)
        _compare(got, want, gated=True)
        assert set(_np(got["gate"]["prev"]).tolist()) <= {-1, 0}


def test_first_spike_clip_saturated_membranes():
    """First-spike scores clip non-spiking membranes to 2^24 − 1, below the
    spiked tier: with a threshold above 2^24, class 3 fires first while
    class 7 sits just under the threshold, and the clip keeps class 7's
    larger membrane from outranking class 3's spike."""
    w = np.zeros((784, 10), np.int16)
    w[:, 3] = 255
    w[:, 7] = 240
    px = np.full((2, 784), 255, np.uint8)
    st = np.array(jprng.seed_state(1, px.shape))
    kw = dict(num_steps=92, chunk_steps=92, readout="first_spike",
              patience=1000, gate=_gate(2), decay_shift=30,
              v_threshold=(1 << 24) + (1 << 20), v_max=(1 << 26))
    got, want = _both(px, st, [w], **kw)
    _compare(got, want, gated=True)
    counts = _np(got["spike_counts"])
    assert (counts[:, 3] > 0).all() and (counts[:, 7] == 0).all()
    assert (_np(got["v_final"])[:, 7] > (1 << 24) + 100).all()
    assert _np(got["gate"]["prev"]).tolist() == [3, 3]


def test_tiles_skipped_block_geometry():
    """20 lanes → three 8-lane blocks (the last half padding); sparse input
    columns make whole K-tiles silent."""
    rng = np.random.default_rng(6)
    sizes = (784, 128, 10)
    ws = _weights(rng, sizes)
    px, st = _inputs(rng, 20, 784, seed=9)
    px[:, 256:640] = 0
    px[16:, :] = 0
    got, want = _both(px, st, ws, num_steps=4, **_LIF)
    _compare(got, want, gated=False)
    tiles = _np(got["telemetry"].tiles_skipped)
    assert tiles.shape == (4, 2, 3)
    assert tiles[:, 0, :].min() >= 3                # K-tiles 2..4 silent


def test_padded_lanes_stay_zero():
    """Padding keeps zero pixels and zero PRNG state: zero is the xorshift
    fixed point, so a padded lane never spikes (no zero-seed remap)."""
    rng = np.random.default_rng(1)
    ws = _weights(rng, (100, 10))
    px, st = _inputs(rng, 3, 100, seed=4)
    got, _ = _both(px, st, ws, num_steps=3, **_LIF)
    # 3 lanes pad to one 8-lane block, 100 inputs to 128: the launch saw
    # 5 padded lanes and 28 padded inputs, none of which spiked
    assert _np(got["telemetry"].n_spk).max() <= 100
    assert tuple(got["prng_state"].shape) == (3, 100)


def _plain_args(rng, bp=8, sizes=(128, 128), gated=True):
    k0, outs = sizes[0], sizes[1:]
    px = torch.from_numpy(rng.integers(0, 256, (bp, k0), dtype=np.uint8))
    st = torch.from_numpy(np.array(jprng.seed_state(1, (bp, k0))))
    ws = tuple(torch.zeros((i, o), dtype=torch.int16)
               for i, o in zip(sizes[:-1], outs))
    v = tuple(torch.zeros((bp, n), dtype=torch.int32) for n in outs)
    en = tuple(torch.ones((bp, n), dtype=torch.uint8) for n in outs)
    vp = tuple(torch.full((bp, n), -(1 << 31), dtype=torch.int32)
               for n in outs)
    cnt = torch.zeros((bp, outs[-1]), dtype=torch.int32)
    first = torch.full((bp, outs[-1]), 4, dtype=torch.int32)
    steps = torch.zeros((bp, 1), dtype=torch.int32)
    gate = tuple(torch.zeros((bp, 1), dtype=torch.int32) for _ in range(3)) \
        if gated else None
    return [px, st, ws, v, en, vp, cnt, first, steps, gate]


def test_wrapper_checks_and_cpu_dispatch():
    rng = np.random.default_rng(0)
    kw = dict(chunk_steps=2, window_steps=4, decay_shift=4, v_threshold=128)
    args = _plain_args(rng)
    before = tfused.fused_snn_stack.launches
    out = tfused.fused_snn_stack(*args, **kw)
    assert tfused.fused_snn_stack.launches == before
    assert len(out) == 11 and out[0].dtype == torch.int32
    bad = list(args)
    bad[1] = args[1].view(torch.int32)
    with pytest.raises(TypeError):
        tfused.fused_snn_stack(*bad, **kw)
    bad = list(args)
    bad[0] = args[0][:, :100]
    with pytest.raises(ValueError):
        tfused.fused_snn_stack(*bad, **kw)
    bad = list(args)
    bad[6] = torch.zeros((128, 8), dtype=torch.int32).t()
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_snn_stack(*bad, **kw)
    with pytest.raises(ValueError, match="readout"):
        tfused.fused_snn_stack(*args, readout="mean", **kw)
    for block_b in (16, 4):     # the kernel is built for 8-lane blocks only
        with pytest.raises(ValueError, match="block_b must be 8"):
            tfused.fused_snn_stack(*args, block_b=block_b, **kw)
    meta =[a.to("meta") if isinstance(a, torch.Tensor) else
            (tuple(x.to("meta") for x in a) if isinstance(a, tuple) else a)
            for a in args]
    with pytest.raises(ValueError, match="device"):
        tfused.fused_snn_stack(*meta, **kw)


def _smem_earlier_layout(padded):
    """The resident kernel's shared memory as its earlier layout carved
    it: pixels and PRNG state, membranes, peaks, enables, counts, latches
    and two uint16 spike lists per lane, on the LANE-padded widths."""
    k0, outs = padded[0], padded[1:]
    widest = max(padded)
    per_lane = k0 * 5 + sum(outs) * 9 + outs[-1] * 8 + 2 * widest * 2
    flags = sum(k // 128 for k in padded[:-1]) + sum(n // 128 for n in outs)
    return 8 * per_lane + 4 * flags


def test_smem_model_admits_every_stack_the_earlier_layout_did():
    """Every stack the earlier resident layout held (pixels and PRNG state
    in shared memory) still fits: one hidden layer of every width it held up
    to 1,664 columns (784→1792→10 did not fit it), the widest input it
    held (2,944 pixels, within the registers' 3,072), the deep stack and
    784→512→512→10.  The present layout holds one hidden layer up to
    2,176 columns."""
    def pad(n):
        return n + (-n) % 128

    limit = tfused.SMEM_LIMIT_BYTES
    stacks = [(784, n, 10) for n in range(16, 1665, 16)]
    stacks += [(784, 128, 64, 10), (784, 512, 512, 10), (2944, 10),
               (2944, 128, 10), (1024, 1024, 10), (784, 640, 640, 10)]
    admitted = 0
    for sizes in stacks:
        if _smem_earlier_layout([pad(n) for n in sizes]) > limit:
            continue
        admitted += 1
        k0 = sizes[0] + (-sizes[0]) % tfused.K1_PIXEL_ALIGN
        assert k0 <= tfused.K1_MAX_PIXELS, sizes
        assert tfused.stack_smem_bytes((k0,) + sizes[1:]) <= limit, sizes
        cfg = tcfgs.SNN_CONFIG_DEEP if len(sizes) == 4 else tcfgs.SNN_CONFIG
        assert tsnn.fused_unsupported_reason(
            cfg, len(sizes) - 1, sizes, 8) is None, sizes
    assert admitted == len(stacks) - 1        # all but 784→640→640→10
    assert _smem_earlier_layout((896, 1792, 128)) > limit
    held = [n for n in range(16, 4097, 16)
            if tfused.stack_smem_bytes((784, n, 10)) <= limit]
    assert held == list(range(16, 2177, 16))
    assert tsnn.resolve_backend(
        tcfgs.SNN_CONFIG, "auto", 2, layer_sizes=(784, 2176, 10),
        device="cuda") == "fused"
    assert tsnn.resolve_backend(
        tcfgs.SNN_CONFIG, "auto", 2, layer_sizes=(784, 2192, 10),
        device="cuda") == "fused_streamed"
    # inputs past the registers go to the streamed kernel
    assert "registers" in tsnn.fused_unsupported_reason(
        tcfgs.SNN_CONFIG, 1, (3088, 10), 8)


def test_smem_model_matches_configs():
    """The shared-memory model admits the paper stacks and refuses WIDE."""
    assert tfused.stack_smem_bytes((896, 128)) <= tfused.SMEM_LIMIT_BYTES
    assert tfused.stack_smem_bytes((896, 128, 128, 128)) <= \
        tfused.SMEM_LIMIT_BYTES
    assert tfused.stack_smem_bytes((896, 2048, 2048, 128)) > \
        tfused.SMEM_LIMIT_BYTES
    assert tfused.block_b_for(3) == 8 and tfused.block_b_for(1024) == 8


@pytest.mark.parametrize("sizes", [(784, 10), (784, 128, 64, 10),
                                   (784, 2048, 2048, 10), (50, 33, 17, 9)])
def test_tiles_total_matches_jax(sizes):
    from repro.core.telemetry import tiles_total as jtiles
    from repro_torch.core.telemetry import tiles_total
    assert tiles_total(sizes) == jtiles(sizes)
