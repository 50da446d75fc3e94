"""K3's operand layout and plain version against the JAX package, on the
CPU.

``pack_weights`` against the JAX ``pack_weights`` (the port keeps each
column's K values contiguous, the transpose of the JAX layout), and
``partial_contraction_plain`` on packed planes against the JAX package's
``partial_contraction_op`` in interpret mode, current and skipped counts,
integer-equal: codes at both ends of the 9-bit range under an all-spiking
K tile, shards of 5 and 10 real columns, and an 8-lane block with no
enabled neuron beside a live one in the same 16-lane MMA fragment.  A
mesh serve packs no weights per launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_snn as jfused
from repro.kernels import ops as jops
from repro_torch.configs import snn_mnist as tcfgs
from repro_torch.kernels import fused_snn as tfused

LANE = tfused.LANE


def _pad(a, rows, cols):
    out = np.zeros((a.shape[0] + (-a.shape[0]) % rows,
                    a.shape[1] + (-a.shape[1]) % cols), a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _extreme_codes(rng, n_in, n_out):
    """Random codes with -256 and 255 in every column."""
    w = rng.integers(-256, 256, (n_in, n_out)).astype(np.int16)
    w[0::3] = -256
    w[1::3] = 255
    return w


@pytest.mark.parametrize("shape", [(128, 128), (300, 10), (256, 130)])
def test_pack_weights_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = _extreme_codes(rng, *shape)
    got = tfused.pack_weights(torch.from_numpy(w))
    want = np.asarray(jfused.pack_weights(jnp.asarray(w)))   # (2, in, out)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert tuple(got.shape) == (2, shape[1], shape[0])
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 1))
    back = tfused.unpack_weights(got)
    assert back.dtype == torch.int16
    np.testing.assert_array_equal(back.numpy(), w)


def _case(name, rng):
    """(spikes, enables, codes) of one named case, unpadded."""
    if name == "extremes_all_spiking_k_tile":
        B, n_in, n_out = 16, 300, 130
        x = rng.random((B, n_in)) < 0.1
        x[:, :LANE] = True                     # K tile 0 spikes everywhere
        en = rng.random((B, n_out)) < 0.8
        return x, en, _extreme_codes(rng, n_in, n_out)
    if name in ("n_valid_5", "n_valid_10"):
        n_out = 5 if name == "n_valid_5" else 10
        x = rng.random((24, 260)) < 0.2
        x[16:] = True                          # the last block at density 1
        en = rng.random((24, n_out)) < 0.8
        en[8:16] = False                       # block 1 dead
        return x, en, _extreme_codes(rng, 260, n_out)
    if name in ("dead_block_beside_live", "live_block_beside_dead"):
        x = rng.random((32, 200)) < 0.3
        en = rng.random((32, 140)) < 0.8
        dead = slice(0, 8) if name == "dead_block_beside_live" \
            else slice(8, 16)
        en[dead] = False                       # one half of a 16-lane tile
        en[16:24, LANE:] = False               # and one dead N tile
        return x, en, rng.integers(-256, 256, (200, 140)).astype(np.int16)
    raise ValueError(name)


@pytest.mark.parametrize("sparse_skip", [True, False])
@pytest.mark.parametrize("name", ["extremes_all_spiking_k_tile", "n_valid_5",
                                  "n_valid_10", "dead_block_beside_live",
                                  "live_block_beside_dead"])
def test_partial_contraction_plain_matches_jax(name, sparse_skip):
    rng = np.random.default_rng(len(name))
    x, en, w = _case(name, rng)
    B, n_out = en.shape
    want_cur, want_skip = jops.partial_contraction_op(
        jnp.asarray(x), jnp.asarray(en), jnp.asarray(w),
        sparse_skip=sparse_skip, interpret=True)
    xp = torch.from_numpy(_pad(x.astype(np.uint8), 8, LANE))
    ep = torch.from_numpy(_pad(en.astype(np.uint8), 8, LANE))
    wp = tfused.pack_weights(torch.from_numpy(_pad(w, LANE, LANE)))
    cur, skip = tfused.partial_contraction(xp, ep, wp, n_valid=n_out,
                                           sparse_skip=sparse_skip)
    assert cur.dtype == skip.dtype == torch.int32
    np.testing.assert_array_equal(cur.numpy()[:B, :n_out],
                                  np.asarray(want_cur))
    assert not cur[:, n_out:].any()
    np.testing.assert_array_equal(skip.numpy(), np.asarray(want_skip))
    dense = x.astype(np.int64) @ w.astype(np.int64)
    if name.endswith("beside_live") or name.endswith("beside_dead"):
        dead = slice(0, 8) if name == "dead_block_beside_live" \
            else slice(8, 16)
        live = slice(8, 16) if name == "dead_block_beside_live" \
            else slice(0, 8)
        got = cur.numpy()[:B, :n_out]
        np.testing.assert_array_equal(got[live], dense[live])
        if sparse_skip:
            assert (got[dead] == 0).all() and (dense[dead] != 0).any()
        else:
            np.testing.assert_array_equal(got[dead], dense[dead])
    if name == "extremes_all_spiking_k_tile":
        assert (w == -256).any() and (w == 255).any()


def test_partial_contraction_plain_zeroes_columns_past_n_valid():
    """The plain version computes what the kernel does: columns from
    ceil(n_valid / 8) * 8 on are 0 even where the planes are not (the
    caller's contract is that they are zero there)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((8, 128)) < 0.5).astype(np.uint8))
    en = torch.ones((8, 128), dtype=torch.uint8)
    w = torch.from_numpy(rng.integers(1, 256, (128, 128)).astype(np.int16))
    wp = tfused.pack_weights(w)
    full, _ = tfused.partial_contraction(x, en, wp)
    cut, _ = tfused.partial_contraction(x, en, wp, n_valid=10)
    np.testing.assert_array_equal(cut[:, :16].numpy(), full[:, :16].numpy())
    assert full[:, 16:].any() and not cut[:, 16:].any()


def test_partial_contraction_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((8, 128), dtype=torch.uint8)
    en = torch.ones((8, 128), dtype=torch.uint8)
    wp = tfused.pack_weights(torch.zeros((128, 128), dtype=torch.int16))
    for n_valid in (0, 129):
        with pytest.raises(ValueError, match="n_valid"):
            tfused.partial_contraction(x, en, wp, n_valid=n_valid)
    with pytest.raises(TypeError, match="int8"):
        tfused.partial_contraction(x, en, torch.zeros((2, 128, 128),
                                                      dtype=torch.int16))
    with pytest.raises(ValueError, match="shape"):
        tfused.partial_contraction(x, en, wp.transpose(1, 2)[:, :, :64]
                                   .contiguous())


def test_mesh_serve_packs_no_weights_per_launch(monkeypatch):
    """On a 1x2 mesh every contraction goes to the op as a placed packed
    shard: after construction nothing packs, and the results equal the
    reference backend's."""
    rng = np.random.default_rng(11)
    cfg = tcfgs.SNN_CONFIG
    w = np.clip(np.round(rng.normal(0, 24, (784, 10))), -256, 255)
    p = {"layers": [{"w_q": w.astype(np.int16),
                     "scale": np.float32(1 / 128)}]}
    imgs = rng.integers(0, 256, (6, 784), dtype=np.uint8)
    knobs = tcfgs.SNNStreamMeshConfig(num_devices=1, model_devices=2,
                                      lanes_per_device=8, chunk_steps=3)
    runs = {}
    for backend in ("fused", "reference"):
        eng = tcfgs.make_stream_engine(p, cfg, knobs,
                                       devices=[torch.device("cpu")] * 2,
                                       backend=backend)
        packs = []
        real = tfused.pack_weights
        monkeypatch.setattr(tfused, "pack_weights",
                            lambda *a, **k: packs.append(1) or real(*a, **k))
        for im in imgs:
            eng.submit(im)
        runs[backend] = eng.run()
        monkeypatch.setattr(tfused, "pack_weights", real)
        assert packs == [], backend
    assert sorted(runs["fused"]) == list(range(6))
    for rid, r in runs["reference"].items():
        f = runs["fused"][rid]
        assert (f.pred, f.steps, f.adds) == (r.pred, r.steps, r.adds)
