"""Parity of the port's int8 error-feedback compression
(``optim.compression``) with the JAX package's, on the CPU.

``compress_decompress`` on one leaf and ``compressed_psum`` across 8
``gloo`` processes (against JAX's ``shard_map`` over 8 forced host devices,
in a subprocess, as ``tests/test_distributed.py`` runs it) must equal JAX
bit for bit: the same float32 operations, and ``torch.round`` rounds half
to even as ``jnp.round`` does.  The error-feedback bounds are
``tests/test_distributed.py``'s.  The train step's ``int8_ef`` wiring runs
in the same 8-process job: every rank trains on the same batch, where the
compressed mean over 8 equal gradients is exactly the one-rank round trip.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression as tcomp

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
N_RANKS, N_ITERS = 8, 8


def _leaves():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    return [
        (rng.normal(0, 1, (64, 32)).astype(np.float32),
         np.zeros((64, 32), np.float32)),
        (rng.normal(0, 1e-3, (7, 5, 3)).astype(np.float32),
         rng.normal(0, 1e-5, (7, 5, 3)).astype(np.float32)),
        (ties, np.zeros_like(ties)),                 # g/scale on .5 ties
        (np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32)),
        (np.float32(3.25), np.float32(-0.125)),      # a scalar leaf
    ]


@pytest.mark.parametrize("i", range(5))
def test_compress_decompress_matches_jax_bit_for_bit(i):
    g, e = _leaves()[i]
    jd, je = jcomp.compress_decompress(jnp.asarray(g), jnp.asarray(e))
    td, te = tcomp.compress_decompress(torch.tensor(g), torch.tensor(e))
    assert td.dtype == te.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jq, js = jcomp._quant(jnp.asarray(g))
    tq, ts = tcomp._quant(torch.tensor(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    if i == 2:      # half to even: 0.5 → 0, 1.5 → 2, 2.5 → 2, 126.5 → 126
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_compress_decompress_takes_bf16_gradients():
    g = torch.linspace(-3, 3, 50).to(torch.bfloat16)
    e = torch.full((50,), 1e-3)
    jd, je = jcomp.compress_decompress(
        jnp.asarray(g.float().numpy()).astype(jnp.bfloat16), jnp.asarray(
            e.numpy()))
    td, te = tcomp.compress_decompress(g, e)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_init_state_is_float32_zeros():
    st = tcomp.init_state({"a": torch.ones(3, dtype=torch.bfloat16),
                           "b": [torch.ones(2, 2)]})
    assert st.error["a"].dtype == torch.float32
    assert st.error["b"][0].shape == (2, 2)
    assert float(st.error["a"].abs().sum()) == 0.0


JAX_CODE = """
import sys, jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import make_device_mesh, shard_map_compat
from repro.optim import compression

mesh = make_device_mesh((8,), ("pod",))
grads = jnp.asarray(np.random.default_rng(0).normal(0, 1, (8, 64, 32))
                    .astype(np.float32))

@partial(shard_map_compat, mesh=mesh, in_specs=(P("pod"), P("pod")),
         out_specs=(P("pod"), P("pod")))
def step(g, err):
    st = compression.CompressionState(error={"w": err[0]})
    out, new_st = compression.compressed_psum({"w": g[0]}, st, "pod")
    return out["w"][None], new_st.error["w"][None]

err = jnp.zeros_like(grads)
comps, errs = [], []
for it in range(8):
    comp, err = step(grads, err)
    comps.append(np.asarray(comp))
    errs.append(np.asarray(err))
np.savez(sys.argv[1], comp=np.stack(comps), err=np.stack(errs))
"""

PORT_CODE = """
import sys, numpy as np, torch, torch.distributed as dist
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.configs import get_reduced
from repro_torch.convert import train_state_to_jax
from repro_torch.optim import compression
from repro_torch.train import TrainSettings, init_state, make_train_step

g = np.random.default_rng(0).normal(0, 1, (8, 64, 32)).astype(np.float32)
err = torch.zeros(64, 32)
comps, errs = [], []
for it in range(8):
    out_g, st = compression.compressed_psum(
        {"w": torch.from_numpy(g[rank % 8])},
        compression.CompressionState(error={"w": err}))
    err = st.error["w"]
    comps.append(out_g["w"].numpy())
    errs.append(err.numpy())

cfg = get_reduced("qwen3-4b")
s = TrainSettings(grad_compression="int8_ef", warmup_steps=0,
                  learning_rate=1e-3)
state = init_state(torch.Generator().manual_seed(0), cfg, s, device="cpu")
step = make_train_step(cfg, s, pod_group=dist.group.WORLD)
rng = np.random.default_rng(7)
for i in range(2):
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    state, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
tree = train_state_to_jax(state, cfg)
flat = {}
def walk(t, p):
    for k, v in t.items():
        walk(v, p + k + ".") if isinstance(v, dict) else \\
            flat.__setitem__(p + k, np.asarray(v))
walk({"params": tree["params"], "comp_err": tree["comp_err"]}, "")
np.savez(out, comp=np.stack(comps), err=np.stack(errs),
         loss=float(m["loss"]), **flat)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_group(world, tmp_path, tag):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = _free_port()
    outs = [str(tmp_path / f"{tag}{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PORT_CODE), str(r),
         str(world), str(port), outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:             # a failed rank leaves the rest waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comp")
    jax_out = str(tmp / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE), jax_out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = _port_group(N_RANKS, tmp, "r")
    solo = _port_group(1, tmp, "solo")[0]
    _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(np.load(jax_out)), ranks, solo


def test_compressed_psum_over_8_gloo_ranks_matches_jax_shard_map(runs):
    want, ranks, _ = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["comp"], want["comp"][:, r])
        np.testing.assert_array_equal(got["err"], want["err"][:, r])
    # every member decodes the same mean
    for got in ranks[1:]:
        np.testing.assert_array_equal(got["comp"], ranks[0]["comp"])


def test_compressed_psum_error_feedback_bounds(runs):
    """``tests/test_distributed.py``'s bounds, on the port's ranks: the
    per-step error within the quantisation step, and the running average
    pulled toward the exact mean by the error feedback."""
    _, ranks, _ = runs
    grads = np.random.default_rng(0).normal(0, 1, (8, 64, 32)) \
        .astype(np.float32)
    exact = grads.mean(axis=0)
    comp = ranks[0]["comp"]
    scale = float(np.abs(grads).max()) / 127.0
    step_err = float(np.abs(comp[-1] - exact).max())
    avg_err = float(np.abs(comp.sum(axis=0) / N_ITERS - exact).max())
    assert step_err <= 2.5 * scale
    assert avg_err <= step_err / 2 + scale * 0.2


def test_train_step_int8_ef_over_a_pod_group(runs):
    """Eight ranks on one batch: the same parameters and residuals on every
    rank, equal bit for bit to one rank alone (8 equal int8 codes sum to
    8q, and (8q·scale)/8 is q·scale exactly); the residual is live."""
    _, ranks, solo = runs
    keys = [k for k in solo if k.startswith(("params.", "comp_err."))]
    assert any(k.startswith("comp_err.") for k in keys)
    for got in ranks:
        for k in keys:
            np.testing.assert_array_equal(got[k], solo[k], err_msg=k)
    assert max(float(np.abs(solo[k]).max()) for k in keys
               if k.startswith("comp_err.")) > 0
    assert np.isfinite(solo["loss"])


def test_int8_ef_without_a_pod_group_keeps_a_zero_residual():
    """As the JAX package's step without a "pod" axis: no compression."""
    from repro_torch.configs import get_reduced
    from repro_torch.train import TrainSettings, init_state, make_train_step

    cfg = get_reduced("qwen3-4b")
    s = TrainSettings(grad_compression="int8_ef")
    st = init_state(torch.Generator().manual_seed(0), cfg, s, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    st, _ = make_train_step(cfg, s)(st, {"tokens": toks[:, :-1],
                                         "labels": toks[:, 1:]})
    assert all(float(e.abs().max()) == 0 for e in st.comp_err.values())
