"""The port's LM placed over a 2×2 (data × model) mesh of four ``gloo``
rank processes, against the one-process port and against the JAX
package's GSPMD run on four forced host devices, on the CPU.

Reduced qwen3 (every head sharded, kv heads too), reduced qwen3 with two
kv heads (GQA: the kv heads replicated over the model axis), reduced
gemma2 (sliding-window layers, logit softcaps, sandwich norms, the scaled
embedding) and reduced mamba2 (d_model 64, 2 layers; ``configs.reduced``): one prefill, four
decode steps, and two AdamW train steps with two microbatches, FSDP and
sequence parallelism on.  Every rank draws the same weights and batches;
the parameters and the batch are placed by the production rules
(``distributed.partition.place``).  Bounds, with their reasons:

* Against the one-process port, float32 relative 1e-5 (``|Δ| ≤ 1e-5 ·
  max|one-process|``) for the prefill and decode logits (tokens equal),
  each step's loss and gradient norm, and the AdamW moments after two
  steps (the first moment, and the second's square root: both on the
  gradients' scale).  Both runs leave the attention
  operands unrounded here: the model rounds them to bfloat16, and a
  product summed in another order across shards can land within an ulp
  of a rounding boundary and round the other way (5.8e-5 measured on
  the logits with the rounding on, 4e-7 without).  The parameters after
  two steps move by AdamW's normalised updates, where a near-zero
  gradient's relative noise becomes an O(lr) move: they are held within
  4·lr, the bound ``tests/test_torch_lm_train.py`` gives one step
  (2·lr), over two.
* Against JAX (the model's own bfloat16 rounding on, in both), the
  existing cross-package bounds (``tests/test_torch_lm_serve.py`` and
  ``tests/test_torch_lm_train.py``): logits ``|Δ| ≤ 1e-2 · max|JAX|``;
  loss and gradient norm rtol 1e-3; the parameters after the first step
  within 2·lr.
* Each rank's argument bytes (its local shards of the train state and
  batch) equal ``launch.dryrun.shard_bytes`` under the same specs.
* The ranks' checkpoint (each rank its shards, rank 0 the manifest)
  restores whole in one process and in JAX, equal to the ranks' state;
  JAX's four-device checkpoint restores into the 2×2 partition equal to
  JAX's state.
* int8 error-feedback compression across the "pod" axis of a (pod 2,
  data 1, model 2) mesh against the one-process step: see
  ``test_int8_error_feedback_across_pods``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jck
from repro.train import step as jstep
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_to_jax
from repro_torch.launch.specs import abstract_params
from repro_torch.models import lm_init
from repro_torch.train import TrainSettings, init_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
# (name, arch, kv heads override)
CASES = [("qwen3", "qwen3-4b", None), ("qwen3_gqa", "qwen3-4b", 2),
         ("gemma2", "gemma2-9b", None), ("mamba2", "mamba2-1.3b", None)]
B, S, DEC, LR = 8, 16, 4, 1e-3
REL32 = 1e-5
REL = 1e-2

COMMON = """
import dataclasses, json, sys
import numpy as np

CASES = json.loads(sys.argv[-1])
B, S, DEC, LR = {B}, {S}, {DEC}, {LR}


def batches(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
            for _ in range(2)]


def prompts(vocab):
    return np.random.default_rng(3).integers(
        0, vocab, (B, S)).astype(np.int32)
""".format(B=B, S=S, DEC=DEC, LR=LR)

JAX_CODE = COMMON + """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro import configs as jcfg
from repro.checkpoint.manager import save_pytree
from repro.distributed.partition import (batch_specs, param_specs,
    to_shardings, train_state_specs)
from repro.distributed.sharding import make_device_mesh, make_rules, use_rules
from repro.serve.engine import make_decode_step, make_prefill
from repro.train.step import TrainSettings, init_state, make_train_step

out_dir = sys.argv[1]
mesh = make_device_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])


def unflat(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


for name, arch, kv in CASES:
    cfg = jcfg.get_reduced(arch)
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    params = unflat(dict(np.load(f"{out_dir}/params_{name}.npz")))
    got = {}
    rules = make_rules(mesh, fsdp=False)
    with mesh, use_rules(rules):
        p = jax.device_put(params, to_shardings(
            mesh, rules, param_specs(cfg, params), params))
        b = {"tokens": jnp.asarray(prompts(cfg.vocab_size))}
        b = jax.device_put(b, to_shardings(mesh, rules, batch_specs(b), b))
        st, logits = jax.jit(make_prefill(cfg, max_len=S + DEC + 1))(p, b)
        got["prefill"] = np.asarray(logits, np.float32)
        dec = jax.jit(make_decode_step(cfg))
        for i in range(DEC):
            st, lg = dec(p, st)
            got[f"dec{i}"] = np.asarray(lg, np.float32)
    rules = make_rules(mesh, fsdp=True, sequence_parallel=True)
    with mesh, use_rules(rules):
        s = TrainSettings(num_microbatches=2, warmup_steps=0,
                          learning_rate=LR)
        st = init_state(jax.random.PRNGKey(0), cfg, s,
                        init_fn=lambda k: params)
        st_sh = to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, st), st)
        st = jax.device_put(st, st_sh)
        bb = {"tokens": np.zeros((B, S), np.int32),
              "labels": np.zeros((B, S), np.int32)}
        b_sh = to_shardings(mesh, rules, batch_specs(bb), bb)
        step = jax.jit(make_train_step(cfg, s, grad_shardings=st_sh.params),
                       in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None))
        for i, t in enumerate(batches(cfg.vocab_size)):
            st, m = step(st, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            got[f"loss{i}"] = float(m["loss"])
            got[f"gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                for k, v in jax.tree_util.tree_flatten_with_path(
                        st.params)[0]:
                    got["p1." + ".".join(str(getattr(e, "key", e))
                                         for e in k)] = np.asarray(v)
        save_pytree(st, f"{out_dir}/jax_ckpt_{name}")
        for k, v in jax.tree_util.tree_flatten_with_path(st)[0]:
            got["state." + ".".join(
                str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", e))))
                for e in k)] = np.asarray(v)
    np.savez(f"{out_dir}/jax_{name}.npz", **got)
"""

PORT_CODE = COMMON + """
import os, time
import torch, torch.distributed as dist
rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
import repro_torch.models.attention as attn
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_reduced
from repro_torch.distributed.partition import (batch_specs, param_specs,
    place, to_shardings, train_state_specs)
from repro_torch.distributed.sharding import (is_placed, make_device_mesh,
                                              make_rules, use_rules)
from repro_torch.launch.dryrun import shard_bytes
from repro_torch.launch.op_cost import _leaves
from repro_torch.launch.specs import abstract_params
from repro_torch.models import lm_init
from repro_torch.serve.engine import make_decode_step, make_prefill
from repro_torch.train import TrainSettings, init_state, make_train_step

mesh = make_device_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
assert mesh.torch_mesh is not None
BF16 = attn._bf16
SETTINGS = TrainSettings(num_microbatches=2, warmup_steps=0,
                         learning_rate=LR)


def host(t):
    t = t.full_tensor() if is_placed(t) else t
    return t.detach().to(torch.float32).numpy()


def serve(cfg, placed):
    model = lm_init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    b = {"tokens": torch.from_numpy(prompts(cfg.vocab_size))}
    out = {}
    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        if placed:
            model = place(model, to_shardings(
                mesh, rules, param_specs(cfg, model), model), mesh)
            b = place(b, to_shardings(mesh, rules, batch_specs(b), b), mesh)
        st, logits = make_prefill(cfg, max_len=S + DEC + 1)(model, b)
        out["prefill"] = host(logits)
        dec = make_decode_step(cfg)
        for i in range(DEC):
            st, lg = dec(model, st)
            out[f"dec{i}"] = host(lg)
            out[f"tok{i}"] = host(st.last_token)
    return out


def train(cfg, placed):
    st = init_state(torch.Generator().manual_seed(0), cfg, SETTINGS,
                    device="cpu")
    out = {}
    rules = make_rules(mesh, fsdp=True, sequence_parallel=True)
    with use_rules(rules):
        specs = to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, st), st)
        if placed:
            bb = {"tokens": torch.zeros((B, S), dtype=torch.int32),
                  "labels": torch.zeros((B, S), dtype=torch.int32)}
            b_sh = to_shardings(mesh, rules, batch_specs(bb), bb)
            want = shard_bytes(st, specs, mesh.shape) + shard_bytes(
                bb, b_sh, mesh.shape)
            st = place(st, specs, mesh)
            pb = place(bb, b_sh, mesh)
            # the state's two step counters count as int32 scalars
            got = 8 + sum(t.untyped_storage().nbytes()
                          for t in _leaves((st.params, st.opt_state, pb)))
            out["arg_bytes"] = np.array([got, want])
        step = make_train_step(cfg, SETTINGS)
        for i, t in enumerate(batches(cfg.vocab_size)):
            st, m = step(st, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            out[f"loss{i}"] = float(m["loss"])
            out[f"gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                for n, p in st.params.named_parameters():
                    out["p1." + n] = host(p)
        for n, p in st.params.named_parameters():
            out["p." + n] = host(p)
        for k in ("mu", "nu"):
            for n, t in getattr(st.opt_state, k).items():
                out[f"{k}.{n}"] = host(t)
    return out, st, specs


for name, arch, kv in CASES:
    cfg = get_reduced(arch)
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    res = {}
    # float32 numerics on both sides (see the test's docstring)
    attn._bf16 = lambda x: x.to(torch.float32)
    for tag, placed in (("one", False), ("placed", True)):
        res.update({f"{tag}32.{k}": v for k, v in serve(cfg, placed).items()})
        res.update({f"{tag}32.{k}": v
                    for k, v in train(cfg, placed)[0].items()})
    attn._bf16 = BF16
    res.update({f"bf.{k}": v for k, v in serve(cfg, True).items()})
    tr, st, specs = train(cfg, True)
    res.update({f"bf.{k}": v for k, v in tr.items()})
    save_pytree(st, f"{out_dir}/port_ckpt_{name}")
    # JAX's checkpoint, once its subprocess has written it, into 2x2
    path = f"{out_dir}/jax_ckpt_{name}/manifest.json"
    for _ in range(600):
        if os.path.exists(path):
            break
        time.sleep(0.5)
    like = init_state(None, cfg, SETTINGS,
                      lambda g: abstract_params(cfg), device="meta")
    with use_rules(make_rules(mesh, fsdp=True)):
        back = restore_pytree(like, os.path.dirname(path),
                              shardings=(mesh, specs), device="cpu")
    assert is_placed(back.params.embed)
    for n, p in back.params.named_parameters():
        res["jaxback." + n] = host(p)
    np.savez(f"{out_dir}/port_{name}_r{rank}.npz", **res)

# int8 error-feedback compression across pods: a (pod 2, data 1, model 2)
# mesh whose two pods see the same rows, against the one-process step
# compressing over a one-rank group (the same int8 round trip); SGD, so
# the parameters move by the compressed gradient itself
attn._bf16 = lambda x: x.to(torch.float32)     # float32 numerics
solo = [dist.new_group([r]) for r in range(world)]
pods = make_device_mesh((2, 1, 2), ("pod", "data", "model"),
                        devices=["cpu"] * 4)
cfg = dataclasses.replace(get_reduced("qwen3-4b"), num_kv_heads=2,
                          optimizer="sgd")
s = TrainSettings(warmup_steps=0, learning_rate=1e-2, clip_norm=1e9,
                  grad_compression="int8_ef")
one = init_state(torch.Generator().manual_seed(0), cfg, s, device="cpu")
st = init_state(torch.Generator().manual_seed(0), cfg, s, device="cpu")
rules = make_rules(pods, fsdp=True, sequence_parallel=True)
with use_rules(rules):
    st = place(st, to_shardings(pods, rules, train_state_specs(
        cfg, cfg.optimizer, st), st), pods)
res = {}
for i, t in enumerate(batches(cfg.vocab_size)):
    t = t[:B // 2]
    one, m1 = make_train_step(cfg, s, pod_group=solo[rank])(
        one, {"tokens": t[:, :-1], "labels": t[:, 1:]})
    t = np.concatenate([t, t])
    with use_rules(rules):
        st, m = make_train_step(cfg, s)(
            st, {"tokens": t[:, :-1], "labels": t[:, 1:]})
    for k in ("loss", "grad_norm"):
        res[f"{k}{i}"] = np.array([float(m[k]), float(m1[k])])
    for n in one.comp_err:
        res[f"err{i}.{n}"] = np.stack([host(st.comp_err[n]),
                                       host(one.comp_err[n])])
for n, p in one.params.named_parameters():
    res["p." + n] = np.stack([host(st.params.get_parameter(n)), host(p)])
if rank == 0:
    np.savez(f"{out_dir}/pods.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(arch, kv):
    import dataclasses
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    for name, arch, kv in CASES:
        cfg = _config(arch, kv)
        tree = lm_params_to_jax(lm_init(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
            cfg)
        flat = {}

        def walk(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, pre + k + ".")
                else:
                    flat[pre + k] = v
        walk(tree)
        np.savez(out / f"params_{name}.npz", **flat)
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_CODE), str(out), cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PORT_CODE), str(r), "4",
         str(port), str(out), cases], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        _, err = jax_proc.communicate(timeout=600)
        assert jax_proc.returncode == 0, err[-3000:]
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs + [jax_proc]:   # a failed rank leaves the rest waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _load(out, name, rank=0):
    return dict(np.load(out / f"port_{name}_r{rank}.npz"))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _jax_flat(named: dict, cfg) -> dict:
    """Port parameter arrays by name → the JAX tree's dotted paths."""
    from repro_torch.convert import _stack_named

    tree = _stack_named(named, cfg, lambda ts, stacked: np.stack(ts)
                        if stacked else ts[0])
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + ".")
            else:
                flat[pre + k] = v
    walk(tree)
    return flat


def _named(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_serving_matches_one_process(runs, name):
    r = _load(runs, name)
    for k in ["prefill"] + [f"dec{i}" for i in range(DEC)]:
        assert _rel(r[f"placed32.{k}"], r[f"one32.{k}"]) <= REL32, k
    for i in range(DEC):
        np.testing.assert_array_equal(r[f"placed32.tok{i}"],
                                      r[f"one32.tok{i}"])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_training_matches_one_process(runs, name):
    r = _load(runs, name)
    for i in range(2):
        for k in (f"loss{i}", f"gnorm{i}"):
            assert _rel(r[f"placed32.{k}"], r[f"one32.{k}"]) <= REL32, k
    moments = [k[len("one32."):] for k in r
               if k.startswith(("one32.mu.", "one32.nu."))]
    assert moments
    for k in moments:       # √ν: the second moment on the gradient's scale
        root = np.sqrt if k.startswith("nu.") else (lambda a: a)
        assert _rel(root(r[f"placed32.{k}"]), root(r[f"one32.{k}"])) \
            <= REL32, k
    for n, want in _named(r, "one32.p.").items():
        assert np.abs(r[f"placed32.p.{n}"] - want).max() <= 4 * LR, n


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_run_matches_jax_gspmd(runs, name):
    arch, kv = next((a, k) for n, a, k in CASES if n == name)
    cfg = _config(arch, kv)
    r, j = _load(runs, name), dict(np.load(runs / f"jax_{name}.npz"))
    for k in ["prefill"] + [f"dec{i}" for i in range(DEC)]:
        assert _rel(r[f"bf.{k}"], j[k]) <= REL, k
    for i in range(2):
        for k in (f"loss{i}", f"gnorm{i}"):
            np.testing.assert_allclose(r[f"bf.{k}"], j[k], rtol=1e-3,
                                       err_msg=k)
    got = _jax_flat(_named(r, "bf.p1."), cfg)
    assert got
    for k, v in got.items():
        assert np.abs(v - j[f"p1.{k}"]).max() <= 2.0001 * LR, k


@pytest.mark.parametrize("rank", range(4))
def test_rank_argument_bytes_equal_shard_bytes(runs, rank):
    for name, _, _ in CASES:
        got, want = _load(runs, name, rank)["bf.arg_bytes"]
        assert got == want, (name, got, want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ranks_checkpoint_restores_in_one_process_and_jax(runs, name):
    arch, kv = next((a, k) for n, a, k in CASES if n == name)
    cfg = _config(arch, kv)
    r = _load(runs, name)
    s = TrainSettings(num_microbatches=2, warmup_steps=0, learning_rate=LR)
    like = init_state(None, cfg, s, lambda g: abstract_params(cfg),
                      device="meta")
    back = restore_pytree(like, str(runs / f"port_ckpt_{name}"),
                          device="cpu")
    assert back.step == 2
    for n, p in back.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r[f"bf.p.{n}"],
                                      err_msg=n)
    for k in ("mu", "nu"):
        for n, t in getattr(back.opt_state, k).items():
            np.testing.assert_array_equal(t.numpy(), r[f"bf.{k}.{n}"])
    # JAX's restore of the same files: every rank's shards assembled
    from repro import configs as jcfg
    import dataclasses
    jc = jcfg.get_reduced(arch)
    jc = dataclasses.replace(jc, num_kv_heads=kv) if kv else jc
    want = _jax_flat(_named(r, "bf.p."), cfg)
    jlike = jax.eval_shape(lambda k: jstep.init_state(
        k, jc, jstep.TrainSettings(num_microbatches=2)),
        jax.ShapeDtypeStruct((2,), np.uint32))
    jback = jck.restore_pytree(jlike, str(runs / f"port_ckpt_{name}"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jback.params)[0]:
        k = ".".join(str(getattr(e, "key", e)) for e in path)
        np.testing.assert_array_equal(np.asarray(leaf), want[k], err_msg=k)


def test_int8_error_feedback_across_pods(runs):
    """Two pods of two model shards, each pod the same rows: the placed
    step's compressed mean across pods is the one-process int8 round trip
    of the same gradient.

    Float32 noise can move a gradient element across a rounding boundary
    of its int8 code in one run and not the other: its compressed value
    then moves by one step and its residual by the opposite step (an
    embedding row no token of a step touches carries only its residual,
    which sits near a half step, so such moves are common there).  So
    the residuals are not compared element by element: the parameters
    after two SGD steps (momentum 0.9, no clipping, lr constant to 3e-8)
    with the residuals' share taken out, ``p2 - 0.9·lr·e1 - lr·e2``, which
    no such move changes, are held within float32 1e-5, as are each
    step's loss and gradient norm."""
    r = dict(np.load(runs / "pods.npz"))
    for i in range(2):
        for k in (f"loss{i}", f"grad_norm{i}"):
            got, want = r[k]
            assert abs(got - want) <= REL32 * abs(want), k
    e1, e2 = _named(r, "err0."), _named(r, "err1.")
    assert all(np.abs(e[1]).max() > 0 for e in e2.values() if e.size)
    lr = 1e-2
    for n, (got, want) in _named(r, "p.").items():
        fix = [p - 0.9 * lr * a - lr * b for p, a, b in
               zip((got, want), e1[n], e2[n])]
        assert _rel(*fix) <= REL32, n


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_jax_checkpoint_restores_into_2x2(runs, name):
    arch, kv = next((a, k) for n, a, k in CASES if n == name)
    cfg = _config(arch, kv)
    r, j = _load(runs, name), dict(np.load(runs / f"jax_{name}.npz"))
    got = _jax_flat(_named(r, "jaxback."), cfg)
    assert got
    for k, v in got.items():
        np.testing.assert_array_equal(v, j[f"state.params.{k}"], err_msg=k)


def test_train_launcher_under_torchrun(tmp_path):
    """``launch.train`` under ``torchrun`` on four gloo ranks (1×4): rank 0
    alone prints JAX's lines, the losses are the one-process launcher's
    (rtol 1e-3, the cross-package bound: bf16 flips), and the ranks'
    checkpoint restores whole in one process at the step it was taken."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as launch_train

    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "3",
         "--ckpt-every", "2", "--ckpt-dir", str(ck)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("step")]
    assert [l.split()[1] for l in lines] == ["1", "2"]     # rank 0 alone
    assert proc.stdout.count("final loss") == 1
    _, hist = launch_train.train("qwen3-4b", steps=3, device="cpu")
    got = [float(l.split()[3]) for l in lines]
    np.testing.assert_allclose(got, [h["loss"] for h in hist[:2]],
                               rtol=1e-3)
    like = init_state(None, get_reduced("qwen3-4b"), TrainSettings(),
                      lambda g: abstract_params(get_reduced("qwen3-4b")),
                      device="meta")
    back, step = CheckpointManager(str(ck)).restore(like, device="cpu")
    assert step == 3 and back.step == 3
