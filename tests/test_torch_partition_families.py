"""The LM families beyond dense and Mamba-2 placed over a 2×2 (data ×
model) mesh of four ``gloo`` rank processes, against the one-process port
and against the JAX package's GSPMD run on four forced host devices, on
the CPU (the dense and Mamba-2 families: ``test_torch_partition_ranks``).

Reduced arctic (MoE, 4 experts top-2, with the dense residual branch),
reduced jamba (the hybrid stack: 8 layers, attention at offset 4, MoE on
the odd layers), reduced whisper (encoder, cross-attention, learned
positions, layernorm) and reduced llava (8 patch embeddings before the
text): one prefill, four decode steps, and two train steps with two
microbatches, FSDP and sequence parallelism on, each with its config's
optimizer (Adafactor for arctic, jamba and llava, AdamW for whisper).
Every rank draws the same weights and batches; the parameters and the
batch are placed by the production rules (``distributed.partition.
place``).  The experts split over the model axis (expert parallelism);
whisper's cross cache holds its 16 encoder frames on ``kv_seq``, and a
whisper of 15 frames, which do not divide the model axis, keeps it
replicated (as whisper-small's 1,500 frames on a 16-way axis).  Bounds,
with their reasons (``test_torch_partition_ranks`` explains them):

* Against the one-process port, float32 relative 1e-5 (``|Δ| ≤ 1e-5 ·
  max|one-process|``), the attention operands' bf16 rounding off in both
  runs: the prefill and decode logits (tokens equal), each step's loss
  and gradient norm, AdamW's moments after the first step and
  Adafactor's ``vr`` / ``vc`` after two (a second moment on the
  gradient's scale, its square root), and the parameters after two
  steps within 4·lr.  AdamW moves a parameter whose gradient is float32
  noise by O(lr) (a sign flip), which the second step's gradient then
  sees: whisper's AdamW moments after two steps land at 1.08e-5 for that
  reason.  A single step's Adafactor moment of jamba's ``A_log``, a
  gradient summed with cancellation along the scan, carries 1.9e-5 of
  that noise, which the second step's running mean halves.
* Against JAX (the model's bf16 rounding on, in both), the existing
  cross-package bounds: logits ``|Δ| ≤ 1e-2 · max|JAX|``; loss rtol
  1e-3; the first step's gradient norm rtol 1e-3, the second's rtol
  1e-2, the bound ``tests/test_torch_lm_train.py`` gives a microbatched
  gradient norm (Adafactor's first update is sign-like, so a bf16 flip
  moves a parameter 2·lr: jamba's second norm lands 1.15e-3 apart); the
  parameters after the first step within 2·lr.
* Each rank's argument bytes equal ``launch.dryrun.shard_bytes``.
* The ranks' jamba checkpoint (Adafactor state, MoE weights) restores
  whole in one process and in JAX, equal to the ranks' state.
"""

import dataclasses
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
# (name, arch)
CASES = [("arctic", "arctic-480b"), ("jamba", "jamba-v0.1-52b"),
         ("whisper", "whisper-small"), ("llava", "llava-next-34b")]
ADAFACTOR = [n for n, a in CASES if get_reduced(a).optimizer == "adafactor"]
B, S, DEC, LR = 8, 16, 4, 1e-3
REL32 = 1e-5
REL = 1e-2

COMMON = """
import dataclasses, json, sys
import numpy as np

CASES = json.loads(sys.argv[-1])
B, S, DEC, LR = {B}, {S}, {DEC}, {LR}


def extra(cfg, rng):
    d = {{}}
    if cfg.encoder_layers:
        d["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        d["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return d


def prompts(cfg):
    rng = np.random.default_rng(3)
    return dict(tokens=rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), **extra(cfg, rng))


def batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        lab = t[:, 1:]
        if cfg.num_patches:          # the patch positions' labels
            lab = np.concatenate(
                [np.zeros((B, cfg.num_patches), np.int32), lab], axis=1)
        out.append(dict(tokens=t[:, :-1], labels=lab, **extra(cfg, rng)))
    return out


def max_len(cfg):
    return S + cfg.num_patches + DEC + 1
""".format(B=B, S=S, DEC=DEC, LR=LR)

JAX_CODE = COMMON + """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro import configs as jcfg
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


for name, arch in CASES:
    cfg = jcfg.get_reduced(arch)
    params = unflat(dict(np.load(f"{out_dir}/params_{name}.npz")))
    got = {}
    rules = make_rules(mesh, fsdp=False)
    with mesh, use_rules(rules):
        p = jax.device_put(params, to_shardings(
            mesh, rules, param_specs(cfg, params), params))
        b = {k: jnp.asarray(v) for k, v in prompts(cfg).items()}
        b = jax.device_put(b, to_shardings(mesh, rules, batch_specs(b), b))
        st, logits = jax.jit(make_prefill(cfg, max_len=max_len(cfg)))(p, b)
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
        bb = batches(cfg)
        b_sh = to_shardings(mesh, rules, batch_specs(bb[0]), bb[0])
        step = jax.jit(make_train_step(cfg, s, grad_shardings=st_sh.params),
                       in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None))
        for i, t in enumerate(bb):
            st, m = step(st, t)
            got[f"loss{i}"] = float(m["loss"])
            got[f"gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                for k, v in jax.tree_util.tree_flatten_with_path(
                        st.params)[0]:
                    got["p1." + ".".join(str(getattr(e, "key", e))
                                         for e in k)] = np.asarray(v)
    np.savez(f"{out_dir}/jax_{name}.npz", **got)
"""

PORT_CODE = COMMON + """
import os
import torch, torch.distributed as dist
rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import Shard
import repro_torch.models.attention as attn
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_reduced
from repro_torch.distributed.partition import (batch_specs, param_specs,
    place, to_shardings, train_state_specs)
from repro_torch.distributed.sharding import (is_placed, make_device_mesh,
                                              make_rules, use_rules)
from repro_torch.launch.dryrun import shard_bytes
from repro_torch.launch.op_cost import _leaves
from repro_torch.models import lm_init
from repro_torch.serve.engine import make_decode_step, make_prefill
from repro_torch.train import TrainSettings, init_state, make_train_step

mesh = make_device_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
assert mesh.torch_mesh is not None
BF16 = attn._bf16
SETTINGS = TrainSettings(num_microbatches=2, warmup_steps=0,
                         learning_rate=LR)


def host(t):          # a copy: the state is updated in place
    t = t.full_tensor() if is_placed(t) else t
    return t.detach().to(torch.float32).numpy().copy()


def seq_sharded(t):
    return any(isinstance(p, Shard) and p.dim == 1 for p in t.placements)


def serve(cfg, placed):
    model = lm_init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    b = {k: torch.from_numpy(v) for k, v in prompts(cfg).items()}
    out = {}
    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        if placed:
            model = place(model, to_shardings(
                mesh, rules, param_specs(cfg, model), model), mesh)
            b = place(b, to_shardings(mesh, rules, batch_specs(b), b), mesh)
        st, logits = make_prefill(cfg, max_len=max_len(cfg))(model, b)
        out["prefill"] = host(logits)
        if placed and cfg.encoder_layers:
            out["cross_kv_seq"] = np.array(seq_sharded(st.cache[0]["cross"].k))
        dec = make_decode_step(cfg)
        for i in range(DEC):
            st, lg = dec(model, st)
            out[f"dec{i}"] = host(lg)
            out[f"tok{i}"] = host(st.last_token)
    return out


def moments(st, tag):
    return {f"{tag}{k}.{n}": host(t)
            for k in st.opt_state._fields[1:]
            for n, t in getattr(st.opt_state, k).items()}


def train(cfg, placed):
    st = init_state(torch.Generator().manual_seed(0), cfg, SETTINGS,
                    device="cpu")
    out = {}
    rules = make_rules(mesh, fsdp=True, sequence_parallel=True)
    bb = batches(cfg)
    with use_rules(rules):
        specs = to_shardings(mesh, rules, train_state_specs(
            cfg, cfg.optimizer, st), st)
        if placed:
            b0 = {k: torch.from_numpy(v) for k, v in bb[0].items()}
            b_sh = to_shardings(mesh, rules, batch_specs(b0), b0)
            want = shard_bytes(st, specs, mesh.shape) + shard_bytes(
                b0, b_sh, mesh.shape)
            st = place(st, specs, mesh)
            pb = place(b0, b_sh, mesh)
            # the state's two step counters count as int32 scalars
            got = 8 + sum(t.untyped_storage().nbytes()
                          for t in _leaves((st.params, st.opt_state, pb)))
            out["arg_bytes"] = np.array([got, want])
        step = make_train_step(cfg, SETTINGS)
        for i, t in enumerate(bb):
            st, m = step(st, t)
            out[f"loss{i}"] = float(m["loss"])
            out[f"gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                out.update(moments(st, "m1."))
                for n, p in st.params.named_parameters():
                    out["p1." + n] = host(p)
        out.update(moments(st, "m2."))
        for n, p in st.params.named_parameters():
            out["p." + n] = host(p)
    return out, st


for name, arch in CASES:
    cfg = get_reduced(arch)
    res = {}
    # float32 numerics on both sides (see the test's docstring)
    attn._bf16 = lambda x: x.to(torch.float32)
    for tag, placed in (("one", False), ("placed", True)):
        res.update({f"{tag}32.{k}": v for k, v in serve(cfg, placed).items()})
        res.update({f"{tag}32.{k}": v
                    for k, v in train(cfg, placed)[0].items()})
    if cfg.encoder_layers:     # 15 frames: the cross cache's kv_seq dropped
        odd = dataclasses.replace(cfg, encoder_seq=15)
        for tag, placed in (("one", False), ("placed", True)):
            res.update({f"odd{tag}.{k}": v
                        for k, v in serve(odd, placed).items()})
    attn._bf16 = BF16
    res.update({f"bf.{k}": v for k, v in serve(cfg, True).items()})
    tr, st = train(cfg, True)
    res.update({f"bf.{k}": v for k, v in tr.items()})
    if name == "jamba":
        save_pytree(st, f"{out_dir}/port_ckpt_{name}")
    np.savez(f"{out_dir}/port_{name}_r{rank}.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    for name, arch in CASES:
        cfg = get_reduced(arch)
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


def _named(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


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


def _moments_match(r: dict, step: int) -> None:
    """Each optimizer moment after ``step`` steps within float32 1e-5,
    a second moment (AdamW's ν, Adafactor's vr / vc) as its root."""
    keys = [k[len("one32."):] for k in r
            if k.startswith(f"one32.m{step}.")]
    assert keys
    for k in keys:
        field = k.split(".")[1]
        root = (lambda a: a) if field == "mu" else np.sqrt
        assert _rel(root(r[f"placed32.{k}"]), root(r[f"one32.{k}"])) \
            <= REL32, k


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_serving_matches_one_process(runs, name):
    r = _load(runs, name)
    for k in ["prefill"] + [f"dec{i}" for i in range(DEC)]:
        assert _rel(r[f"placed32.{k}"], r[f"one32.{k}"]) <= REL32, k
    for i in range(DEC):
        np.testing.assert_array_equal(r[f"placed32.tok{i}"],
                                      r[f"one32.tok{i}"])


@pytest.mark.parametrize("frames,on_kv_seq", [("16", True), ("15", False)])
def test_whisper_cross_cache_on_kv_seq_where_frames_divide(runs, frames,
                                                           on_kv_seq):
    """16 encoder frames split over the 2-way model axis; 15 do not, and
    the cross cache stays whole on every model shard (whisper-small's
    1,500 frames on a 16-way axis): decode equals one process both ways."""
    r = _load(runs, "whisper")
    pre = "placed32." if frames == "16" else "oddplaced."
    one = "one32." if frames == "16" else "oddone."
    assert bool(r[pre + "cross_kv_seq"]) is on_kv_seq
    for k in ["prefill"] + [f"dec{i}" for i in range(DEC)]:
        assert _rel(r[pre + k], r[one + k]) <= REL32, k
    for i in range(DEC):
        np.testing.assert_array_equal(r[f"{pre}tok{i}"], r[f"{one}tok{i}"])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_training_matches_one_process(runs, name):
    r = _load(runs, name)
    for i in range(2):
        for k in (f"loss{i}", f"gnorm{i}"):
            assert _rel(r[f"placed32.{k}"], r[f"one32.{k}"]) <= REL32, k
    if name not in ADAFACTOR:
        _moments_match(r, 1)
    for n, want in _named(r, "one32.p.").items():
        assert np.abs(r[f"placed32.p.{n}"] - want).max() <= 4 * LR, n


@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_moments_after_two_steps_match_one_process(runs, name):
    """Adafactor's row and column moments (factored leaves) and its full
    second moment (the rest) after two placed steps, their means and RMS
    clip all-reduced across shards."""
    r = _load(runs, name)
    assert any(k.startswith("one32.m2.vc.") and r[k].ndim == 1
               and r[k].size > 1 for k in r)        # a factored leaf
    _moments_match(r, 2)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_placed_run_matches_jax_gspmd(runs, name):
    cfg = get_reduced(dict(CASES)[name])
    r, j = _load(runs, name), dict(np.load(runs / f"jax_{name}.npz"))
    for k in ["prefill"] + [f"dec{i}" for i in range(DEC)]:
        assert _rel(r[f"bf.{k}"], j[k]) <= REL, k
    for k, rtol in (("loss0", 1e-3), ("gnorm0", 1e-3), ("loss1", 1e-3),
                    ("gnorm1", 1e-2)):
        np.testing.assert_allclose(r[f"bf.{k}"], j[k], rtol=rtol, err_msg=k)
    got = _jax_flat(_named(r, "bf.p1."), cfg)
    assert got
    for k, v in got.items():
        assert np.abs(v - j[f"p1.{k}"]).max() <= 2.0001 * LR, k


@pytest.mark.parametrize("rank", range(4))
def test_rank_argument_bytes_equal_shard_bytes(runs, rank):
    for name, _ in CASES:
        got, want = _load(runs, name, rank)["bf.arg_bytes"]
        assert got == want, (name, got, want)


def test_jamba_checkpoint_restores_in_one_process_and_jax(runs):
    cfg = get_reduced("jamba-v0.1-52b")
    r = _load(runs, "jamba")
    s = TrainSettings(num_microbatches=2, warmup_steps=0, learning_rate=LR)
    like = init_state(None, cfg, s, lambda g: abstract_params(cfg),
                      device="meta")
    back = restore_pytree(like, str(runs / "port_ckpt_jamba"), device="cpu")
    assert back.step == 2
    for n, p in back.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), r[f"bf.p.{n}"],
                                      err_msg=n)
    for k in ("vr", "vc"):
        for n, t in getattr(back.opt_state, k).items():
            np.testing.assert_array_equal(t.numpy(), r[f"bf.m2.{k}.{n}"],
                                          err_msg=n)
    # JAX's restore of the same files: every rank's shards assembled
    from repro import configs as jcfg
    jc = jcfg.get_reduced("jamba-v0.1-52b")
    want = _jax_flat(_named(r, "bf.p."), cfg)
    jlike = jax.eval_shape(lambda k: jstep.init_state(
        k, jc, jstep.TrainSettings(num_microbatches=2)),
        jax.ShapeDtypeStruct((2,), np.uint32))
    jback = jck.restore_pytree(jlike, str(runs / "port_ckpt_jamba"))
    assert int(jback.step) == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jback.params)[0]:
        k = ".".join(str(getattr(e, "key", e)) for e in path)
        np.testing.assert_array_equal(np.asarray(leaf), want[k], err_msg=k)
    # the Adafactor moments, stacked as JAX stacks them
    vr = _jax_flat(_named(r, "bf.m2.vr."), cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jback.opt_state.vr)[0]:
        k = ".".join(str(getattr(e, "key", e)) for e in path)
        np.testing.assert_array_equal(np.asarray(leaf), vr[k], err_msg=k)
