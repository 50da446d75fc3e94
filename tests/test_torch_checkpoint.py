"""The port's checkpoints (``checkpoint.manager``) against the JAX
package's, on the CPU: the same on-disk format, so either package restores
the other's checkpoints, bit for bit.

The format tests are the JAX package's (``tests/test_checkpoint.py``) on
the port's manager.  Cross-package, a train state crosses through the JAX
package's layout (``convert.train_state_to_jax``: layers stacked on a
leading axis, JAX's leaf ids): JAX's AdamW, Adafactor and ``int8_ef``
states and an 8-shard checkpoint written on a forced 8-device mesh (in a
subprocess) restore in the port exactly, and the port's restore in JAX's
``restore_pytree`` exactly.  Resume after an injected failure continues
bit for bit.  Every comparison here is exact.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import configs as jcfg
from repro.launch import train as jlaunch
from repro.models import transformer as jtr
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.convert import (lm_params_from_jax, lm_params_to_jax,
                                 train_state_to_jax)
from repro_torch.launch import train as tlaunch
from repro_torch.train import TrainLoop, TrainSettings, init_state
from repro_torch.train.step import TrainState, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def make_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(12, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_roundtrip(tmp_path):
    tree = make_tree(0)
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    assert_trees_equal(tree, restore_pytree(tree, d, device="cpu"))


def test_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path / "ck")
    save_pytree(make_tree(0), d)
    assert not os.path.exists(d + ".tmp")
    assert os.path.exists(os.path.join(d, "manifest.json"))


def test_overwrite_is_atomic(tmp_path):
    t1, t2 = make_tree(0), make_tree(1)
    d = str(tmp_path / "ck")
    save_pytree(t1, d)
    save_pytree(t2, d)
    assert_trees_equal(t2, restore_pytree(t1, d, device="cpu"))


def test_corruption_detected(tmp_path):
    tree = make_tree(0)
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    with open(os.path.join(d, "manifest.json")) as f:
        first = json.load(f)["leaves"]["a"]["shards"][0]["file"]
    with open(os.path.join(d, first), "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError, match="checksum"):
        restore_pytree(tree, d, device="cpu")


def _plus(tree, n):
    return {"a": tree["a"] + n,
            "nested": {k: v + n for k, v in tree["nested"].items()}}


def test_manager_async_save_restore_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = make_tree(0)
    for step in (10, 20, 30):
        mgr.save(step, _plus(tree, step))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 30
    got, step = mgr.restore(tree, device="cpu")
    assert step == 30
    assert_trees_equal(got, _plus(tree, 30))
    assert sorted(os.listdir(str(tmp_path))) == ["step_20", "step_30"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_save_snapshots_before_the_tree_changes(tmp_path):
    """``save`` copies CPU tensors to the host before returning: a step
    that changes the state in place next does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    tree = make_tree(0)
    want = tree["a"].clone()
    mgr.save(1, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    np.testing.assert_array_equal(
        mgr.restore(tree, device="cpu")[0]["a"].numpy(), want.numpy())


def test_same_files_and_ids_as_jax(tmp_path):
    """The same tree saved by both packages: the same leaf ids, shapes,
    dtypes, shard indices and file names, and byte-identical files."""
    tree = make_tree(0)
    save_pytree(tree, str(tmp_path / "t"))
    jck.save_pytree(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree),
                    str(tmp_path / "j"))
    mt, mj = [json.load(open(tmp_path / d / "manifest.json"))["leaves"]
              for d in ("t", "j")]
    assert mt == mj
    for meta in mt.values():
        f = meta["shards"][0]["file"]
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_pytree(tree, str(tmp_path / "t"))


# --------------------------------------------------------------------------
# train states across packages
# --------------------------------------------------------------------------

def _toks(cfg, n, seed=42):
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_state(arch, s, comp=False):
    """JAX's state after one jitted step (moments live); ``comp``: a
    random error-feedback residual."""
    jc = jcfg.get_reduced(arch)
    st = jstep.init_state(jax.random.PRNGKey(0), jc, s)
    st, _ = jax.jit(jstep.make_train_step(jc, s))(st, {
        k: jnp.asarray(v) for k, v in next(_toks(jc, 1)).items()})
    if comp:
        rng = np.random.default_rng(3)
        st = st._replace(comp_err=jax.tree.map(
            lambda p: jnp.asarray(rng.normal(0, 1e-3, p.shape)
                                  .astype(np.float32)), st.params))
    return jc, st


def _port_like(arch, s):
    tc = tcfg.get_reduced(arch)
    return tc, init_state(torch.Generator().manual_seed(5), tc, s,
                          device="cpu")


def _equal_walk(a, b, path=""):
    if hasattr(b, "_asdict"):
        b = b._asdict()
    if isinstance(b, dict):
        b = {k: v for k, v in b.items() if v is not None}
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _equal_walk(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


CASES = [("qwen3-4b", dict(warmup_steps=0)),                         # AdamW
         ("nemotron-4-340b", dict(warmup_steps=0)),                  # Adafactor
         ("llama3-8b", dict(warmup_steps=0,
                                grad_compression="int8_ef"))]       # int8_ef


@pytest.mark.parametrize("arch,kw", CASES, ids=["adamw", "adafactor",
                                                "int8_ef"])
def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path, arch, kw):
    s = jstep.TrainSettings(**kw)
    jc, jst = _jax_state(arch, s, comp="grad_compression" in kw)
    jck.save_pytree(jst, str(tmp_path / "ck"))
    tc, like = _port_like(arch, TrainSettings(**kw))
    got = restore_pytree(like, str(tmp_path / "ck"), device="cpu")
    assert isinstance(got, TrainState) and got.step == 1
    assert type(got.opt_state) is type(like.opt_state)
    _equal_walk(train_state_to_jax(got, tc), jax.tree.map(np.asarray, jst))
    if "grad_compression" in kw:
        assert got.comp_err is not None


@pytest.mark.parametrize("arch,kw", CASES, ids=["adamw", "adafactor",
                                                "int8_ef"])
def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path, arch, kw):
    tc, st = _port_like(arch, TrainSettings(**kw))
    step = make_train_step(tc, TrainSettings(**kw))
    for _, b in zip(range(2), _toks(tc, 2)):
        st, _ = step(st, b)
    if st.comp_err is not None:
        for e in st.comp_err.values():
            e.normal_(0, 1e-3, generator=torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st.step, st)
    mgr.wait()
    jc = jcfg.get_reduced(arch)
    _, jlike = _jax_state(arch, jstep.TrainSettings(**kw))
    got = jck.restore_pytree(jlike, str(tmp_path / "step_2"))
    want = train_state_to_jax(st, tc)
    _equal_walk(want, jax.tree.map(np.asarray, got))
    # and back into the port
    again, at = mgr.restore(st, device="cpu")
    assert at == 2
    _equal_walk(train_state_to_jax(again, tc), want)


ELASTIC = """
import sys, jax, numpy as np
from repro.checkpoint import save_pytree
from repro.configs import get_reduced
from repro.distributed.partition import to_shardings, train_state_specs
from repro.distributed.sharding import make_device_mesh, make_rules, use_rules
from repro.train import TrainSettings, init_state

cfg = get_reduced("qwen3-4b")
s = TrainSettings()
state = init_state(jax.random.PRNGKey(0), cfg, s)
state = state._replace(params=jax.tree.map(
    lambda p: p + np.arange(p.size, dtype=np.float32).reshape(p.shape)
    * 1e-3, state.params))
mesh = make_device_mesh((2, 4), ("data", "model"))
rules = make_rules(mesh, fsdp=True)
with mesh, use_rules(rules):
    sh = to_shardings(mesh, rules, train_state_specs(cfg, cfg.optimizer,
                                                     state), state)
    save_pytree(jax.device_put(state, sh), sys.argv[1])
"""


def test_jax_8_shard_checkpoint_restores_whole_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(ELASTIC), d],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    leaves = json.load(open(os.path.join(d, "manifest.json")))["leaves"]
    assert max(len(m["shards"]) for m in leaves.values()) == 8
    jc = jcfg.get_reduced("qwen3-4b")
    jlike = jstep.init_state(jax.random.PRNGKey(0), jc, jstep.TrainSettings())
    want = jax.tree.map(np.asarray, jck.restore_pytree(jlike, d))
    tc, like = _port_like("qwen3-4b", TrainSettings())
    # shardings= has no meaning on one card: accepted, every leaf whole
    got = restore_pytree(like, d, shardings=object(), device="cpu")
    _equal_walk(train_state_to_jax(got, tc), want)


def test_train_resume_bit_identical(tmp_path):
    """Crash + restore ⇒ identical continuation (the JAX package's
    ``test_train_resume_bit_identical`` on the port)."""
    tc = tcfg.get_reduced("qwen3-4b")
    s = TrainSettings(learning_rate=1e-3)
    step = make_train_step(tc, s)

    def fresh():
        return init_state(torch.Generator().manual_seed(0), tc, s,
                          device="cpu")

    mgr = CheckpointManager(str(tmp_path / "run"))
    loop = TrainLoop(step, fresh(), ckpt_manager=mgr, ckpt_every=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.run(_toks(tc, 10), 10, fail_at_step=4)
    mgr.wait()

    ref = fresh()
    gen = _toks(tc, 6)
    for _ in range(6):
        ref, _ = step(ref, next(gen))

    restored, at = mgr.restore(fresh(), device="cpu")
    assert at == 4 and restored.step == 4
    gen2 = _toks(tc, 6)
    for _ in range(4):
        next(gen2)                      # the data pipeline skips replayed steps
    final = TrainLoop(step, restored).run(gen2, 2)
    assert final.step == 6
    _equal_walk(train_state_to_jax(final, tc), train_state_to_jax(ref, tc))


def test_params_cross_both_ways():
    for arch in ("jamba-v0.1-52b", "whisper-small", "gemma2-9b"):
        jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
        jp = jax.tree.map(np.asarray, jtr.lm_init(jax.random.PRNGKey(2), jc))
        _equal_walk(lm_params_to_jax(lm_params_from_jax(jp, tc,
                                                        device="cpu"), tc),
                    jp)


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _template(line):
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_launcher_prints_jax_lines_and_resumes(tmp_path):
    argv = ["--arch", "qwen3-4b", "--steps", "3", "--batch", "2", "--seq",
            "8"]
    got = _lines(lambda: tlaunch.main(argv, device="cpu"))
    want = _lines(lambda: jlaunch.main(argv))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[0].startswith("step     1  loss ")
    assert got[-1].startswith("final loss ")
    ck = ["--ckpt-dir", str(tmp_path / "run"), "--ckpt-every", "2"]
    first = _lines(lambda: tlaunch.main(argv + ck, device="cpu"))
    again = _lines(lambda: tlaunch.main(argv + ck, device="cpu"))
    assert not first[0].startswith("resumed")
    assert again[0] == "resumed from step 3"
    # make_batches is JAX's, array for array
    for arch in ("llava-next-34b", "whisper-small"):
        jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
        for j, t in zip(jlaunch.make_batches(jc, 2, 16),
                        tlaunch.make_batches(tc, 2, 16)):
            assert set(j) == set(t)
            for k in j:
                np.testing.assert_array_equal(t[k], j[k])
            break
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(argv)
