"""Parity of the port's LM serving path (``serve.engine``, the early-exit
gates and ``launch.serve``) with the JAX package's, on the CPU, at the
archs' ``get_reduced`` size.

JAX's ``lm_init`` parameters cross through ``convert.lm_params_from_jax``;
prompts and frames are numpy arrays from a seed.  The JAX side runs its
``make_prefill`` / ``make_decode_step`` under ``jax.jit`` in ``generate``'s
own loop (``test_jax_loop_is_jax_generate`` ties the two together).

Tolerances, with their reasons:

* Logits: ``|Δ| ≤ 1e-2 · max|JAX|``, as ``tests/test_torch_models.py``
  states: float32 compute, but the attention products round their operands
  to bfloat16 and an operand within an ulp of a rounding boundary can round
  the other way in one package.
* The port is teacher-forced with JAX's tokens and done flags: every
  step's logits are compared under the bound above, its lengths exactly.
  Its free-running ``generate`` must then give JAX's tokens and active
  counts exactly up to the first step at which a lane still running has a
  top-2 margin in JAX's logits no wider than twice that step's largest
  logit difference (where the margin is wider, no difference that small
  can change an argmax; up to that step the free run and the forced run
  compute the same thing).  Seeds are not chosen to avoid near-ties.
* Caches after the loop: the logit bound, per leaf.  Gates, ``pad_cache_to``
  shapes and zeros, retired lanes: exact.
"""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import serve as jlaunch
from repro.models import transformer as jtr
from repro.serve import early_exit as jee
from repro.serve import engine as jeng
from repro_torch import configs as tcfg
from repro_torch.convert import lm_cache_to_jax_layout, lm_params_from_jax
from repro_torch.launch import serve as tlaunch
from repro_torch.models.attention import AttnCache
from repro_torch.models.mamba import MambaCache
from repro_torch.serve import early_exit as tee
from repro_torch.serve import engine as teng

REL = 1e-2
B, PROMPT, STEPS = 4, 8, 10
MAX_LEN = PROMPT + STEPS + 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _scale(x):
    return max(float(np.abs(np.asarray(x, np.float32)).max()), 1e-6)


def _close(got, want, what):
    got = np.asarray(got.float().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= REL * _scale(want), f"{what}: |Δ| {err} > {REL}·scale"


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))
           .astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 0.5, (B, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch, vocab=None):
    kw = {} if vocab is None else {"vocab": vocab}
    jc, tc = jcfg.get_reduced(arch, **kw), tcfg.get_reduced(arch, **kw)
    jp = jax.tree.map(np.asarray, jtr.lm_init(jax.random.PRNGKey(1), jc))
    if vocab is not None:
        # make the padded columns large, so that one of them wins the
        # full-width argmax in most rows
        jp["lm_head"] = jp["lm_head"].copy()
        jp["lm_head"][:, vocab:] *= 100.0
    model = lm_params_from_jax(jp, tc, device="cpu")
    pre = jax.jit(jeng.make_prefill(jc, max_len=MAX_LEN))
    dec = jax.jit(jeng.make_decode_step(jc))
    return jc, tc, jp, model, pre, dec


def _jax_loop(arch, patience, vocab=None):
    """``jeng.generate``'s loop on the jitted steps, keeping each step's
    logits, tokens, lengths and done flags."""
    jc, _, jp, _, pre, dec = _setup(arch, vocab)
    batch = {k: jnp.asarray(v) for k, v in _prompts(jc).items()}
    state, plog = pre(jp, batch)
    first = np.asarray(state.last_token)
    gate = jee.stability_gate(B, patience) if patience else None
    steps = []
    for _ in range(STEPS):
        state, logits = dec(jp, state)
        if gate is not None:
            state = state._replace(done=state.done
                                   | gate(state.last_token, logits))
        steps.append({"logits": np.asarray(logits),
                      "token": np.asarray(state.last_token),
                      "cur": np.asarray(state.cur_len),
                      "done": np.asarray(state.done),
                      "active": int(jnp.sum(~state.done))})
    return np.asarray(plog[:, -1]), first, steps, state


def _margin(logits, width):
    top = np.sort(np.asarray(logits, np.float32)[:, :width], axis=-1)
    return top[:, -1] - top[:, -2]


def _first_near_tie(jc, plog, steps, errs, gated):
    """The first step whose tokens (or, gated, whose gate predictions over
    the padded width) JAX decided, among lanes still running, by a top-2
    margin of at most twice that step's largest logit difference between
    the packages (``errs[0]`` the prefill's, ``errs[t + 1]`` step t's);
    STEPS if none.  Where every margin is wider, both packages' argmaxes
    must agree."""
    if (_margin(plog, jc.vocab_size) <= 2 * errs[0]).any():
        return 0
    done = np.zeros(B, bool)
    for t, s in enumerate(steps):
        m = _margin(s["logits"], jc.vocab_size)
        if gated:
            m = np.minimum(m, _margin(s["logits"], jc.padded_vocab))
        if (m[~done] <= 2 * errs[t + 1]).any():
            return t
        done = s["done"]
    return STEPS


GEN_ARCHS = ["qwen3-4b", "gemma2-9b", "mamba2-1.3b", "whisper-small"]


@pytest.mark.parametrize("patience", [0, 2])
@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_generate_matches_jax(arch, patience):
    jc, tc, _, model, _, _ = _setup(arch)
    plog, first, steps, jstate = _jax_loop(arch, patience)
    batch = {k: _t(v) for k, v in _prompts(jc).items()}
    gate = tee.stability_gate(B, patience, device="cpu") if patience \
        else None
    toks, active = teng.generate(model, batch, tc, steps=STEPS,
                                 max_len=MAX_LEN, early_exit_fn=gate)
    assert toks.shape == (B, STEPS) and toks.dtype == torch.int32
    assert active.shape == (STEPS,)
    assert (np.diff(active.numpy()) <= 0).all()
    if not patience:
        assert (active.numpy() == B).all()

    # teacher-forced: the port's steps on JAX's tokens and done flags
    prefill = teng.make_prefill(tc, max_len=MAX_LEN)
    decode = teng.make_decode_step(tc)
    state, tplog = prefill(model, batch)
    _close(tplog[:, -1], plog, f"{arch} prefill logits")
    errs = [float((tplog[:, -1] - _t(plog)).abs().max())]
    first_token = state.last_token.clone()
    state = state._replace(last_token=_t(first))
    for t, s in enumerate(steps):
        state, logits = decode(model, state)
        _close(logits, s["logits"], f"{arch} step {t} logits")
        errs.append(float((logits - _t(s["logits"])).abs().max()))
        np.testing.assert_array_equal(state.cur_len.numpy(), s["cur"])
        state = state._replace(last_token=_t(s["token"]),
                               done=_t(s["done"]))

    # free-running: the same tokens and active counts up to a near-tie
    t_star = _first_near_tie(jc, plog, steps, errs, gated=bool(patience))
    if t_star > 0:
        np.testing.assert_array_equal(first_token.numpy(), first)
    want = np.stack([s["token"] for s in steps], axis=1)
    np.testing.assert_array_equal(toks[:, :t_star].numpy(),
                                  want[:, :t_star])
    np.testing.assert_array_equal(
        active[:t_star].numpy(), [s["active"] for s in steps[:t_star]])
    got = lm_cache_to_jax_layout(state.cache, tc)
    for j, parts in jstate.cache.items():
        for part, nt in parts.items():
            for f, leaf in nt._asdict().items():
                _close(got[j][part][f], np.asarray(leaf),
                       f"{arch} final cache {j}.{part}.{f}")


def test_jax_loop_is_jax_generate():
    """The jitted loop above is JAX's own ``generate`` (run unjitted)."""
    jc, _, jp, _, _, _ = _setup("qwen3-4b")
    _, _, steps, _ = _jax_loop("qwen3-4b", 2)
    batch = {k: jnp.asarray(v) for k, v in _prompts(jc).items()}
    toks, active = jeng.generate(jp, batch, jc, steps=4, max_len=MAX_LEN,
                                 early_exit_fn=jee.stability_gate(B, 2))
    np.testing.assert_array_equal(
        np.asarray(toks), np.stack([s["token"] for s in steps[:4]], 1))
    np.testing.assert_array_equal(np.asarray(active),
                                  [s["active"] for s in steps[:4]])


def test_retired_lanes_stay_frozen_bit_for_bit():
    _, tc, _, model, _, _ = _setup("gemma2-9b")
    batch = {k: _t(v) for k, v in _prompts(tc).items()}
    prefill = teng.make_prefill(tc, max_len=MAX_LEN)
    decode = teng.make_decode_step(tc)
    state, _ = prefill(model, batch)
    gate = tee.stability_gate(B, 1, device="cpu")
    retired = 0
    for _ in range(STEPS):
        old = state
        state, logits = decode(model, state)
        d = old.done
        assert torch.equal(state.cur_len[d], old.cur_len[d])
        assert torch.equal(state.last_token[d], old.last_token[d])
        assert torch.equal(state.cur_len[~d], old.cur_len[~d] + 1)
        for new_e, old_e in zip(state.cache, old.cache):
            for part in new_e:
                for n, o in zip(new_e[part], old_e[part]):
                    assert torch.equal(n[d], o[d])
        retired += int(d.sum())
        state = state._replace(done=state.done
                               | gate(state.last_token, logits))
    assert retired > 0


def test_pad_cache_to_grows_self_kv_only():
    for arch in ("whisper-small", "jamba-v0.1-52b"):
        jc, tc, jp, model, _, _ = _setup(arch)
        nb = _prompts(jc)
        _, jcache, _ = jax.jit(functools.partial(
            jtr.lm_apply, cfg=jc, mode="prefill"))(
                jp, {k: jnp.asarray(v) for k, v in nb.items()})
        with torch.no_grad():
            _, tcache, _ = teng.lm_apply(model, {k: _t(v) for k, v in
                                                 nb.items()}, tc,
                                         mode="prefill")
        jpad = jeng.pad_cache_to(jcache, MAX_LEN)
        tpad = teng.pad_cache_to(tcache, MAX_LEN)
        got = lm_cache_to_jax_layout(tpad, tc)
        for j, parts in jpad.items():
            for part, nt in parts.items():
                for f, leaf in nt._asdict().items():
                    assert got[j][part][f].shape == np.asarray(leaf).shape
        for old, new in zip(tcache, tpad):
            for part, c in old.items():
                n = new[part]
                if part == "self" and isinstance(c, AttnCache):
                    assert n.k.shape[1] == MAX_LEN
                    assert torch.equal(n.k[:, :PROMPT], c.k)
                    assert torch.equal(n.v[:, :PROMPT], c.v)
                    assert not n.k[:, PROMPT:].any()
                    assert not n.v[:, PROMPT:].any()
                else:      # cross K/V and SSM states: the same tensors
                    assert all(a is b for a, b in zip(n, c))
                    assert isinstance(c, (AttnCache, MambaCache))
        assert teng.pad_cache_to(tpad, 4)[0]["self"] is tpad[0]["self"]


def test_eos_gate_matches_jax():
    last = np.array([3, 7, 3, 0], np.int32)
    lg = np.zeros((4, 9), np.float32)
    got = tee.eos_gate(3)(_t(last), _t(lg))
    want = jee.eos_gate(3)(jnp.asarray(last), jnp.asarray(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stability_state_matches_jax_on_the_padded_width():
    rng = np.random.default_rng(4)
    t, j = tee.StabilityState(5, 2, device="cpu"), jee.StabilityState(5, 2)
    np.testing.assert_array_equal(t.prev.numpy(), np.asarray(j.prev))
    for step in range(12):
        lg = rng.normal(0, 1, (5, 7)).astype(np.float32)
        lg[:2, 6] += 5.0 * (step % 4 != 3)   # a column past a 6-token vocab
        last = np.zeros(5, np.int32)
        d_t, d_j = t(_t(last), _t(lg)), j(jnp.asarray(last), jnp.asarray(lg))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(t.prev.numpy(), np.asarray(j.prev))
        np.testing.assert_array_equal(t.streak.numpy(), np.asarray(j.streak))
        if step % 4 != 3:
            assert (t.prev[:2] == 6).all()
    with pytest.raises(RuntimeError, match="no CUDA device") \
            if not torch.cuda.is_available() else contextlib.nullcontext():
        tee.stability_gate(2)


def test_padded_column_wins_the_gate_not_the_token():
    """``make_decode_step`` picks tokens over ``[:vocab_size]``; its
    logits keep the padded width, and ``StabilityState`` takes its argmax
    there, so a padded column can win the gate, in both packages."""
    vocab = 250
    jc, tc, jp, model, pre, dec = _setup("qwen3-4b", vocab)
    assert tc.padded_vocab == 256
    jstate, jlog = pre(jp, {k: jnp.asarray(v)
                            for k, v in _prompts(jc).items()})
    prefill = teng.make_prefill(tc, max_len=MAX_LEN)
    decode = teng.make_decode_step(tc)
    state, tlog = prefill(model, {k: _t(v) for k, v in _prompts(jc).items()})
    _close(tlog[:, -1], np.asarray(jlog[:, -1]), "prefill logits")
    np.testing.assert_array_equal(state.last_token.numpy(),
                                  np.asarray(jstate.last_token))
    tgate = tee.StabilityState(B, 3, device="cpu")
    jgate = jee.StabilityState(B, 3)
    for _ in range(3):
        jstate, jl = dec(jp, jstate)
        state, tl = decode(model, state)
        assert tl.shape == (B, 256)
        _close(tl, np.asarray(jl), "decode logits")
        assert (state.last_token < vocab).all()
        np.testing.assert_array_equal(state.last_token.numpy(),
                                      np.asarray(jstate.last_token))
        tgate(state.last_token, tl)
        jgate(jstate.last_token, jl)
        np.testing.assert_array_equal(tgate.prev.numpy(),
                                      np.asarray(jgate.prev))
        assert (tgate.prev >= vocab).any()


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _template(line):
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_launcher_prints_jax_lines_on_the_cpu():
    argv = ["--arch", "qwen3-4b", "--requests", "2", "--prompt-len", "4",
            "--gen", "3"]
    got = _lines(lambda: tlaunch.main(argv, device="cpu"))
    want = _lines(lambda: jlaunch.main(argv))
    assert len(got) == len(want) == 3
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[0].startswith("generated (2, 3) in ")
    assert re.match(r"active sequence-steps: \d+/6 \(", got[1])
    whisper = _lines(lambda: tlaunch.main(
        ["--arch", "whisper-small", "--requests", "3", "--gen", "4"],
        device="cpu"))
    assert whisper[0].startswith("generated (3, 4) in ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(argv)


def _spec(entries):
    """A spec's entries as ``PartitionSpec`` prints them (a one-axis tuple
    is the axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def test_sharding_rules_match_jax_and_shard_only_checks_names():
    from repro.distributed import sharding as jsh
    from repro.launch import mesh as jmesh
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch import mesh as tmesh

    tm = tmesh.make_local_mesh(devices=["cpu"])
    jm = jmesh.make_local_mesh()
    assert tm.axis_names == jm.axis_names == ("data", "model")
    assert tmesh.mesh_axis_sizes(tm) == jmesh.mesh_axis_sizes(jm)
    for kw in ({}, {"fsdp": False}, {"sequence_parallel": True}):
        t, j = tsh.make_rules(tm, **kw), jsh.make_rules(jm, **kw)
        assert t.rules == j.rules and t.axis_sizes == j.axis_sizes
        for axes in (("batch", None, "heads", None), ("vocab", "embed")):
            assert _spec(t.spec(*axes)) == tuple(j.spec(*axes))
            assert _spec(t.spec_for_shape((4, 6, 8, 2), *axes)) == \
                tuple(j.spec_for_shape((4, 6, 8, 2), *axes))
            assert t.ways(axes[0]) == j.ways(axes[0])
    wide = tsh.ShardingRules(tsh.make_rules(tm).rules,
                             {"data": 2, "model": 4})
    jwide = jsh.ShardingRules(jsh.make_rules(jm).rules,
                              {"data": 2, "model": 4})
    assert _spec(wide.spec_for_shape((4, 6, 8), "batch", "heads",
                                     "mlp")) == tuple(jwide.spec_for_shape((4, 6, 8), "batch", "heads", "mlp"))
    assert tsh.make_rules(None).rules == {}
    assert tsh.current_rules() is None and tsh.logical_spec("batch") == ()
    x = torch.zeros(2, 3)
    assert tsh.shard(x, "no-such-axis") is x        # no rules: no check
    with tsh.use_rules(tsh.make_rules(tm)) as rules:
        assert tsh.current_rules() is rules
        assert tsh.logical_spec("batch", "heads") == (("data",), "model")
        assert tsh.shard(x, "batch", "mlp") is x
        with pytest.raises(KeyError, match="no-such-axis"):
            tsh.shard(x, "batch", "no-such-axis")
        with pytest.raises(ValueError, match="rank"):
            tsh.shard(x, "batch")
        _, tc, _, model, _, _ = _setup("qwen3-4b")
        with torch.no_grad():        # the model's own names all check out
            teng.lm_apply(model, {"tokens": torch.zeros(
                (2, 3), dtype=torch.int32)}, tc)
    assert tsh.current_rules() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_local_mesh()
