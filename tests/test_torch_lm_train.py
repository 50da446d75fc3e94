"""Parity of the port's LM training half (``data.tokens``, Adafactor, the
train step, the loop and ``launch.train``) with the JAX package's, on the
CPU, at the archs' ``get_reduced`` size.

JAX's ``lm_init`` parameters cross through ``convert.lm_params_from_jax``;
batches are numpy arrays from a seed; the JAX side's loss and step run
under ``jax.jit``.  Tolerances, with their reasons:

* Token stream: equal arrays (the same numpy code on the same seeds).
* ``cross_entropy`` on the same float32 logits: rtol 1e-6 (a
  ``logsumexp`` in a different summation order); accuracy exact.
* Gradients of the whole loss, per JAX leaf: ``|Δ| ≤ 1e-2 · max|g_JAX|``.
  The reduced configs compute in float32 but round the attention
  operands to bfloat16, and an operand within an ulp of a rounding
  boundary rounds the other way in one package (the bound
  ``tests/test_torch_models.py`` states for the logits; 4.9e-3 measured
  at most over the ten archs).  Loss: rtol 1e-3; the MoE auxes: rtol 1e-3
  (router probabilities see the same flips).
* Optimizers on JAX's own gradients passed across (so no sign of a
  near-zero gradient can differ): parameters and every state leaf after
  two updates within ``1e-6 · max|JAX leaf|``.  Both run float32 with
  correctly rounded square roots; XLA fuses multiply-adds inside its
  streamed loop, which leaves a few ulps (2.3e-7 measured).
* Microbatching and ``cast_params``: the JAX package's own bounds
  (``tests/test_train_serve.py``: loss rtol 1e-5, params rtol 1e-4 / atol
  1e-5; ``tests/test_perf_variants.py``: 5e-2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data import tokens as jtok
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch.convert import (_stack_named, _unstack_named,
                                 lm_params_from_jax, lm_params_to_jax,
                                 train_state_to_jax)
from repro_torch.data import tokens as ttok
from repro_torch.optim import optimizer as topt
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

ARCHS = [a for a in jcfg.list_archs() if a != "snn-mnist"]
B, S = 2, 12
GRAD_REL = 1e-2
OPT_REL = 1e-6


def _batch(cfg, seed=0, b=B, s=S):
    """numpy tokens and next-token labels from a seed, plus the vlm
    patches / whisper frames the stub frontends provide."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, s // 2)
        out["patches"] = rng.normal(0, 0.5, (b, p, cfg.d_model)) \
            .astype(np.float32)
        out["tokens"] = out["tokens"][:, :s - p]
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 0.5, (b, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return out


def _j(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def _t(nb):
    return {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}


@functools.lru_cache(maxsize=None)
def _params(arch, optimizer=None):
    jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    if optimizer:
        jc = dataclasses.replace(jc, optimizer=optimizer)
        tc = dataclasses.replace(tc, optimizer=optimizer)
    jp = jax.tree.map(np.asarray, jtr.lm_init(jax.random.PRNGKey(0), jc))
    return jc, tc, jp


def _model(tc, jp):
    return lm_params_from_jax(jp, tc, device="cpu")


def _walk(a, b, fn, path=""):
    """``fn(path, port leaf, JAX leaf)`` over two nested dict / namedtuple
    trees with the same keys."""
    if hasattr(a, "_asdict"):
        a = a._asdict()
    if hasattr(b, "_asdict"):
        b = b._asdict()
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _walk(a[k], b[k], fn, f"{path}.{k}")
        return
    fn(path, np.asarray(a), np.asarray(b))


def _close_rel(rel):
    def check(path, got, want):
        assert got.shape == want.shape, (path, got.shape, want.shape)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= rel * scale, f"{path}: |Δ| {err} > {rel} · {scale}"
    return check


# --------------------------------------------------------------------------
# token stream and loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,hosts", [
    (256, 16, 4, 1), (151_936, 64, 8, 2), (1000, 20, 6, 3), (50, 40, 2, 1)])
def test_token_stream_matches_jax(vocab, seq, batch, hosts):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=3)
    jc, tc = jtok.TokenStreamConfig(**kw), ttok.TokenStreamConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    np.testing.assert_array_equal(
        ttok.sample_tokens(tc, np.random.default_rng(5), batch),
        jtok.sample_tokens(jc, np.random.default_rng(5), batch))
    for host in range(hosts):
        jit = jtok.token_batches(jc, host_id=host, num_hosts=hosts)
        tit = ttok.token_batches(tc, host_id=host, num_hosts=hosts)
        for _ in range(3):
            j, t = next(jit), next(tit)
            for k in ("tokens", "labels"):
                assert t[k].dtype == np.int32
                np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("vp,vocab", [(11, 11), (16, 11), (8, 4)])
def test_cross_entropy_matches_jax(vp, vocab):
    rng = np.random.default_rng(vp)
    logits = rng.normal(0, 2, (3, 5, vp)).astype(np.float32)
    logits[0, 0, vp - 1] = 50.0          # mass on a padded slot, if any
    labels = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    labels[1, 2] = int(np.argmax(logits[1, 2, :vocab]))   # a right guess
    jn, ja = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 vocab)
    tn, ta = tstep.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), vocab)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert float(ta) == float(ja) > 0
    lp = torch.log_softmax(torch.from_numpy(logits)[..., :vocab], -1)
    want = -torch.gather(lp, -1, torch.from_numpy(labels).long()[..., None])
    np.testing.assert_allclose(float(tn), float(want.mean()), rtol=1e-6)
    # bf16 logits are computed in float32, as in JAX
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    jb = jstep.cross_entropy(jnp.asarray(bf.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(labels), vocab)[0]
    np.testing.assert_allclose(
        float(tstep.cross_entropy(bf, torch.from_numpy(labels), vocab)[0]),
        float(jb), rtol=1e-6)


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_per_leaf(arch):
    jc, tc, jp = _params(arch)
    nb = _batch(jc)
    js, ts = jstep.TrainSettings(), tstep.TrainSettings()
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jc, js), has_aux=True))(jp, _j(nb))
    model = _model(tc, jp)
    loss, m = tstep.make_loss_fn(tc, ts)(model, _t(nb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    for k in ("ce", "acc", "lb_loss", "router_z"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-3, err_msg=k)
    if jc.moe_num_experts:
        assert float(m["lb_loss"].detach()) > 0
    tg = _stack_named({n: p.grad for n, p in model.named_parameters()},
                      tc, lambda ts_, st: np.stack([t.numpy() for t in ts_])
                      if st else ts_[0].numpy())
    _walk(tg, jax.tree.map(np.asarray, jg), _close_rel(GRAD_REL))


# --------------------------------------------------------------------------
# optimizers on JAX's gradients
# --------------------------------------------------------------------------

OPT_CASES = [("qwen3-4b", "sgd"), ("qwen3-4b", "adamw"),
             ("nemotron-4-340b", "adafactor"), ("llava-next-34b", "adafactor"),
             ("whisper-small", "adafactor")]


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
@pytest.mark.parametrize("arch,opt", OPT_CASES)
def test_optimizer_matches_jax_on_jax_grads(arch, opt, stream):
    """Two updates from JAX's gradients of two batches: SGD / AdamW /
    Adafactor, streamed (a layer at a time, the rest in one call) or the
    whole tree at once.  Adafactor covers the stacked factoring trap
    (nemotron's and llava's ``(2, 64, 128)`` MLP leaves, factored on the
    stacked shape and not per layer) and whisper's encoder leaves, whose
    RMS clip spans the stack in both settings."""
    jc, tc, jp = _params(arch, opt)
    js = jstep.TrainSettings(warmup_steps=0, learning_rate=1e-3,
                             stream_optimizer=stream)
    ts = tstep.TrainSettings(warmup_steps=0, learning_rate=1e-3,
                             stream_optimizer=stream)
    jo, to = jstep.make_optimizer(jc, js), tstep.make_optimizer(tc, ts)
    model = _model(tc, jp)
    params = dict(model.named_parameters())
    names = list(params)
    jst, tst = jo.init(jp), to.init(params)
    jgrad = jax.jit(jax.grad(lambda p, b: jstep.make_loss_fn(jc, js)(p, b)[0]))
    jparams = jp
    for it in range(2):
        jg = jgrad(jparams, _j(_batch(jc, seed=it)))
        tg = _unstack_named(jax.tree.map(np.asarray, jg), names, tc, "cpu")
        gn = jopt.global_norm(jg)
        scale = jnp.minimum(1.0, js.clip_norm / (gn + 1e-9))
        tscale = torch.tensor(float(scale))
        if stream:
            jparams, jst = jstep.streamed_update(jo, jg, jst, jparams,
                                                 grad_scale=scale)
            _, tst = tstep.streamed_update(to, tg, tst, params,
                                           grad_scale=tscale)
            assert not tg            # every gradient consumed
        else:
            u, jst = jo.update(jax.tree.map(lambda g: g * scale, jg), jst,
                               jparams)
            jparams = jopt.apply_updates(jparams, u)
            with torch.no_grad():
                u, tst = to.update({n: g * tscale for n, g in tg.items()},
                                   tst, params)
                new = topt.apply_updates(params, u)
                for n, p in params.items():
                    p.copy_(new[n])
        jparams = jax.tree.map(np.asarray, jparams)
    assert tst.step == int(jst.step) == 2
    got = train_state_to_jax(tstep.TrainState(2, model, tst, None), tc)
    _walk(got["params"], jparams, _close_rel(OPT_REL))
    _walk(got["opt_state"], jax.tree.map(np.asarray, jst), _close_rel(OPT_REL))
    if opt == "adafactor" and arch != "whisper-small":
        # factored on the stacked (2, 64, 128): per-layer row/col moments
        assert tuple(tst.vr["layers.0.mlp.w1"].shape) == (64,)
        assert tuple(tst.vc["layers.0.mlp.w1"].shape) == (128,)
        assert not topt.factored((64, 128)) and topt.factored((2, 64, 128))
        # unfactored stacked leaves: a scalar dummy per layer, (nb,) stacked
        assert tst.vc["layers.0.ln1.scale"].shape == ()
        assert got["opt_state"]["vc"]["blocks"]["p0"]["ln1"]["scale"] \
            .shape == (2,)


def test_clip_by_global_norm_promotes_bf16_as_jax():
    """A bf16 gradient times the float32 clip scale is float32 in JAX; the
    port kept it bf16 before (its SNN path only ever clipped float32)."""
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(0, 3, (5, 7)).astype(np.float32),
         "b": rng.normal(0, 3, (11,)).astype(np.float32)}
    jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    tc, tn = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        assert tc[k].dtype == torch.float32 and jc[k].dtype == jnp.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


def test_streamed_update_slices_large_leaves_without_changing_values(
        monkeypatch):
    """An element-wise optimizer's streamed update takes big leaves in row
    slices (each a separate update call): the same values as whole
    leaves."""
    jc, tc, jp = _params("qwen3-4b")
    s = tstep.TrainSettings(warmup_steps=0, learning_rate=1e-3)
    nb = _batch(jc)
    out = []
    for slice_elems in (1 << 26, 100):
        monkeypatch.setattr(tstep, "_SLICE_ELEMS", slice_elems)
        st = tstep.init_state(None, tc, s, lambda g: _model(tc, jp),
                              device="cpu")
        for i in range(2):
            st, _ = tstep.make_train_step(tc, s)(st, _batch(jc, seed=i))
        out.append(train_state_to_jax(st, tc))
    assert len(tstep._rows(torch.zeros(256, 64))) == 256
    _walk(out[1], out[0], lambda p, a, b: np.testing.assert_array_equal(
        a, b, err_msg=p))


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _run(tc, jp, s, nb, steps=1):
    st = tstep.init_state(None, tc, s, lambda g: _model(tc, jp),
                          device="cpu")
    step = tstep.make_train_step(tc, s)
    ms = []
    for _ in range(steps):
        st, m = step(st, nb)
        ms.append(m)
    return st, ms


def test_train_step_matches_jax():
    """One full step (loss, clipping, streamed AdamW with weight decay) on
    the same params and batch: loss and metrics as the gradients' bound,
    the params within lr-sized moves (a first AdamW step is about
    lr·sign(g), so a near-zero gradient whose sign differs moves by
    2·lr)."""
    jc, tc, jp = _params("llama3-8b")
    nb = _batch(jc, b=4)
    lr = 1e-3
    s = dict(warmup_steps=0, learning_rate=lr)
    jst = jstep.init_state(jax.random.PRNGKey(0), jc, jstep.TrainSettings(**s),
                           init_fn=lambda k: jax.tree.map(jnp.asarray, jp))
    jnew, jm = jax.jit(jstep.make_train_step(jc, jstep.TrainSettings(**s)))(
        jst, _j(nb))
    st, (m,) = _run(tc, jp, tstep.TrainSettings(**s), nb)
    assert st.step == int(jnew.step) == 1
    assert set(m) == set(jm)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-3,
                                   err_msg=k)
    assert float(m["step"]) == float(jm["step"]) == 0.0

    def moved(path, got, want):
        assert np.abs(got - want).max() <= 2.0001 * lr, path
    _walk(lm_params_to_jax(st.params, tc),
          jax.tree.map(np.asarray, jnew.params), moved)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_microbatches_4_vs_1(opt):
    """JAX's own check (``test_microbatched_grads_match_full_batch``,
    AdamW with the default warmup, so its first step has lr 0) and the
    same with SGD at lr 1e-2 from step 0, where the parameters move by the
    accumulated gradient itself."""
    jc, tc, jp = _params("qwen3-4b", opt)
    nb = _batch(jc, b=8, s=16)
    kw = {} if opt == "adamw" else dict(warmup_steps=0, learning_rate=1e-2)
    a, (ma,) = _run(tc, jp, tstep.TrainSettings(num_microbatches=1, **kw), nb)
    b, (mb,) = _run(tc, jp, tstep.TrainSettings(num_microbatches=4, **kw), nb)
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ma["grad_norm"]),
                               float(mb["grad_norm"]), rtol=1e-5)
    pa, pb = dict(a.params.named_parameters()), \
        dict(b.params.named_parameters())
    for n in pa:
        np.testing.assert_allclose(pb[n].detach().numpy(),
                                   pa[n].detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    if opt == "sgd":
        start = _unstack_named(jp, list(pa), tc, "cpu")
        assert max(float((pa[n].detach() - start[n]).abs().max())
                   for n in pa) > 1e-4
    # JAX's microbatched metrics agree with the port's
    js = jstep.TrainSettings(num_microbatches=4, **kw)
    jst = jstep.init_state(jax.random.PRNGKey(0), jc, js,
                           init_fn=lambda k: jax.tree.map(jnp.asarray, jp))
    _, jm = jax.jit(jstep.make_train_step(jc, js))(jst, _j(nb))
    np.testing.assert_allclose(float(mb["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(mb["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-2)


def test_cast_params_bf16_within_jax_bound():
    """JAX's ``test_train_step_cast_params_close_to_fp32`` (llama3 reduced,
    2 microbatches, bf16 shadow vs float32, 5e-2) over three steps from
    step 0 at lr 3e-4; the shadow's gradients are bf16, accumulated in
    float32 (and in bf16 with ``accum_dtype``), and the bf16 run's
    gradient norm is JAX's within the same bound."""
    jc, tc, jp = _params("llama3-8b")
    nb = _batch(jc, b=4, s=16)
    base = dict(num_microbatches=2, warmup_steps=0)
    a, ma = _run(tc, jp, tstep.TrainSettings(**base), nb, steps=3)
    runs = [_run(tc, jp, tstep.TrainSettings(cast_params="bfloat16", **kw,
                                             **base), nb, steps=3)
            for kw in ({}, {"accum_dtype": "bfloat16"})]
    pa = dict(a.params.named_parameters())
    for b, mb in runs:
        pb = dict(b.params.named_parameters())
        assert all(p.dtype == torch.float32 for p in pb.values())
        for n in pa:
            np.testing.assert_allclose(pb[n].detach().numpy(),
                                       pa[n].detach().numpy(), atol=5e-2,
                                       rtol=5e-2, err_msg=n)
        np.testing.assert_allclose(float(mb[0]["grad_norm"]),
                                   float(ma[0]["grad_norm"]), rtol=5e-2)
    js = jstep.TrainSettings(cast_params="bfloat16", **base)
    jst = jstep.init_state(jax.random.PRNGKey(0), jc, js,
                           init_fn=lambda k: jax.tree.map(jnp.asarray, jp))
    _, jm = jax.jit(jstep.make_train_step(jc, js))(jst, _j(nb))
    np.testing.assert_allclose(float(runs[0][1][0]["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-2)
    np.testing.assert_allclose(float(runs[0][1][0]["loss"]),
                               float(jm["loss"]), rtol=5e-2)


def test_loss_decreases_over_15_steps():
    """JAX's ``test_loss_decreases_over_steps`` on JAX's own parameters:
    the port's first loss is JAX's, and 15 steps cut it by 20%."""
    jc, tc, jp = _params("qwen3-4b")
    nb = _batch(jc, seed=42, b=8, s=16)
    s = dict(learning_rate=3e-3, warmup_steps=1)
    _, ms = _run(tc, jp, tstep.TrainSettings(**s), nb, steps=15)
    losses = [float(m["loss"]) for m in ms]
    jst = jstep.init_state(jax.random.PRNGKey(0), jc, jstep.TrainSettings(**s),
                           init_fn=lambda k: jax.tree.map(jnp.asarray, jp))
    _, jm = jax.jit(jstep.make_train_step(jc, jstep.TrainSettings(**s)))(
        jst, _j(nb))
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-3)
    assert losses[-1] < losses[0] * 0.8
    assert all(np.isfinite(losses))


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each layer (and each whisper encoder layer)
    in the backward: the gradients are those without it, bit for bit."""
    for arch in ("qwen3-4b", "whisper-small"):
        jc, tc, jp = _params(arch)
        assert tc.remat
        nb = _t(_batch(jc))
        grads = []
        for cfg in (tc, dataclasses.replace(tc, remat=False)):
            model = _model(cfg, jp)
            tstep.make_loss_fn(cfg, tstep.TrainSettings())(model, nb)[0] \
                .backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        for n, g in grads[0].items():
            assert torch.equal(g, grads[1][n]), n


def test_init_state_layout_and_default_device():
    jc, tc, jp = _params("nemotron-4-340b")
    s = tstep.TrainSettings(grad_compression="int8_ef")
    st = tstep.init_state(torch.Generator().manual_seed(0), tc, s,
                          device="cpu")
    assert st.step == 0 and st.opt_state.step == 0
    assert isinstance(st.opt_state, topt.AdafactorState)
    assert set(st.comp_err) == {n for n, _ in st.params.named_parameters()}
    jst = jstep.init_state(jax.random.PRNGKey(0), jc,
                           jstep.TrainSettings(grad_compression="int8_ef"))
    got = train_state_to_jax(st, tc)

    def same_shape(path, a, b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    _walk(got, jax.tree.map(np.asarray, jst), same_shape)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstep.init_state(None, tc, s)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def test_straggler_detector_flags_slow_step():
    det = tloop.StragglerDetector(warmup=3, k_sigma=2.0)
    flagged = [det.observe(i, dt) for i, dt in
               enumerate([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 5.0, 1.0])]
    assert flagged[6] is True and sum(flagged) == 1


@pytest.mark.parametrize("seed,kw", [(0, dict(warmup=5, k_sigma=4.0)),
                                     (1, {}), (2, dict(alpha=0.3)),
                                     (3, dict(warmup=1, k_sigma=1.0))])
def test_straggler_detector_matches_jax(seed, kw):
    rng = np.random.default_rng(seed)
    dts = 1.0 + 0.05 * rng.standard_normal(100)
    dts[rng.integers(10, 100, 4)] *= 4.0
    t, j = tloop.StragglerDetector(**kw), jloop.StragglerDetector(**kw)
    assert [t.observe(i, d) for i, d in enumerate(dts)] == \
        [j.observe(i, d) for i, d in enumerate(dts)]
    assert t.flagged == j.flagged
    if seed == 0:
        assert len(t.flagged) <= 6


def test_loop_history_and_injected_failure():
    jc, tc, jp = _params("qwen3-4b")
    s = tstep.TrainSettings(learning_rate=1e-3)
    st = tstep.init_state(None, tc, s, lambda g: _model(tc, jp),
                          device="cpu")
    seen = []
    loop = tloop.TrainLoop(tstep.make_train_step(tc, s), st,
                           metrics_hook=seen.append)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        loop.run(iter([_batch(jc, seed=i) for i in range(5)]), 5,
                 fail_at_step=2)
    assert [r["step"] for r in loop.history] == [1, 2] and seen == \
        loop.history
    assert set(loop.history[0]) == {"ce", "acc", "lb_loss", "router_z",
                                    "loss", "grad_norm", "step", "wall_s",
                                    "straggler"}
    assert loop.state.step == 2
