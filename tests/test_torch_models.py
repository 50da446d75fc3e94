"""Parity of the port's LM substrate (configs and models) with the JAX
package's, on the CPU, at every arch's ``get_reduced`` size.

No ``jax.random`` stream can be matched, so JAX's ``lm_init`` parameters
cross into the port through ``convert.lm_params_from_jax``; inputs are made
with numpy from a seed.  Tolerances, stated with their reasons:

* configs, ``layer_plan`` / ``block_size``, parameter counts, the registry,
  and the initializers' fixed leaves (ones and zeros): exact.  The Mamba-2
  ``A_log`` / ``dt_bias`` tables: rtol 5e-7 (a few float32 ulps; the port
  rounds a float64 chain once, JAX rounds at each float32 step).
* One layer's primitives on the same float32 inputs (norms, rope,
  activations, attention, MoE, SSD): atol 1e-5 / rtol 1e-5.  Both run in
  float32 and sum in different orders, so a few ulps.
* Whole-model logits, K/V caches and decode steps: ``|Δ| ≤ 1e-2 ·
  max|JAX|``.  The reduced configs compute in float32, but the two
  attention products round their operands to bfloat16 (as the JAX package
  does).  The packages' float32 values differ by an ulp or so, and an
  operand that lies within that of a bf16 rounding boundary rounds to a
  neighbouring bf16 value in one package: a 2^-8 change of one q, k or
  probability element.  Measured, one such flip moves the logits of these
  seeds by up to 2.8e-3 of their scale; 1e-2 allows a few flips.  Without
  the bf16 rounding (or with erf gelu, or with a mask at -inf) the
  unit tests below fail at far tighter bounds.
* The MoE auxes: rtol 1e-3 (router probabilities see the flips above).
* Mamba-only layers have no attention: their logits hold to 1e-4 · scale.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jatt
from repro.models import ffn as jffn
from repro.models import layers as jlay
from repro.models import mamba as jmam
from repro.models import transformer as jtr
from repro_torch import configs as tcfg
from repro_torch.convert import lm_cache_to_jax_layout, lm_params_from_jax
from repro_torch.models import attention as tatt
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tlay
from repro_torch.models import mamba as tmam
from repro_torch.models import transformer as ttr

ARCHS = [a for a in jcfg.list_archs() if a != "snn-mnist"]
B, S, N_DEC = 2, 12, 3
REL = 1e-2       # whole-model bound, relative to max|JAX| (docstring)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach().float().cpu() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |Δ| {err} > {rel} · {scale}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(cfg, seed=0, s=S):
    """numpy inputs from a seed: tokens, and the vlm patches / whisper
    frames the stub frontends provide."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, s // 2)
        out["patches"] = rng.normal(0, 0.5, (B, p, cfg.d_model)) \
            .astype(np.float32)
        out["tokens"] = out["tokens"][:, :s - p]
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 0.5, (B, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _run(arch):
    """JAX and port outputs of one reduced arch on the same params and
    inputs: train, prefill (on all but the last N_DEC tokens) and N_DEC
    teacher-forced decode steps."""
    jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    jp = jtr.lm_init(jax.random.PRNGKey(0), jc)
    model = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    nb = _batch(jc)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    out = {"model": model, "jc": jc, "tc": tc}
    japply = jax.jit(functools.partial(jtr.lm_apply, cfg=jc, mode="train"))
    out["j_train"] = jax.tree.map(np.asarray, japply(jp, jb))
    with torch.no_grad():
        out["t_train"] = ttr.lm_apply(model, tb, tc, mode="train")

        pre = {k: v for k, v in nb.items()}
        pre["tokens"] = nb["tokens"][:, :-N_DEC]
        jpre = jax.jit(functools.partial(jtr.lm_apply, cfg=jc,
                                         mode="prefill"))
        out["j_prefill"] = jl, jcache, jaux = jpre(
            jp, {k: jnp.asarray(v) for k, v in pre.items()})
        out["t_prefill"] = tl, tcache, taux = ttr.lm_apply(
            model, {k: _t(v) for k, v in pre.items()}, tc, mode="prefill")

        from repro.serve.engine import pad_cache_to as jpad
        from repro_torch.serve.engine import pad_cache_to as tpad
        jcache = jpad(jcache, jl.shape[1] + N_DEC + 1)
        tcache = tpad(tcache, tl.shape[1] + N_DEC + 1)
        jdec = jax.jit(functools.partial(jtr.lm_apply, cfg=jc,
                                         mode="decode"))
        out["j_dec"], out["t_dec"] = [], []
        for i in range(N_DEC):
            tok = nb["tokens"][:, -N_DEC + i][:, None]
            cur = np.full((B,), jl.shape[1] + i, np.int32)
            jlog, jcache, _ = jdec(jp, {"tokens": jnp.asarray(tok)},
                                   cache=jcache, cur_len=jnp.asarray(cur))
            tlog, tcache, _ = ttr.lm_apply(
                model, {"tokens": _t(tok)}, tc, mode="decode", cache=tcache,
                cur_len=_t(cur))
            out["j_dec"].append(np.asarray(jlog[:, 0]))
            out["t_dec"].append(tlog[:, 0])
        out["j_dec_cache"], out["t_dec_cache"] = jcache, tcache
    return out


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_registry_matches_jax():
    # the port's registry is JAX's and the architectures only it has
    assert set(tcfg.PORT_ONLY) <= set(tcfg.list_archs())
    assert [a for a in tcfg.list_archs() if a not in tcfg.PORT_ONLY] == \
        jcfg.list_archs()
    assert [c for c in tcfg.shape_cells() if c[0] not in tcfg.PORT_ONLY] \
        == jcfg.shape_cells()
    from repro.configs.registry import LONG_CONTEXT_OK
    assert tcfg.LONG_CONTEXT_OK == LONG_CONTEXT_OK
    for arch, shape in jcfg.shape_cells():
        assert tcfg.cell_is_live(arch, shape) == jcfg.cell_is_live(arch,
                                                                    shape)
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")


def _jax_fields(t):
    """A port config's fields without the port's own, which must hold
    their defaults on every architecture of the JAX package."""
    d = dataclasses.asdict(t)
    defaults = {f.name: f.default for f in dataclasses.fields(t)}
    assert {n: d[n] for n in tcfg.PORT_FIELDS} == \
        {n: defaults[n] for n in tcfg.PORT_FIELDS}, t.name
    return {n: v for n, v in d.items() if n not in tcfg.PORT_FIELDS}


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_configs_match_jax_field_for_field(arch):
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
        names = [f.name for f in dataclasses.fields(t)]
        assert [n for n in names if n not in tcfg.PORT_FIELDS] == \
            [f.name for f in dataclasses.fields(j)]
        assert names[-len(tcfg.PORT_FIELDS):] == list(tcfg.PORT_FIELDS)
        assert _jax_fields(t) == dataclasses.asdict(j), get
        for prop in ("padded_vocab", "d_inner", "ssm_heads", "is_encdec",
                     "param_count", "active_param_count"):
            got, want = getattr(t, prop), getattr(j, prop)
            if callable(want):
                got, want = got(), want()
            assert got == want, (get, prop)
        assert str(t.dtype) == f"torch.{j.dtype}"
    kw = dict(layers=3, d_model=32, vocab=512)
    assert _jax_fields(tcfg.reduced(tcfg.get_config(arch), **kw)) == \
        dataclasses.asdict(jcfg.reduced(jcfg.get_config(arch), **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_and_block_size_match_jax(arch):
    for cfg_j, cfg_t in ((jcfg.get_config(arch), tcfg.get_config(arch)),
                         (jcfg.get_reduced(arch), tcfg.get_reduced(arch))):
        jplan, tplan = jtr.layer_plan(cfg_j), ttr.layer_plan(cfg_t)
        assert [dataclasses.asdict(p) for p in tplan] == \
            [dataclasses.asdict(p) for p in jplan]
        assert ttr.block_size(tplan) == jtr.block_size(jplan)


# --------------------------------------------------------------------------
# parameters: the port's own lm_init against JAX's tree
# --------------------------------------------------------------------------

TRUNC_STD = 0.87962566   # std of a standard normal truncated to [-2, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_has_jax_tree_and_distributions(arch):
    tc = tcfg.get_reduced(arch)
    want = _run(arch)["model"].state_dict()       # JAX's tree, converted
    gen = torch.Generator().manual_seed(0)
    got = ttr.lm_init(tc, generator=gen, device="cpu").state_dict()
    assert list(got) == list(want)
    scaled = {"port": [], "jax": []}
    embeds = {"port": [], "jax": []}
    for name, t in got.items():
        w = want[name]
        assert t.shape == w.shape and t.dtype == w.dtype == torch.float32, \
            name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("A_log", "dt_bias"):
            # float64 rounded once against JAX's float32 chain: a few ulps
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=5e-7,
                                       atol=0, err_msg=name)
        elif leaf in ("D", "scale", "bias", "norm", "q_norm", "k_norm"):
            assert torch.equal(t, w), name      # ones and zeros, exactly
        elif leaf in ("embed", "pos_embed"):
            embeds["port"].append(t.flatten())
            embeds["jax"].append(w.flatten())
        else:
            # fan-in: axis 1 of the experts' (E, in, out), else axis 0
            expert = leaf in ("w1", "w2", "w3") and t.dim() == 3
            fan = t.shape[1 if expert else 0]
            scaled["port"].append((t * fan ** 0.5).flatten())
            scaled["jax"].append((w * fan ** 0.5).flatten())
    for side in ("port", "jax"):
        z = torch.cat(scaled[side])
        n = z.numel()
        assert float(z.abs().max()) <= 2.0 + 1e-5, side
        assert abs(float(z.mean())) < 5 * TRUNC_STD / n ** 0.5, side
        # the std of n samples has a standard error of about std/√(2n)
        assert abs(float(z.std()) - TRUNC_STD) < 5 * TRUNC_STD / (
            2 * n) ** 0.5, side
        e = torch.cat(embeds[side])
        assert abs(float(e.std()) - 0.02) < 5 * 0.02 / (2 * e.numel()) ** 0.5
        assert abs(float(e.mean())) < 5 * 0.02 / e.numel() ** 0.5


def test_lm_init_is_seeded_and_defaults_to_the_card():
    cfg = tcfg.get_reduced("qwen3-4b")
    a = ttr.lm_init(cfg, generator=torch.Generator().manual_seed(3),
                    device="cpu").state_dict()
    b = ttr.lm_init(cfg, generator=torch.Generator().manual_seed(3),
                    device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    if torch.cuda.is_available():
        return                      # the card's default is the chip's test
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.lm_init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_cache(cfg, 2, 8)


# --------------------------------------------------------------------------
# whole model, port against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_train_and_prefill_match_jax(arch):
    r = _run(arch)
    rel = 1e-4 if arch == "mamba2-1.3b" else REL
    jl, _, jaux = r["j_train"]
    tl, tcache, taux = r["t_train"]
    assert tcache is None
    assert tl.shape == (B, S, r["tc"].padded_vocab)
    _close(tl, jl, rel, f"{arch} train logits")
    for mode in ("j_train", "j_prefill"):
        jl, _, jaux = r[mode]
        tl, _, taux = r["t" + mode[1:]]
        _close(tl, jl, rel, f"{arch} {mode} logits")
        for k in ("lb_loss", "router_z"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-3, atol=1e-6,
                                       err_msg=f"{arch} {mode} {k}")
    if r["jc"].moe_num_experts:
        assert float(r["t_train"][2]["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_jax_leaf_for_leaf(arch):
    r = _run(arch)
    jcache = r["j_prefill"][1]
    got = lm_cache_to_jax_layout(r["t_prefill"][1], r["tc"])
    assert sorted(got) == sorted(jcache)
    for j, parts in jcache.items():
        assert sorted(got[j]) == sorted(parts)
        for part, nt in parts.items():
            for f, leaf in nt._asdict().items():
                leaf = np.asarray(leaf)
                t_leaf = got[j][part][f]
                assert t_leaf.shape == leaf.shape, (j, part, f)
                dt = getattr(r["t_prefill"][1][int(j[1:])][part], f).dtype
                assert str(dt) == f"torch.{leaf.dtype}", (j, part, f)
                _close(t_leaf, leaf, REL, f"{arch} {j}.{part}.{f}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_and_the_full_forward(arch):
    r = _run(arch)
    rel = 1e-4 if arch == "mamba2-1.3b" else REL
    full = r["t_train"][0]
    s_pre = r["t_prefill"][0].shape[1]
    for i, (tl, jl) in enumerate(zip(r["t_dec"], r["j_dec"])):
        _close(tl, jl, rel, f"{arch} decode step {i}")
        # decode after prefill reproduces the full forward's logits
        _close(tl, full[:, s_pre + i], rel, f"{arch} decode vs full {i}")
    got = lm_cache_to_jax_layout(r["t_dec_cache"], r["tc"])
    for j, parts in r["j_dec_cache"].items():
        for part, nt in parts.items():
            for f, leaf in nt._asdict().items():
                _close(got[j][part][f], np.asarray(leaf), REL,
                       f"{arch} decoded cache {j}.{part}.{f}")


def test_transformer_module_and_init_cache():
    cfg = tcfg.get_reduced("jamba-v0.1-52b")
    model = _run("jamba-v0.1-52b")["model"]
    assert isinstance(model, torch.nn.Module)
    assert tuple(model.layers[0].mamba.wz.shape) == (cfg.d_model,
                                                     cfg.d_inner)
    attn = [i for i, p in enumerate(ttr.layer_plan(cfg)) if p.kind == "attn"]
    assert tuple(model.layers[attn[0]].attn.wq.shape) == (
        cfg.d_model, cfg.padded_num_heads, cfg.head_dim)
    cache = model.init_cache(3, 10)
    jcache = jtr.init_cache(jcfg.get_reduced("jamba-v0.1-52b"), 3, 10)
    got = lm_cache_to_jax_layout(cache, cfg)
    for j, parts in jcache.items():
        for part, nt in parts.items():
            for f, leaf in nt._asdict().items():
                assert got[j][part][f].shape == leaf.shape
                assert not got[j][part][f].any()
    assert cache[attn[0]]["self"].k.dtype == torch.bfloat16
    assert cache[0]["self"].ssm.dtype == torch.float32
    assert cache[0]["self"].conv_x.dtype == torch.bfloat16
    logits, _, _ = model({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, cfg.padded_vocab)


# --------------------------------------------------------------------------
# the traps, one primitive at a time
# --------------------------------------------------------------------------

def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = tlay.activation_fn("gelu")(_t(x)).numpy()
    want = np.asarray(jlay.activation_fn("gelu")(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4     # torch's default differs
    for name in ("silu", "squared_relu", "relu"):
        np.testing.assert_allclose(
            tlay.activation_fn(name)(_t(x)).numpy(),
            np.asarray(jlay.activation_fn(name)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_norms_rope_softcap_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 5, 3, 16)).astype(np.float32)
    sc = rng.normal(0, 0.3, (16,)).astype(np.float32)
    bi = rng.normal(0, 0.3, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlay.rmsnorm(_t(x), _t(sc)).numpy(),
        np.asarray(jlay.rmsnorm(jnp.asarray(x), jnp.asarray(sc))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlay.layernorm(_t(x), _t(sc), _t(bi)).numpy(),
        np.asarray(jlay.layernorm(jnp.asarray(x), jnp.asarray(sc),
                                  jnp.asarray(bi))), rtol=1e-5, atol=1e-5)
    xb = _t(x).to(torch.bfloat16)
    assert tlay.rmsnorm(xb, _t(sc)).dtype == torch.bfloat16
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) * 977, (2, 5))
    ts, tc_ = tlay.rope(_t(pos), 16, 1e6)
    js, jc_ = jlay.rope(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), atol=1e-5)
    np.testing.assert_allclose(
        tlay.apply_rope(_t(x), ts[:, :, None], tc_[:, :, None]).numpy(),
        np.asarray(jlay.apply_rope(jnp.asarray(x), js[:, :, None],
                                   jc_[:, :, None])), atol=1e-4)
    np.testing.assert_allclose(
        tlay.softcap(_t(x) * 40, 30.0).numpy(),
        np.asarray(jlay.softcap(jnp.asarray(x) * 40, 30.0)),
        rtol=1e-5, atol=1e-5)


def _attend_both(q, k, v, **kw):
    got = tatt._chunked_scores_attend(
        _t(q), _t(k), _t(v),
        **{a: (_t(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()})
    want = jatt._chunked_scores_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()})
    return got.numpy(), np.asarray(want)


def test_attention_products_round_operands_to_bf16_and_sum_in_f32():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1, (2, 7, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    kw = dict(q_positions=pos, causal=True, window=None, cap=None,
              kv_valid_len=None, q_chunk=1024)
    got, want = _attend_both(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # plain float32 operands miss JAX by far more than the bound above
    s = np.einsum("bqhd,bshd->bhqs", q, k) * 0.25
    s = np.where(np.tril(np.ones((7, 7), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    plain = np.einsum("bhqs,bshd->bqhd", p, v)
    assert np.abs(plain - want).max() > 1e-3
    # bf16 products rounded once more to bf16 miss it too
    tb = torch.einsum("bqhd,bshd->bhqs", _t(q).bfloat16(), _t(k).bfloat16())
    jb = np.asarray(jnp.einsum(
        "bqhd,bshd->bhqs", jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray(k).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    assert np.abs(tb.float().numpy() - jb).max() > 1e-3
    tq = torch.einsum("bqhd,bshd->bhqs", tatt._bf16(_t(q)), tatt._bf16(_t(k)))
    np.testing.assert_allclose(tq.numpy(), jb, rtol=1e-6, atol=1e-5)


def test_masks_fill_minus_1e30_window_and_valid_length():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 1, (2, 9, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    # a window, a softcap, valid lengths and chunking (9 = 3 chunks of 3)
    kw = dict(q_positions=pos, causal=True, window=3, cap=5.0,
              kv_valid_len=np.array([9, 4], np.int32), q_chunk=4)
    got, want = _attend_both(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a row with every key masked: -1e30 gives JAX's uniform average,
    # where -inf would give NaN
    kw["kv_valid_len"] = np.array([0, 9], np.int32)
    got, want = _attend_both(q, k, v, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the decode kernel: GQA groups, window, valid length
    qd = rng.normal(0, 1, (2, 1, 4, 8)).astype(np.float32)
    cur = np.array([5, 8], np.int32)
    g = tatt._gqa_decode_attend(_t(qd), _t(k), _t(v), n_rep=2,
                                q_positions=_t(cur[:, None]), window=3,
                                cap=None, kv_valid_len=_t(cur + 1))
    w = jatt._gqa_decode_attend(jnp.asarray(qd), jnp.asarray(k),
                                jnp.asarray(v), n_rep=2,
                                q_positions=jnp.asarray(cur[:, None]),
                                window=3, cap=None,
                                kv_valid_len=jnp.asarray(cur + 1))
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        tatt._repeat_kv(_t(k), 3).numpy(),
        np.asarray(jatt._repeat_kv(jnp.asarray(k), 3)))


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    probs = np.array([[[0.25, 0.25, 0.25, 0.25],
                       [0.1, 0.4, 0.1, 0.4],
                       [0.3, 0.3, 0.2, 0.2]]], np.float32)
    tv, ti = tffn._top_k(_t(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a whole MoE layer with tied router rows and capacity drops
    cfg_j = dataclasses.replace(jcfg.get_reduced("dbrx-132b"),
                                moe_capacity_factor=1.0)
    cfg_t = dataclasses.replace(tcfg.get_reduced("dbrx-132b"),
                                moe_capacity_factor=1.0)
    jp = jffn.moe_params(jax.random.PRNGKey(5), cfg_j)
    jp["router"] = jp["router"].at[:, 3].set(jp["router"][:, 1])
    tp = tffn.moe_params(cfg_t, generator=None)
    with torch.no_grad():
        for name, leaf in jp.items():
            setattr(tp, name, torch.nn.Parameter(_t(leaf)))
    x = np.random.default_rng(6).normal(0, 1, (2, 8, cfg_j.d_model)) \
        .astype(np.float32)
    for group in (8, 1):
        wy, waux = jffn.moe_apply(jp, jnp.asarray(x), cfg_j, group_size=group)
        with torch.no_grad():
            ty, taux = tffn.moe_apply(tp, _t(x), cfg_t, group_size=group)
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy), rtol=1e-5,
                                   atol=1e-5)
        for k in waux:
            np.testing.assert_allclose(float(taux[k]), float(waux[k]),
                                       rtol=1e-5)
    assert tffn._capacity(8, 4, 4, 1.0) == jffn._capacity(8, 4, 4, 1.0) == 12
    assert tffn._capacity(1, 2, 16, 1.25) == jffn._capacity(1, 2, 16, 1.25)


def test_segsum_masks_with_minus_inf():
    a = np.random.default_rng(7).normal(-0.5, 0.3, (2, 3, 6)) \
        .astype(np.float32)
    got = tmam._segsum(_t(a)).numpy()
    want = np.asarray(jmam._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 15
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert (np.exp(got)[~fin] == 0).all()


def test_ssd_chunked_matches_jax_and_a_small_chunk():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 13, 4, 8)).astype(np.float32)
    a = -np.abs(rng.normal(0, 0.5, (2, 13, 4))).astype(np.float32)
    b, c = (rng.normal(0, 1, (2, 13, 16)).astype(np.float32)
            for _ in range(2))
    h0 = rng.normal(0, 1, (2, 4, 8, 16)).astype(np.float32)
    for chunk in (8, 4, 1):
        y, h = tmam.ssd_chunked(_t(x), _t(a), _t(b), _t(c), chunk, _t(h0))
        wy, wh = jmam.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(c), chunk,
                                  jnp.asarray(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-4,
                                   atol=1e-4, err_msg=str(chunk))
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-4,
                                   atol=1e-4, err_msg=str(chunk))
    y8, h8 = tmam.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 8)
    y4, h4 = tmam.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 4)
    np.testing.assert_allclose(y8.numpy(), y4.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h8.numpy(), h4.numpy(), rtol=1e-4, atol=1e-4)


def test_mamba_logits_are_chunk_size_invariant():
    """tests/test_models.py's SSD check, on the port."""
    model = _run("mamba2-1.3b")["model"]
    cfg8 = dataclasses.replace(tcfg.get_reduced("mamba2-1.3b"), ssm_chunk=8)
    cfg4 = dataclasses.replace(cfg8, ssm_chunk=4)
    tb = {"tokens": _t(_batch(cfg8)["tokens"])}
    with torch.no_grad():
        a = ttr.lm_apply(model, tb, cfg8)[0]
        b = ttr.lm_apply(model, tb, cfg4)[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_mamba_decode_step_and_conv_tail_match_jax():
    jc, tc = jcfg.get_reduced("mamba2-1.3b"), tcfg.get_reduced("mamba2-1.3b")
    jp = jmam.mamba_params(jax.random.PRNGKey(9), jc)
    tp = tmam.mamba_params(tc, generator=None)
    with torch.no_grad():
        for name, leaf in jp.items():
            setattr(tp, name, torch.nn.Parameter(_t(leaf)))
    rng = np.random.default_rng(10)
    u = rng.normal(0, 1, (2, 5, jc.d_model)).astype(np.float32)
    jy, jcache = jmam.mamba_apply(jp, jnp.asarray(u), jc, want_cache=True)
    with torch.no_grad():
        ty, tcache = tmam.mamba_apply(tp, _t(u), tc, want_cache=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        un = rng.normal(0, 1, (2, 1, jc.d_model)).astype(np.float32)
        jy, jcache = jmam.mamba_decode_step(jp, jnp.asarray(un), jc, jcache)
        ty, tcache = tmam.mamba_decode_step(tp, _t(un), tc, tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    for f in tmam.MambaCache._fields:
        np.testing.assert_allclose(getattr(tcache, f).numpy(),
                                   np.asarray(getattr(jcache, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    # the conv tail is the last W-1 inputs of the segment
    assert tcache.conv_b.shape == (2, jc.ssm_conv - 1, jc.ssm_state)


def test_whisper_encoder_and_vlm_patches_match_jax():
    r = _run("whisper-small")
    jc, tc, model = r["jc"], r["tc"], r["model"]
    jp = jtr.lm_init(jax.random.PRNGKey(0), jc)
    fr = _batch(jc)["frames"]
    with torch.no_grad():
        got = ttr._encode(model.encoder, _t(fr), tc)
    want = jtr._encode(jp["encoder"], jnp.asarray(fr), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2 * float(np.abs(want).max()))
    # the prefill's cross cache holds the encoder's K/V, never written again
    tcross = r["t_prefill"][1][0]["cross"].k
    assert tcross.shape[1] == jc.encoder_seq
    assert torch.equal(r["t_dec_cache"][0]["cross"].k, tcross)
    # llava: patches come first, then the tokens
    rv = _run("llava-next-34b")
    nb = _batch(rv["jc"])
    assert rv["t_train"][0].shape[1] == nb["patches"].shape[1] + \
        nb["tokens"].shape[1]
