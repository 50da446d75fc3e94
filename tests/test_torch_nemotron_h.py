"""The port's Nemotron-H (``nemotron-3-nano-30b-a3b``, which the JAX package
does not have) against the benchmark's plain reference
(``perfbench/reference/nemotron_h.py``), on the CPU at a reduced size:
the three kinds of block (7 layers, ``MEMEM*E``), 8 experts routed over
with 4 held, Mamba-2 in 2 groups, float32.

Tolerances, stated with their reasons:

* With the attention products' bf16 operand rounding turned off (the
  program rounds them on purpose, as the JAX package does; the reference
  is float32 throughout), both sides are float32 and sum in other
  orders: the loss to 1e-5 relative, every gradient leaf to 1e-4 of its
  own largest value, logits to 1e-4 of their scale.  A step of float8
  products moves the loss by about 1e-2 (the benchmark's control).
* With the rounding on, the loss to 1e-3 relative: the bf16 operands of
  the two attention products alone move it (by 2.5e-5 at this seed).
* Routing, the expert shares and the counters: exact.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.entries import _lm  # noqa: E402
from perfbench.reference import nemotron_h as ref  # noqa: E402
from repro_torch.configs import PORT_ONLY, get_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.models import attention, ffn, mamba  # noqa: E402
from repro_torch.models.transformer import lm_apply  # noqa: E402
from repro_torch.train.step import TrainSettings, make_loss_fn  # noqa: E402

ARCH = "nemotron-3-nano-30b-a3b"
ROOT = Path(__file__).resolve().parents[1]
# the reference's keys at the reduced size; the program's through
# ``program``, as the benchmark hands a configuration to the port
SMALL = {"hidden_size": 64, "num_hidden_layers": 7, "mamba_num_heads": 8,
         "mamba_head_dim": 16, "n_groups": 2, "ssm_state_size": 16,
         "chunk_size": 8, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "experts_routed_over": 8, "n_routed_experts": 4,
         "expert_offset": 0, "num_experts_per_tok": 2,
         "moe_intermediate_size": 32,
         "moe_shared_expert_intermediate_size": 48, "vocab_size": 256,
         "A_init_range": [1, 8],
         "program": {"num_layers": 7, "d_model": 64, "ssm_num_heads": 8,
                     "ssm_head_dim": 16, "ssm_groups": 2, "ssm_state": 16,
                     "ssm_chunk": 8, "num_heads": 4, "num_kv_heads": 2,
                     "head_dim": 16, "padded_num_heads": 4,
                     "moe_num_experts": 8, "moe_experts_held": 4,
                     "moe_top_k": 2, "d_ff": 32, "moe_shared_ff": 48,
                     "vocab_size": 256, "compute_dtype": "float32"}}
B, S, N_DEC = 2, 24, 3


def _cfg(**kw):
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{ARCH}.json").read_text())
    cfg = dict(cfg, **SMALL)
    cfg["program"] = dict(SMALL["program"], **kw.pop("program", {}))
    return _lm.as_run(dict(cfg, **kw))


def _setup(seed=3, **kw):
    """The reference's config, the program's ``ArchConfig``, the weights
    (name -> float32 tensor) and the program's model holding copies."""
    cfg = _cfg(**kw)
    arch = _lm.program_config(cfg)
    weights = _lm.make_weights(cfg, seed, "cpu")
    model = _lm.program_model(arch, {n: t.clone() for n, t in
                                     weights.items()})
    return cfg, arch, weights, model


def _tokens(seed=0, s=S + 1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, 256, (B, s), generator=g)


@pytest.fixture
def float32_attention(monkeypatch):
    monkeypatch.setattr(attention, "_bf16", lambda x: x)


def _close(got, want, rel, what=""):
    scale = float(want.abs().max())
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= rel * max(scale, 1e-12), (what, err, scale)


@pytest.mark.parametrize("rounded", [False, True])
def test_loss_and_gradients_match_the_reference(rounded, monkeypatch):
    if not rounded:
        monkeypatch.setattr(attention, "_bf16", lambda x: x)
    cfg, arch, weights, model = _setup()
    toks = _tokens()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = make_loss_fn(arch, TrainSettings())(model, batch)
    loss.backward()
    params = {n: t.clone().requires_grad_(True) for n, t in weights.items()}
    want = ref._loss(params, toks[:, :-1], toks[:, 1:], ref._widths(cfg),
                     torch.matmul, True)
    want.backward()
    assert abs(loss.item() / want.item() - 1) <= (1e-3 if rounded else 1e-5)
    if rounded:
        return
    got = dict(model.named_parameters())
    assert set(got) == set(params)
    for n, p in params.items():
        _close(got[n].grad, p.grad, 1e-4, n)


@pytest.mark.parametrize("rows", [1, 2])
def test_reference_rows_keep_the_batch_load_balance(rows):
    # the load-balance loss is over the whole batch, as the program's one
    # microbatch takes it; the reference's rows run apart get the batch's
    # first-choice shares, so any ``rows`` is the same step (float64:
    # equal to summation order)
    cfg = _cfg()
    toks = [torch.randint(1, 256, (4, 13), generator=torch.Generator()
                          .manual_seed(k)) for k in range(2)]
    out = {}
    for r in (4, rows):
        w = {n: t.double() for n, t in
             _lm.make_weights(cfg, 5, "cpu").items()}
        out[r] = ref.train_steps(w, toks, cfg, rows=r)
    a, b = out[4], out[rows]
    for key in ("loss", "grad_norm"):
        assert a[key] == pytest.approx(b[key], rel=1e-12)
    for key in ("first_grad", "change"):
        for n in a[key]:
            assert a[key][n] == pytest.approx(b[key][n], rel=1e-10,
                                              abs=1e-300), (key, n)


def test_prefill_then_decode_matches_the_reference_forward(
        float32_attention):
    cfg, arch, weights, model = _setup()
    toks = _tokens(1, S)
    want = ref.logits(weights, toks, cfg)
    from repro_torch.serve.engine import pad_cache_to
    with torch.no_grad():
        full, _, _ = lm_apply(model, {"tokens": toks}, arch, mode="train")
        pre, cache, _ = lm_apply(model, {"tokens": toks[:, :-N_DEC]}, arch,
                                 mode="prefill")
        cache = pad_cache_to(cache, S + 1)
        dec = []
        for i in range(N_DEC):
            cur = torch.full((B,), S - N_DEC + i, dtype=torch.int32)
            lg, cache, _ = lm_apply(
                model, {"tokens": toks[:, S - N_DEC + i][:, None]}, arch,
                mode="decode", cache=cache, cur_len=cur)
            dec.append(lg[:, 0])
    _close(full, want, 1e-4, "train")
    _close(pre, want[:, :-N_DEC], 1e-4, "prefill")
    for i, lg in enumerate(dec):
        _close(lg, want[:, S - N_DEC + i], 1e-4, f"decode {i}")


def test_correction_bias_chooses_and_the_score_weighs():
    _, arch, _, model = _setup()
    moe = model.layers[1].moe
    x = torch.randn(40, arch.d_model, generator=torch.Generator()
                    .manual_seed(5))
    bias = torch.zeros(arch.moe_num_experts)
    bias[[6, 7]] = 10.0          # experts 6 and 7 win every choice
    moe.score_bias.copy_(bias)
    logits, scores, top_e, w = ffn._sigmoid_route(x, moe, arch)
    assert sorted(set(top_e.flatten().tolist())) == [6, 7]
    s = torch.sigmoid(x @ moe.router.detach())
    assert torch.allclose(scores, s, atol=1e-6)
    picked = s[:, [6, 7]]
    want = picked / picked.sum(-1, keepdim=True) * arch.moe_routed_scale
    got = torch.where(top_e == 6, w, 0).sum(-1), torch.where(
        top_e == 7, w, 0).sum(-1)
    assert torch.allclose(torch.stack(got, -1), want, atol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((40,), 2.5), atol=1e-5)


def test_expert_shares_add_up_to_the_uncut_layer():
    # the uncut layer holds all 8 experts; two chips hold 0-3 and 4-7
    cfg, arch, weights, model = _setup(
        n_routed_experts=8, program={"moe_experts_held": 8})
    x = torch.randn(2, 12, arch.d_model, generator=torch.Generator()
                    .manual_seed(7))
    whole = model.layers[1].moe
    with torch.no_grad():
        uncut, _ = ffn.moe_apply(whole, x, arch)
        shared = ffn.ffn_apply(whole.shared, x, arch)
        parts = []
        for e0 in (0, 4):
            share = dataclasses.replace(arch, moe_experts_held=4,
                                        moe_expert_offset=e0)
            m = ffn.MoE(share, generator=None)
            m.load_state_dict({
                "router": whole.router, "w1": whole.w1[e0:e0 + 4],
                "w2": whole.w2[e0:e0 + 4], "shared.w1": whole.shared.w1,
                "shared.w2": whole.shared.w2}, strict=True)
            parts.append(ffn.moe_apply(m, x, share)[0])
        p = {k[len("layers.1."):]: v for k, v in weights.items()
             if k.startswith("layers.1.")}
        w = ref._widths(cfg)
        want = ref._moe(x, p, w, torch.matmul)[0] - x   # the layer alone
    u = model.layers[1].ln2(x)
    with torch.no_grad():
        at_norm, _ = ffn.moe_apply(whole, u, arch)
    _close(at_norm, want, 1e-5, "uncut vs reference")
    _close(parts[0] + parts[1] - shared, uncut, 1e-5, "shares")


def test_param_count_is_the_reference_leaves():
    for kw in ({}, {"program": {"moe_experts_held": 8}, "n_routed_experts": 8}):
        cfg = _cfg(**kw)
        assert _lm.program_config(cfg).param_count() == sum(
            math.prod(s) for _, s, _ in ref.leaves(cfg))
    cell = _lm.as_run(json.loads(
        (ROOT / "perfbench" / "configs" / f"{ARCH}.json").read_text()))
    assert _lm.program_config(cell).param_count() == sum(
        math.prod(s) for _, s, _ in ref.leaves(cell)) == 2_492_957_184
    # the published model: 31.6B parameters
    assert get_config(ARCH).param_count() == 31_577_796_032


@pytest.mark.parametrize("remat", [True, False])
def test_moe_spans_and_counters(remat):
    _, arch, _, model = _setup()
    arch = dataclasses.replace(arch, remat=remat)
    toks = _tokens(2)
    with spans.recording() as rec:
        logits, _, _ = lm_apply(model, {"tokens": toks[:, :-1]}, arch,
                                mode="train")
        logits.sum().backward()
    calls = 3 * (2 if remat else 1)      # 3 E blocks; remat runs them again
    for name in ("moe.route", "moe.dispatch", "moe.count_read",
                 "moe.experts", "moe.combine"):
        assert rec.totals[name][1] == calls
    # the blocking read lies inside the dispatch
    at = {n: [iv for iv in rec.intervals if iv[0] == n]
          for n in ("moe.dispatch", "moe.count_read")}
    for (_, d0, d1), (_, r0, r1) in zip(*at.values()):
        assert d0 <= r0 <= r1 <= d1
    c = rec.counters
    assert c["moe.host_syncs"] == calls and c["moe.dropped"] == 0
    # the rows of held experts, by the layers' own routing
    rows = rows_max = 0
    with torch.no_grad():
        x = model.embed[toks[:, :-1]]
        for layer in model.layers:
            if layer.spec.kind is None:
                u = layer.ln2(x).reshape(-1, arch.d_model)
                top = ffn._sigmoid_route(u, layer.moe, arch)[2]
                per = torch.bincount(top.flatten(), minlength=8)[:4]
                rows, rows_max = rows + int(per.sum()), rows_max + int(
                    per.max())
            x = layer(x, cfg=arch, mode="train", positions=torch.arange(
                S)[None].expand(B, S), cache=None, cur_len=None,
                enc_out=None)[0]
    assert c["moe.rows"] == rows * calls // 3
    assert c["moe.rows_max"] == rows_max * calls // 3


def test_grouped_ssd_runs_each_group_on_its_heads():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 20, 8, 4, generator=g)
    a = -torch.rand(2, 20, 8, generator=g)
    b, c = torch.randn(2, 20, 2 * 5, generator=g), torch.randn(
        2, 20, 2 * 5, generator=g)
    h0 = torch.randn(2, 8, 4, 5, generator=g)
    y, h = mamba.ssd_grouped(x, a, b, c, 8, 2, h0)
    for grp in range(2):
        hs, ns = slice(4 * grp, 4 * grp + 4), slice(5 * grp, 5 * grp + 5)
        yg, hg = mamba.ssd_chunked(x[:, :, hs], a[:, :, hs], b[..., ns],
                                   c[..., ns], 8, h0[:, hs])
        assert torch.allclose(y[:, :, hs], yg, atol=1e-6)
        assert torch.allclose(h[:, hs], hg, atol=1e-6)
    one = mamba.ssd_grouped(x, a, b[..., :5], c[..., :5], 8, 1, h0[..., :5])
    two = mamba.ssd_chunked(x, a, b[..., :5], c[..., :5], 8, h0[..., :5])
    assert all(torch.equal(p, q) for p, q in zip(one, two))


def test_chunk_remat_keeps_the_attention():
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 32, 4, 8, generator=g, requires_grad=True)
               for _ in range(3))
    pos = torch.arange(32)[None].expand(2, 32)
    outs = []
    for remat in (False, True):
        o = attention._chunked_scores_attend(
            q, k, v, q_positions=pos, causal=True, window=None, cap=None,
            kv_valid_len=None, q_chunk=8, chunk_remat=remat)
        grads = torch.autograd.grad((o * o).sum(), (q, k, v))
        outs.append((o, *grads))
    for a, b in zip(*outs):
        assert torch.allclose(a, b, atol=1e-6)


def test_place_refuses_the_pieces_it_has_no_rule_for():
    from repro_torch.distributed.partition import place, unplaced_pieces
    from repro_torch.train.step import init_state
    _, arch, _, model = _setup()
    state = init_state(None, arch, TrainSettings(), init_fn=lambda _: model,
                       device="cpu")
    for tree in (model, state):
        with pytest.raises(NotImplementedError,
                           match="moe_router='sigmoid'.*shared expert"):
            place(tree, {}, None)
    assert unplaced_pieces(get_config("jamba-v0.1-52b")) == []


def test_dry_run_leaves_out_what_place_refuses():
    from repro_torch.configs import list_archs
    from repro_torch.distributed.partition import unplaced_pieces
    from repro_torch.launch.dryrun import dryrun_archs
    assert ARCH in PORT_ONLY and ARCH in list_archs()
    assert unplaced_pieces(get_config(ARCH))
    assert ARCH not in dryrun_archs()
    # today that is the port-only architectures, decided by the config
    assert set(dryrun_archs()) == set(list_archs()) - set(PORT_ONLY) \
        - {"snn-mnist"}
