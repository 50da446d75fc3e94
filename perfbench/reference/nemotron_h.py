"""The plain reference of a Nemotron-H language model's training step
(``nemotron_h``: NVIDIA-Nemotron-3-Nano-30B-A3B's blocks).

Written from the model's ``config.json`` and the public ``nemotron_h``
modeling code (transformers' ``modeling_nemotron_h.py``), in plain
PyTorch, float32, TF32 off.  It imports nothing of the program; its
Mamba-2 pieces are ``reference/mamba2.py``'s (the RMSNorm, the causal
conv, the quadratic SSD, the learning-rate schedule).  The layers follow
``hybrid_override_pattern``; each is one pre-norm block with its own
residual, ``x + mixer(RMSNorm(x))``:

    M  z, x', B, C, dt = u·W_z, u·W_x, u·W_B, u·W_C, u·W_dt
       x', B, C = SiLU(causal depthwise conv of each);  B, C in G groups
       dt = softplus(dt + dt_bias);  A = -exp(A_log)            (per head)
       y = SSD(x'·dt, dt·A, B_g, C_g) + D·x'     (head h reads group h·G/H)
       out = GroupRMSNorm(y · SiLU(z)) · W_out    (RMS over each group's
                                                   d_inner/G channels)
    E  s = sigmoid(u·W_router)  over all E experts, in float32
       the top k by s + correction bias (zero);  w = s_top / Σ s_top · 2.5
       out = Σ_{held e chosen} w_e · relu(u·W1_e)²·W2_e + relu(u·S1)²·S2
    *  causal softmax attention, 32 query and 2 key/value heads of 128,
       no position embedding, no bias

then the final RMSNorm, the untied head and the next-token cross-entropy
over the vocabulary, plus the load-balance and router z-losses of every
E layer (weights ``aux_loss``: the port's training defaults), gradients
by autograd, and AdamW with the global-norm clip written from its
formula.  The load-balance loss is ``E · Σ_e mean(p_e) · f_e``, with ``p``
the scores normalised over the E experts and ``f_e`` the share of tokens
whose first choice is ``e``, over the whole batch (a forward without
gradients counts the first choices before the rows' gradient passes,
:func:`_firsts`); the z-loss is the mean squared logsumexp of the
router's logits.

The experts held are ``n_routed_experts`` of the ``experts_routed_over``
the router scores, from ``expert_offset``: each is computed on the rows
routed to it, one expert at a time, with no capacity; what the absent
experts would add is left out, as in the program.  The attention runs a
block of queries at a time against the keys up to the block's end, and
each block, each SSD group and each layer is recomputed in the backward,
so that an 8,192-token row fits.

Departures from the published model, all the program's (the benchmark
lays ``assumed.as_run`` over the published keys): no conv bias
(published ``use_conv_bias``), every RMSNorm's weight stored as ``weight
- 1`` (weight decay pulls it toward 1) with eps 1e-6 (published 1e-5),
x', B and C convolved by three weights and the in-projection split in
five (published: one of each over their concatenation, the same
function).  The residual is float32 here; the program's is its compute
dtype, as published (``residual_in_fp32`` false).  In the fp8 control the
projections, the experts and the head are rounded; the router, the SSD
and the attention's two products stay float32.

:func:`leaves` names every parameter (the program's names) with its shape
and the draw it is made from; the benchmark draws them from the seed and
hands the same tensors to the program and to :func:`train_steps`;
:func:`logits` is the forward alone, for the tests' serving checks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.mamba2 import (MATMULS, _conv, _exact_float32,
                                        _lr, _norm, _rmsnorm, _ssd,
                                        _to_host)

__all__ = ["leaves", "train_steps", "logits"]

# queries of the attention's score matrices built at once
QUERY_BLOCK = 1024
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


def _widths(cfg: dict) -> dict:
    if cfg["use_conv_bias"] or cfg["tie_word_embeddings"]:
        raise ValueError("the reference's conv has no bias and its head is "
                         "untied")
    V = int(cfg["vocab_size"])
    if V % 256:
        raise ValueError("the program pads the vocabulary to a multiple of "
                         "256; the reference takes one already padded")
    H, P = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    L = int(cfg["num_hidden_layers"])
    return {"d": int(cfg["hidden_size"]), "L": L, "V": V,
            "kinds": [KINDS[c] for c in cfg["hybrid_override_pattern"][:L]],
            "H": H, "P": P, "di": H * P, "G": int(cfg["n_groups"]),
            "N": int(cfg["ssm_state_size"]), "W": int(cfg["conv_kernel"]),
            "Hq": int(cfg["num_attention_heads"]),
            "Hkv": int(cfg["num_key_value_heads"]),
            "hd": int(cfg["head_dim"]),
            "E": int(cfg["experts_routed_over"]),
            "held": int(cfg["n_routed_experts"]),
            "e0": int(cfg["expert_offset"]),
            "k": int(cfg["num_experts_per_tok"]),
            "F": int(cfg["moe_intermediate_size"]),
            "Fs": int(cfg["moe_shared_expert_intermediate_size"]),
            "scale": float(cfg["routed_scaling_factor"]),
            "eps": float(cfg["norm_eps"]),
            "lb": float(cfg["aux_loss"]["lb_coef"]),
            "zl": float(cfg["aux_loss"]["zl_coef"])}


def leaves(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, draw)`` of every parameter, in the program's names.
    ``draw`` is ``("normal", std)``, ``("const", value)`` or ``("uniform",
    lo, hi, transform)``: matrices normal with std 1/√fan-in (the Mamba
    output projection also 1/√num_hidden_layers, as the published init
    rescales it), the embedding std 0.02; A = U(A_init_range) stored as
    its log (published: 1, 2, …, H by head); dt = exp(U(log time_step_min, log
    time_step_max)) floored at time_step_floor and stored as its inverse
    softplus; D ones; every norm weight 1 (stored as 0).  An M or *
    block's norm is ``ln1``, an E block's ``ln2``."""
    w = _widths(cfg)
    d, di, H, W = w["d"], w["di"], w["H"], w["W"]
    GN = w["G"] * w["N"]
    hq, hkv, hd = w["Hq"], w["Hkv"], w["hd"]
    held, F_, Fs = w["held"], w["F"], w["Fs"]
    A = [float(a) for a in cfg["A_init_range"]]
    dt = ("uniform", math.log(cfg["time_step_min"]),
          math.log(cfg["time_step_max"]), "dt_bias")
    out = [("embed", (w["V"], d), ("normal", 0.02)),
           ("lm_head", (d, w["V"]), ("normal", d ** -0.5))]
    for i, kind in enumerate(w["kinds"]):
        p = f"layers.{i}."
        if kind == "mamba":
            out += [
                (p + "ln1.scale", (d,), ("const", 0.0)),
                (p + "mamba.wz", (d, di), ("normal", d ** -0.5)),
                (p + "mamba.wx", (d, di), ("normal", d ** -0.5)),
                (p + "mamba.wb", (d, GN), ("normal", d ** -0.5)),
                (p + "mamba.wc", (d, GN), ("normal", d ** -0.5)),
                (p + "mamba.wdt", (d, H), ("normal", d ** -0.5)),
                (p + "mamba.conv_x", (W, di), ("normal", W ** -0.5)),
                (p + "mamba.conv_b", (W, GN), ("normal", W ** -0.5)),
                (p + "mamba.conv_c", (W, GN), ("normal", W ** -0.5)),
                (p + "mamba.A_log", (H,), ("uniform", *A, "log")),
                (p + "mamba.D", (H,), ("const", 1.0)),
                (p + "mamba.dt_bias", (H,), dt),
                (p + "mamba.norm", (di,), ("const", 0.0)),
                (p + "mamba.out", (di, d),
                 ("normal", (di * w["L"]) ** -0.5)),
            ]
        elif kind == "attn":
            out += [
                (p + "ln1.scale", (d,), ("const", 0.0)),
                (p + "attn.wq", (d, hq, hd), ("normal", d ** -0.5)),
                (p + "attn.wk", (d, hkv, hd), ("normal", d ** -0.5)),
                (p + "attn.wv", (d, hkv, hd), ("normal", d ** -0.5)),
                (p + "attn.wo", (hq, hd, d), ("normal", (hq * hd) ** -0.5)),
            ]
        else:
            out += [
                (p + "ln2.scale", (d,), ("const", 0.0)),
                (p + "moe.router", (d, w["E"]), ("normal", d ** -0.5)),
                (p + "moe.w1", (held, d, F_), ("normal", d ** -0.5)),
                (p + "moe.w2", (held, F_, d), ("normal", F_ ** -0.5)),
                (p + "moe.shared.w1", (d, Fs), ("normal", d ** -0.5)),
                (p + "moe.shared.w2", (Fs, d), ("normal", Fs ** -0.5)),
            ]
    out.append(("final_norm.scale", (d,), ("const", 0.0)))
    return out


def _mamba(x, p: dict, w: dict, mm, d_skip: bool):
    R, S, _ = x.shape
    H, G, N = w["H"], w["G"], w["N"]
    hg = H // G
    u = _rmsnorm(x, p["ln1.scale"], w["eps"])
    z, xs = mm(u, p["mamba.wz"]), mm(u, p["mamba.wx"])
    b, c = mm(u, p["mamba.wb"]), mm(u, p["mamba.wc"])
    dt = F.softplus(mm(u, p["mamba.wdt"]) + p["mamba.dt_bias"])
    xs = _conv(xs, p["mamba.conv_x"]).reshape(R, S, H, w["P"])
    b, c = _conv(b, p["mamba.conv_b"]), _conv(c, p["mamba.conv_c"])
    xdt = xs * dt[..., None]
    a = dt * -torch.exp(p["mamba.A_log"])
    y = torch.cat([checkpoint(_ssd, xdt[:, :, g * hg:(g + 1) * hg],
                              a[:, :, g * hg:(g + 1) * hg],
                              b[..., g * N:(g + 1) * N],
                              c[..., g * N:(g + 1) * N], use_reentrant=False)
                   for g in range(G)], dim=2)
    if d_skip:
        y = y + p["mamba.D"][:, None] * xs
    y = (y.reshape(R, S, w["di"]) * F.silu(z)).reshape(R, S, G, -1)
    y = _rmsnorm(y, p["mamba.norm"].reshape(G, -1), w["eps"])
    return x + mm(y.reshape(R, S, w["di"]), p["mamba.out"])


def _attend(q, k, v, t0: int):
    """Causal softmax attention of the queries from position ``t0`` (R,
    T, Hq, hd) against the keys up to their last, k and v (R, t0 + T,
    Hq, hd)."""
    T, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("rthd,rshd->rhts", q, k) * hd ** -0.5
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, :] <= (t0 + torch.arange(T, device=q.device))[:, None]
    s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("rhts,rshd->rthd", torch.softmax(s, dim=-1), v)


def _attn(x, p: dict, w: dict, mm):
    R, S, d = x.shape
    hq, hkv, hd = w["Hq"], w["Hkv"], w["hd"]
    u = _rmsnorm(x, p["ln1.scale"], w["eps"])
    q = mm(u, p["attn.wq"].reshape(d, -1)).reshape(R, S, hq, hd)
    k = mm(u, p["attn.wk"].reshape(d, -1)).reshape(R, S, hkv, hd)
    v = mm(u, p["attn.wv"].reshape(d, -1)).reshape(R, S, hkv, hd)
    # query head h reads key/value head h // (hq / hkv)
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    o = torch.cat([checkpoint(_attend, q[:, t0:t0 + QUERY_BLOCK],
                              k[:, :t0 + QUERY_BLOCK],
                              v[:, :t0 + QUERY_BLOCK], t0,
                              use_reentrant=False)
                   for t0 in range(0, S, QUERY_BLOCK)], dim=1)
    return x + mm(o.reshape(R, S, hq * hd), p["attn.wo"].reshape(-1, d))


def _route(x, p: dict, w: dict):
    """The E block's normed input (R·S, d), its router's float32 logits
    and sigmoid scores (R·S, E) and the top k by score (R·S, k)."""
    u = _rmsnorm(x, p["ln2.scale"], w["eps"]).reshape(-1, x.shape[-1])
    logits = u @ p["moe.router"]
    scores = torch.sigmoid(logits)
    top = torch.topk(scores, w["k"], dim=-1).indices   # the bias is zero
    return u, logits, scores, top


def _moe(x, p: dict, w: dict, mm, first=None):
    """The E block and its two auxiliary losses; ``first`` (E,), the share
    of tokens whose first choice is each expert, over the whole batch
    where the rows run at once are fewer (its own rows' where None)."""
    R, S, d = x.shape
    E, e0 = w["E"], w["e0"]
    u, logits, scores, top = _route(x, p, w)
    wts = torch.gather(scores, -1, top)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) * w["scale"]
    y = torch.zeros_like(u)
    w1s, w2s = p["moe.w1"].unbind(0), p["moe.w2"].unbind(0)
    for j in range(w["held"]):
        rows, slot = torch.nonzero(top == e0 + j, as_tuple=True)
        if rows.numel():
            h = F.relu(mm(u[rows], w1s[j])) ** 2
            y = y.index_add(0, rows, mm(h, w2s[j]) * wts[rows, slot, None])
    y = y + mm(F.relu(mm(u, p["moe.shared.w1"])) ** 2, p["moe.shared.w2"])
    probs = scores / scores.sum(-1, keepdim=True)
    if first is None:
        first = F.one_hot(top[:, 0], E).to(u.dtype).mean(0)
    lb = E * torch.sum(probs.mean(0) * first)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return x + y.reshape(R, S, d), lb, zl


def _block(x, p: dict, kind: str, w: dict, mm, d_skip: bool, first=None):
    zero = x.new_zeros(())
    if kind == "mamba":
        return _mamba(x, p, w, mm, d_skip), zero, zero
    if kind == "attn":
        return _attn(x, p, w, mm), zero, zero
    return _moe(x, p, w, mm, first)


def _layer_params(params: dict, i: int) -> dict:
    return {k[len(f"layers.{i}."):]: v for k, v in params.items()
            if k.startswith(f"layers.{i}.")}


def _forward(params: dict, tokens, w: dict, mm, d_skip: bool, firsts=None):
    """The logits of rows ``tokens`` (R, S) and the weighted auxiliary
    losses; each block recomputed in the backward.  ``firsts``: each E
    block's first-choice shares over the whole batch (:func:`_firsts`),
    or None for the rows' own."""
    x = params["embed"][tokens]
    aux = 0.0
    for i, kind in enumerate(w["kinds"]):
        first = None if firsts is None else firsts.get(i)
        x, lb, zl = checkpoint(_block, x, _layer_params(params, i), kind, w,
                               mm, d_skip, first, use_reentrant=False)
        aux = aux + w["lb"] * lb + w["zl"] * zl
    x = _rmsnorm(x, params["final_norm.scale"], w["eps"])
    return mm(x, params["lm_head"]), aux


def _firsts(params: dict, tokens, w: dict, mm, d_skip: bool,
            rows: int) -> dict:
    """Each E block's share of the batch's tokens (B, S) whose first
    choice is each expert, by block index: a forward without gradients,
    ``rows`` sequences at a time.  A row's forward is the same whether it
    runs alone or with others, and the shares carry no gradient, so the
    load-balance loss over the batch is the mean over rows of each row's
    ``E · Σ_e mean_row(p_e) · f_e`` with these ``f_e``: exact at any
    ``rows`` (sequences of one length)."""
    counts = {i: 0.0 for i, kind in enumerate(w["kinds"]) if kind == "moe"}
    if not counts:
        return {}
    with torch.no_grad():
        for a in range(0, tokens.shape[0], rows):
            x = params["embed"][tokens[a:a + rows]]
            for i, kind in enumerate(w["kinds"]):
                p = _layer_params(params, i)
                if kind == "moe":
                    top = _route(x, p, w)[3]
                    counts[i] = counts[i] + torch.bincount(
                        top[:, 0], minlength=w["E"]).to(x.dtype)
                if i < max(counts):
                    x = _block(x, p, kind, w, mm, d_skip)[0]
    return {i: c / tokens.numel() for i, c in counts.items()}


def _loss(params: dict, tokens, labels, w: dict, mm, d_skip: bool,
          firsts=None):
    """Mean next-token cross-entropy of rows ``tokens`` (R, S) plus the
    weighted auxiliary losses (``firsts``: as :func:`_forward`)."""
    logits, aux = _forward(params, tokens, w, mm, d_skip, firsts)
    ce = F.cross_entropy(logits.reshape(-1, w["V"]), labels.reshape(-1))
    return ce + aux


def logits(params: dict, tokens, cfg: dict) -> torch.Tensor:
    """The float32 logits (R, S, V) of rows ``tokens``, TF32 off."""
    with _exact_float32(), torch.no_grad():
        return _forward(params, tokens.long(), _widths(cfg),
                        MATMULS["float32"], True)[0]


def train_steps(params: dict, batches: list, cfg: dict, *, rows: int = 1,
                matmul: str = "float32", d_skip: bool = True,
                keep_rows: int | None = None) -> dict:
    """AdamW steps from a zero optimizer state, one a batch (each ``(B,
    S + 1)`` tokens on the device), over ``rows`` sequences at a time with
    the gradients accumulated (the load-balance loss over the whole batch,
    as the program's one microbatch takes it: :func:`_firsts`).  ``params`` (name → float32 tensor) are updated in place.
    ``matmul`` names the products (``reference.mamba2.MATMULS``),
    ``d_skip`` keeps the D skip, ``keep_rows`` takes only the first rows
    of each batch.

    Returns each step's ``loss`` and ``grad_norm`` (the global norm before
    the clip), each leaf's norm of the first step's gradient as the
    optimizer gets it (clipped, ``first_grad``), and of the parameters'
    change over all the steps (``change``)."""
    w, o, mm = _widths(cfg), cfg["optimizer"], MATMULS[matmul]
    b1, b2, eps = float(o["b1"]), float(o["b2"]), float(o["eps"])
    with _exact_float32():
        for t in params.values():
            t.requires_grad_(True)
        start = {n: t.detach().clone() for n, t in params.items()}
        mu = {n: torch.zeros_like(t) for n, t in params.items()}
        nu = {n: torch.zeros_like(t) for n, t in params.items()}
        out = {"loss": [], "grad_norm": []}
        for step, toks in enumerate(batches):
            toks = toks[:keep_rows].long()
            total = torch.zeros((), dtype=torch.float64, device=toks.device)
            firsts = None if rows >= toks.shape[0] else _firsts(
                params, toks[:, :-1], w, mm, d_skip, rows)
            for a in range(0, toks.shape[0], rows):
                blk = toks[a:a + rows]
                loss = _loss(params, blk[:, :-1], blk[:, 1:], w, mm,
                             d_skip, firsts) \
                    * (blk.shape[0] / toks.shape[0])
                loss.backward()
                total += loss.detach()
            with torch.no_grad():
                for t in params.values():      # a leaf the loss never read
                    if t.grad is None:
                        t.grad = torch.zeros_like(t)
                gnorm = math.sqrt(sum(
                    float(torch.sum(t.grad.double() ** 2))
                    for t in params.values()))
                scale = min(1.0, float(o["clip_norm"]) / (gnorm + 1e-9))
                lr, k = _lr(step, o), step + 1
                bc1, bc2 = 1 - b1 ** k, 1 - b2 ** k
                first = {}
                for n, p in params.items():
                    g = p.grad * scale
                    p.grad = None
                    mu[n].mul_(b1).add_(g, alpha=1 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    if step == 0:
                        first[n] = _norm(g)
                    upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps) \
                        + float(o["weight_decay"]) * p
                    p.sub_(lr * upd)
                if step == 0:
                    out["first_grad"] = _to_host(first)
            out["loss"].append(float(total))
            out["grad_norm"].append(gnorm)
        with torch.no_grad():
            out["change"] = _to_host({n: _norm(params[n] - start[n])
                                      for n in start})
        for t in params.values():
            t.requires_grad_(False)
    return out
