"""Feed-forward blocks: gated/ungated dense MLP and capacity-based MoE.

Port of ``repro.models.ffn``.  Dense: silu/gelu configs use the gated
(w1·act ⊙ w3)·w2 form (llama/qwen/gemma); squared-relu (nemotron) and relu
use the 2-matrix form.

MoE (dbrx 16e top-4, arctic 128e top-2 + dense residual, jamba 16e top-2):
token-choice top-k routing with per-group expert capacity, realised as the
dispatch/combine products (Switch/GLaM style): tokens are viewed as
(G groups × Sg tokens), dispatch (G,Sg,E,C) routes tokens into per-expert
capacity slots, experts run dense products on their (G,C) slots, and
combine brings the results back weighted by the router's probabilities.
Overflow tokens beyond capacity are dropped (the residual stream carries
them).  The group is ``min(moe_group, S)`` tokens, so decode routes groups
of one token and prefill groups of up to ``moe_group``: capacity drops can
differ between the two, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (is_placed, logical_placements,
                                    model_sharded, partial_over_model,
                                    run_local, shard)
from .layers import activation_fn, dense_init

__all__ = ["ffn_params", "ffn_apply", "moe_params", "moe_apply", "is_gated",
           "MLP", "MoE"]


def is_gated(activation: str) -> bool:
    return activation in ("silu", "gelu")


class MLP(nn.Module):
    """w1 (D, F), w2 (F, D), and w3 (D, F) when the activation is gated."""

    def __init__(self, cfg, d_ff: int | None = None, *,
                 generator: torch.Generator | None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        g = generator
        self.w1 = nn.Parameter(dense_init((d, f), generator=g))
        self.w2 = nn.Parameter(dense_init((f, d), generator=g))
        self.w3 = nn.Parameter(dense_init((d, f), generator=g)) \
            if is_gated(cfg.activation) else None


def ffn_params(cfg, d_ff: int | None = None, *,
               generator: torch.Generator | None) -> MLP:
    return MLP(cfg, d_ff, generator=generator)


def ffn_apply(params: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    """The dense MLP.  On a placed ``x`` it runs on local shards, as
    Megatron's column/row-parallel pair: w1/w3 columns and w2 rows on the
    model axis (the output a partial sum), every weight gathered over the
    data axis right before use."""
    if is_placed(x):
        return _placed_ffn(params, x, cfg)
    dt = x.dtype
    act = activation_fn(cfg.activation)
    h = act(x @ params.w1.to(dt))
    if params.w3 is not None:
        h = h * (x @ params.w3.to(dt))
    h = shard(h, "batch", None, "mlp")
    return h @ params.w2.to(dt)


def _placed_ffn(params: MLP, x, cfg):
    mesh = x.device_mesh
    lp = lambda t, *ax: logical_placements(mesh, t.shape, *ax)  # noqa: E731
    x_pl = lp(x, "batch", None, "embed")
    w1_pl, w2_pl = lp(params.w1, None, "mlp"), lp(params.w2, "mlp", None)
    gated = params.w3 is not None

    def body(xl, w1, w2, w3):
        dt = xl.dtype
        h = activation_fn(cfg.activation)(xl @ w1.to(dt))
        if w3 is not None:
            h = h * (xl @ w3.to(dt))
        return h @ w2.to(dt)

    return run_local(body, mesh, [(x, x_pl), (params.w1, w1_pl),
                                  (params.w2, w2_pl),
                                  (params.w3, w1_pl if gated else None)],
                     partial_over_model(x_pl, mesh, model_sharded(w2_pl, mesh)))


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """router (D, E); w1 / w3 (E, D, F); w2 (E, F, D)."""

    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
        g = generator
        self.router = nn.Parameter(dense_init((d, e), generator=g))
        self.w1 = nn.Parameter(dense_init((e, d, f), in_axis=1, generator=g))
        self.w2 = nn.Parameter(dense_init((e, f, d), in_axis=1, generator=g))
        self.w3 = nn.Parameter(dense_init((e, d, f), in_axis=1,
                                          generator=g)) \
            if is_gated(cfg.activation) else None


def moe_params(cfg, *, generator: torch.Generator | None) -> MoE:
    return MoE(cfg, generator=generator)


def _capacity(sg: int, top_k: int, num_experts: int, factor: float) -> int:
    c = int(sg * top_k * factor / num_experts) + 1
    return max(4, (c + 3) // 4 * 4)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index.
    ``torch.topk`` promises no order among ties; a stable descending sort
    keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: MoE, x: torch.Tensor, cfg, *, group_size: int = 1024):
    """x: (B, S, D) -> (B, S, D), plus aux losses dict.

    Returns (y, aux) where aux = {"lb_loss": load-balance loss (Switch),
    "router_z": router z-loss} — added to the training objective.
    """
    if is_placed(x):
        raise NotImplementedError(
            "MoE expert parallelism is not placed over a mesh yet")
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    tokens = b * s
    sg = min(group_size, s)
    if tokens % sg:
        raise ValueError(f"{tokens} tokens do not split into groups of {sg}")
    g = tokens // sg
    c = _capacity(sg, k, e, cfg.moe_capacity_factor)

    xg = shard(x.reshape(g, sg, d), "batch", None, None)

    logits = xg.to(torch.float32) @ params.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (G,Sg,E)

    # top-k choice per token
    top_p, top_e = _top_k(probs, k)                             # (G,Sg,k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)      # renormalise

    # position of each (token, choice) in its expert's capacity buffer:
    # rank among all choices of the same expert within the group, in
    # (token-major, choice-minor) priority order.
    choice_eh = F.one_hot(top_e, e).to(torch.int32)             # (G,Sg,k,E)
    flat = choice_eh.reshape(g, sg * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat            # (G,Sg*k,E)
    pos = torch.sum(flat * pos_in_expert, dim=-1).reshape(g, sg, k)
    keep = pos < c                                              # capacity drop

    # dispatch/combine tensors (G,Sg,E,C); a dropped choice's one-hot row
    # is all zeros (jax.nn.one_hot of an index past C)
    pos_oh = F.one_hot(torch.where(keep, pos, 0).long(), c).to(dt)
    disp_k = choice_eh.to(dt)[..., None] * pos_oh[..., None, :] \
        * keep[..., None, None].to(dt)                          # (G,Sg,k,E,C)
    dispatch = torch.sum(disp_k, dim=2)                         # (G,Sg,E,C)
    combine = torch.sum(disp_k * top_p[..., None, None].to(dt), dim=2)

    dispatch = shard(dispatch, "batch", None, "experts", None)
    combine = shard(combine, "batch", None, "experts", None)

    ein = torch.einsum("gsec,gsd->egcd", dispatch, xg)          # (E,G,C,D)
    ein = shard(ein, "experts", "batch", None, None)

    act = activation_fn(cfg.activation)
    h = act(torch.einsum("egcd,edf->egcf", ein, params.w1.to(dt)))
    if params.w3 is not None:
        h = h * torch.einsum("egcd,edf->egcf", ein, params.w3.to(dt))
    h = shard(h, "experts", "batch", None, None)
    out_e = torch.einsum("egcf,efd->egcd", h, params.w2.to(dt))
    out_e = shard(out_e, "experts", "batch", None, None)

    y = torch.einsum("gsec,egcd->gsd", combine, out_e)          # back to tokens
    y = y.reshape(b, s, d)

    # Switch-style load-balance loss + router z-loss
    me = torch.mean(probs, dim=(0, 1))                          # (E,)
    ce = torch.mean(torch.sum(F.one_hot(top_e[..., 0], e).to(torch.float32),
                              dim=-2) / sg, dim=0)              # fraction routed
    lb = e * torch.sum(me * ce)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"lb_loss": lb, "router_z": zl}
