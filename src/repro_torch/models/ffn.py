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

Nemotron-H's MoE (``cfg.moe_router == "sigmoid"``, the port's own) is
dropless and held in part: the router scores every token over all E
experts in float32 with a sigmoid, chooses the top k by score plus a
correction bias (a buffer, zero as published; the aux-loss-free update of
it is a training procedure left out), and weighs each choice by its
unbiased score, renormalised over the k and times ``moe_routed_scale``.
The layer holds ``cfg.experts_held`` experts from ``moe_expert_offset``
and computes only their part: the (token, choice) pairs of held experts
are sorted by expert, gathered by an index, each held expert runs its
product on its own rows, and the results are scatter-added by their
weights; no capacity, nothing dropped.  A shared expert
(``moe_shared_ff``) is added for every token.  The expert counts come to
the host once a call (one blocking read).  Its load-balance and z-losses
are the capacity path's, on the scores normalised over the E experts.
Its host time is marked with the spans ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` (``core.spans``), the blocking read
also with ``moe.count_read`` inside ``moe.dispatch`` (it waits for the
device to finish all the work queued before it), and it counts
``moe.rows`` (token-choices computed by held experts), ``moe.rows_max``
(the busiest held expert's rows), ``moe.dropped`` (0: dropless) and
``moe.host_syncs`` (blocking device-to-host reads).  A remat recompute
runs the layer again in the backward, and its spans and counters count
again: under remat a training step records each layer call twice.

Placed over a mesh, the MoE is expert-parallel without an all-to-all:
with the groups on the data axes and the tokens replicated over the model
axis (the sequence gathered before the FFN), each model shard routes every
token of its data shard, keeps the dispatch and combine columns of its
own experts, and runs them; the output is a partial sum over the model
axis.  The auxiliary losses come from the replicated routing: the
load-balance loss's two expert means are all-reduced over the data axes
(it is a product of means), the z-loss is a plain mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import spans
from ..distributed.sharding import (all_reduce, is_placed,
                                    logical_placements, mesh_rank,
                                    mesh_ways, model_sharded,
                                    partial_over_model,
                                    partial_where_replicated, run_local,
                                    shard)
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
    """router (D, E); w1 / w3 (E_held, D, F); w2 (E_held, F, D), the
    experts held (all E but for the sigmoid router's share); with the
    sigmoid router the correction bias ``score_bias`` (E,), a buffer, and
    where ``moe_shared_ff`` is set the ``shared`` expert (an :class:`MLP`
    of that width)."""

    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
        held = cfg.experts_held
        g = generator
        self.router = nn.Parameter(dense_init((d, e), generator=g))
        self.w1 = nn.Parameter(dense_init((held, d, f), in_axis=1,
                                          generator=g))
        self.w2 = nn.Parameter(dense_init((held, f, d), in_axis=1,
                                          generator=g))
        self.w3 = nn.Parameter(dense_init((held, d, f), in_axis=1,
                                          generator=g)) \
            if is_gated(cfg.activation) else None
        if cfg.moe_router == "sigmoid":
            dev = g.device if g is not None else None
            self.register_buffer("score_bias", torch.zeros((e,), device=dev),
                                 persistent=False)
        self.shared = MLP(cfg, cfg.moe_shared_ff, generator=g) \
            if cfg.moe_shared_ff else None


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
    "router_z": router z-loss} — added to the training objective.  On a
    placed ``x`` the aux values are this rank's share (see
    :func:`_placed_moe`).
    """
    if is_placed(x):
        return _placed_moe(params, x, cfg, group_size=group_size)
    if cfg.moe_router == "sigmoid":
        return _dropless_moe(params, x, cfg)
    b, s, d = x.shape
    sg = min(group_size, s)
    if (b * s) % sg:
        raise ValueError(f"{b * s} tokens do not split into groups of {sg}")
    xg = shard(x.reshape(b * s // sg, sg, d), "batch", None, None)
    logits, probs, top_e, dispatch, combine = _route(xg, params.router, cfg)
    dispatch = shard(dispatch, "batch", None, "experts", None)
    combine = shard(combine, "batch", None, "experts", None)
    y = _experts(xg, dispatch, combine, params.w1, params.w2, params.w3,
                 cfg).reshape(b, s, d)
    e = cfg.moe_num_experts
    me = torch.mean(probs, dim=(0, 1))                          # (E,)
    ce = torch.mean(_routed_fraction(top_e, e, sg), dim=0)      # fraction routed
    lb = e * torch.sum(me * ce)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"lb_loss": lb, "router_z": zl}


def _route(xg: torch.Tensor, router: torch.Tensor, cfg):
    """Top-k routing of the groups ``xg`` (G, Sg, D): the router logits
    and probabilities (G, Sg, E), the top-k experts (G, Sg, k), and the
    dispatch / combine tensors (G, Sg, E, C)."""
    dt = xg.dtype
    g, sg, _ = xg.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    c = _capacity(sg, k, e, cfg.moe_capacity_factor)

    logits = xg.to(torch.float32) @ router.to(torch.float32)
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
    # is all zeros (jax.nn.one_hot of an index past C).  Summed one choice
    # at a time: a token's choices go to distinct experts, so each slot
    # gets at most one term (the sum is exact in any order) and no
    # (G,Sg,k,E,C) product is held
    pos_oh = F.one_hot(torch.where(keep, pos, 0).long(), c).to(dt) \
        * keep[..., None].to(dt)                                # (G,Sg,k,C)
    eh = choice_eh.to(dt)
    dispatch = torch.zeros((g, sg, e, c), dtype=dt, device=xg.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        term = eh[:, :, j, :, None] * pos_oh[:, :, j, None, :]
        dispatch = dispatch + term
        combine = combine + term * top_p[:, :, j, None, None].to(dt)
    return logits, probs, top_e, dispatch, combine


def _routed_fraction(top_e: torch.Tensor, e: int, sg: int) -> torch.Tensor:
    """(G, E): the share of each group's tokens whose first choice is
    each expert."""
    return torch.sum(F.one_hot(top_e[..., 0], e).to(torch.float32),
                     dim=-2) / sg


def _experts(xg, dispatch, combine, w1, w2, w3, cfg):
    """The experts of ``dispatch``'s columns on their capacity slots, and
    the results combined back onto the tokens: (G, Sg, D)."""
    dt = xg.dtype
    ein = torch.einsum("gsec,gsd->egcd", dispatch, xg)          # (E,G,C,D)
    ein = shard(ein, "experts", "batch", None, None)

    act = activation_fn(cfg.activation)
    h = act(torch.einsum("egcd,edf->egcf", ein, w1.to(dt)))
    if w3 is not None:
        h = h * torch.einsum("egcd,edf->egcf", ein, w3.to(dt))
    h = shard(h, "experts", "batch", None, None)
    out_e = torch.einsum("egcf,efd->egcd", h, w2.to(dt))
    out_e = shard(out_e, "experts", "batch", None, None)
    return torch.einsum("gsec,egcd->gsd", combine, out_e)       # back to tokens


def _sigmoid_route(x2: torch.Tensor, params: MoE, cfg):
    """Nemotron-H's router over tokens ``x2`` (T, D): the float32 logits
    and sigmoid scores (T, E), the top-k experts by score plus correction
    bias (T, k), and their weights (T, k): the unbiased scores
    renormalised over the k, times ``moe_routed_scale``."""
    logits = x2.to(torch.float32) @ params.router.to(torch.float32)
    scores = torch.sigmoid(logits)
    top_e = torch.topk(scores + params.score_bias, cfg.moe_top_k,
                       dim=-1).indices
    w = torch.gather(scores, -1, top_e)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.moe_routed_scale
    return logits, scores, top_e, w


def _dropless_moe(params: MoE, x: torch.Tensor, cfg):
    """The sigmoid router's dropless MoE on the experts held (see the
    module docstring).  x: (B, S, D) -> (B, S, D), aux."""
    dt = x.dtype
    b, s, d = x.shape
    e, k, held = cfg.moe_num_experts, cfg.moe_top_k, cfg.experts_held
    x2 = x.reshape(b * s, d)
    with spans.span("moe.route"):
        logits, scores, top_e, w = _sigmoid_route(x2, params, cfg)
    with spans.span("moe.dispatch"):
        # (token, choice) pairs by held expert; the rest sorted last
        local = top_e.reshape(-1) - cfg.moe_expert_offset
        local = torch.where((local >= 0) & (local < held), local, held)
        order = torch.argsort(local, stable=True)
        with spans.span("moe.count_read"):
            sizes = torch.bincount(local, minlength=held + 1)[:held].tolist()
            spans.count("moe.host_syncs")
        rows = order[:sum(sizes)]
        tok = rows // k
        xs = x2[tok]
    with spans.span("moe.experts"):
        act = activation_fn(cfg.activation)
        w1s, w2s = params.w1.to(dt).unbind(0), params.w2.to(dt).unbind(0)
        w3s = params.w3.to(dt).unbind(0) if params.w3 is not None else None
        outs, at = [], 0
        for j, n in enumerate(sizes):
            if n == 0:
                continue
            xe = xs[at:at + n]
            at += n
            h = act(xe @ w1s[j])
            if w3s is not None:
                h = h * (xe @ w3s[j])
            outs.append(h @ w2s[j])
        shared = ffn_apply(params.shared, x, cfg).reshape(b * s, d) \
            if params.shared is not None else None
    with spans.span("moe.combine"):
        y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
        if outs:
            y = y.index_add(0, tok, torch.cat(outs).to(torch.float32)
                            * w.reshape(-1)[rows, None])
        y = y.to(dt)
        if shared is not None:
            y = y + shared
    spans.count("moe.rows", len(rows))
    spans.count("moe.rows_max", max(sizes))
    spans.count("moe.dropped", 0)
    probs = scores / scores.sum(-1, keepdim=True)               # over E
    lb = e * torch.sum(probs.mean(0)
                       * _routed_fraction(top_e, e, b * s))
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y.reshape(b, s, d), {"lb_loss": lb, "router_z": zl}


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _placed_moe(params: MoE, x, cfg, *, group_size: int):
    """Expert parallelism on local shards (see the module docstring).

    Each rank routes its data shard's groups and runs the experts it
    holds (their weights gathered over the data axis right before use);
    ``y`` is a partial sum over the model axis where the experts divide
    it, else every model shard runs them all.  The auxiliary losses are
    returned as plain tensors, this rank's share: summed over the data
    axes, as the train step sums its loss, they are the global values.
    Every model shard computes them alike, so each takes 1/tp of their
    gradient and the partial sums over the model axis add to one."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    lp = lambda t, *ax: logical_placements(mesh, t.shape, *ax)  # noqa: E731
    b, s, d = x.shape
    sg = min(group_size, s)
    if s % sg:
        raise ValueError(f"a placed MoE groups within a sequence: {s} "
                         f"tokens do not split into groups of {sg}")
    g_all = b * s // sg
    e = cfg.moe_num_experts
    x_pl = lp(x, "batch", None, "embed")
    w_pl = lp(params.w1, "experts", None, None)
    w2_pl = lp(params.w2, "experts", None, None)
    r_pl = lp(params.router, None, None)
    ep = model_sharded(w_pl, mesh)
    tp = mesh_ways(mesh, "model")
    r = mesh_rank(mesh, "model")
    e_loc = e // tp if ep else e
    e0 = r * e_loc if ep else 0
    # the mesh dims the batch is split over, read from x's placement
    data = [n for n, p in zip(mesh.mesh_dim_names, x_pl)
            if isinstance(p, Shard) and p.dim == 0]
    summed = () if ep else ("model",)
    grad_scale = 1.0 / tp if ep else 1.0

    def grad_pl(pl):
        return partial_where_replicated(pl, mesh, summed=summed)

    def body(xl, router, w1, w2, w3):
        bl = xl.shape[0]
        xg = xl.reshape(bl * s // sg, sg, d)
        logits, probs, top_e, dispatch, combine = _route(xg, router, cfg)
        cols = slice(e0, e0 + e_loc)
        y = _experts(xg, dispatch[:, :, cols], combine[:, :, cols], w1, w2,
                     w3, cfg).reshape(bl, s, d)
        # the load-balance loss's means over every group of the batch
        me = torch.sum(probs, dim=(0, 1))
        ce = torch.sum(_routed_fraction(top_e, e, sg), dim=0)
        for name in data:
            me = all_reduce(me, mesh, name, grad="sum")
            ce = all_reduce(ce, mesh, name)
        share = xg.shape[0] / g_all
        lb = e * torch.sum((me / (g_all * sg)) * (ce / g_all)) * share
        zl = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / (g_all * sg)
        return (y, _GradScale.apply(lb, grad_scale),
                _GradScale.apply(zl, grad_scale))

    y, lb, zl = run_local(
        body, mesh,
        [(x, x_pl, grad_pl(x_pl)), (params.router, r_pl, grad_pl(r_pl)),
         (params.w1, w_pl, grad_pl(w_pl)), (params.w2, w2_pl, grad_pl(w2_pl)),
         (params.w3, w_pl if params.w3 is not None else None)
         + ((grad_pl(w_pl),) if params.w3 is not None else ())],
        (partial_over_model(x_pl, mesh, ep), None, None))
    return y, {"lb_loss": lb.to_local(), "router_z": zl.to_local()}
