"""Grouped-query attention with the features the assigned archs need.

Port of ``repro.models.attention``.  Covers GQA, MHA (whisper), qk-norm
(qwen3), attention-logit softcapping and sliding-window local layers
(gemma2), RoPE, cross-attention (whisper decoder), and three modes:

  * ``train``    — full causal self-attention, no cache,
  * ``prefill``  — causal self-attention that also returns the KV cache,
  * ``decode``   — one-token query against a pre-allocated KV cache.

Numerics follow the JAX package: the two attention products take their
operands rounded to bfloat16 and accumulate in float32.  A product of two
bf16 tensors in torch returns bf16, so the operands are rounded to bf16 and
multiplied as float32 (exact products, float32 sums, no second rounding).
Masked scores are ``-1e30`` (not ``-inf``) and the softmax is float32.
Queries run in chunks of ``q_chunk`` so the score matrix never grows past
(q_chunk, Sk).  With ``cfg.attn_chunk_remat`` (long causal sequences) a
chunk's keys stop at its last query, and in a recorded forward each
chunk's scores are recomputed in the backward, so that autograd holds no
(Sq, Sk) matrix: the masked keys' exact zeros are left out of the sums,
which changes no value but their order.

On a DTensor input (a placed model, ``distributed.partition.place``) the
block runs on local shards (``distributed.sharding.run_local``) as GSPMD
partitions the JAX block: q heads and the output projection on the model
axis (the output a partial sum), the replicated kv heads computed on every
model shard, the weights gathered over the data axis right before use.
Decode over a ``kv_seq``-sharded cache is the flash-decoding split: each
shard scores its slice of the cache against every query head, and the
softmax's max and sum and the weighted values are all-reduced.  Cross-
attention (the whisper decoder) runs the same way with its keys and
values from the encoder's output, cached at prefill and read at decode,
and the encoder's bidirectional block with its heads on the model axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (all_gather, all_reduce, is_placed,
                                    logical_placements, mesh_rank,
                                    mesh_ways, model_sharded,
                                    partial_over_model,
                                    partial_where_replicated, run_local,
                                    shard)
from .layers import apply_rope, dense_init, rmsnorm, rope, softcap

__all__ = ["attention_params", "attention", "encoder_attention", "Attention",
           "AttnCache", "init_attn_cache"]


class AttnCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, KVp, hd)
    v: torch.Tensor      # (B, S_max, KVp, hd)


def init_attn_cache(batch: int, max_len: int, num_kv: int, head_dim: int,
                    dtype=torch.bfloat16, *, device=None) -> AttnCache:
    z = torch.zeros((batch, max_len, num_kv, head_dim), dtype=dtype,
                    device=device)
    return AttnCache(k=z, v=z)


def _kv_heads(cfg) -> int:
    """KVp == num_kv_heads unless the layer is MHA (kv == heads), in which
    case kv pads together with q so the GQA group size stays integral."""
    return (cfg.padded_num_heads if cfg.num_kv_heads == cfg.num_heads
            else cfg.num_kv_heads)


class Attention(nn.Module):
    """Weights for one attention block, padded for TP divisibility:
    q (D, Hp, hd); k/v (D, KVp, hd); o (Hp, hd, D); qk-norm scales (hd,)."""

    def __init__(self, cfg, *, cross: bool = False,
                 generator: torch.Generator | None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        hp, kvp = cfg.padded_num_heads, _kv_heads(cfg)
        g = generator
        self.wq = nn.Parameter(dense_init((d, hp, hd), generator=g))
        self.wk = nn.Parameter(dense_init((d, kvp, hd), generator=g))
        self.wv = nn.Parameter(dense_init((d, kvp, hd), generator=g))
        self.wo = nn.Parameter(dense_init((hp, hd, d), in_axis=0,
                                          generator=g))
        self.has_qk_norm = bool(cfg.qk_norm and not cross)
        if self.has_qk_norm:
            dev = g.device if g is not None else None
            self.q_norm = nn.Parameter(torch.zeros((hd,), device=dev))
            self.k_norm = nn.Parameter(torch.zeros((hd,), device=dev))


def attention_params(cfg, *, cross: bool = False,
                     generator: torch.Generator | None) -> Attention:
    return Attention(cfg, cross=cross, generator=generator)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") with the weight cast to x's dtype at use."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).reshape(
        *x.shape[:-1], h, k)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d).to(o.dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, carried as float32 (a bf16 operand of a product
    that accumulates in float32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by repeating each kv head."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
        .reshape(b, s, kv * n_rep, hd)


def _mask(kpos, qpos, *, causal, window, kv_valid_len):
    """Boolean (B, 1, Sq, Sk) mask; qpos (B, Sq), kpos (Sk,)."""
    kp = kpos[None, None, None, :]
    qp = qpos[:, None, :, None]
    mask = torch.ones((qpos.shape[0], 1, qpos.shape[1], kpos.shape[0]),
                      dtype=torch.bool, device=kpos.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > (qp - window)
    if kv_valid_len is not None:
        mask &= kp < kv_valid_len[:, None, None, None]
    return mask


def _chunked_scores_attend(q, k, v, *, q_positions, causal: bool,
                           window: int | None, cap: float | None,
                           kv_valid_len, q_chunk: int,
                           chunk_remat: bool = False):
    """Tiled softmax(QKᵀ)V.  q: (B,Sq,H,hd), k/v: (B,Sk,H,hd).

    q_positions: (B, Sq) absolute positions of the queries (for causal and
    sliding-window masks against key positions 0..Sk-1).
    kv_valid_len: None or (B,) — keys at index >= valid_len are masked.
    chunk_remat: causal self-attention over the queries at positions
    0..Sq-1 (``cfg.attn_chunk_remat``): a chunk's keys stop at its last
    query, and its scores are recomputed in the backward.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)
    kb, vb = _bf16(k), _bf16(v)

    def one_chunk(qc, qpos, kb, vb, kpos):    # (B, cq, H, hd), (B, cq)
        s = torch.einsum("bqhd,bshd->bhqs", _bf16(qc), kb) * scale
        if cap is not None:
            s = softcap(s, cap)
        mask = _mask(kpos, qpos, causal=causal, window=window,
                     kv_valid_len=kv_valid_len)
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqs,bshd->bqhd", _bf16(p), vb)
        return o.to(q.dtype)

    if sq <= q_chunk:
        return one_chunk(q, q_positions, kb, vb, kpos)

    while sq % q_chunk:          # largest divisor ≤ requested chunk
        q_chunk -= 1
    remat = chunk_remat and torch.is_grad_enabled() and q.requires_grad
    outs = []
    for i in range(0, sq, q_chunk):
        keys = slice(0, i + q_chunk if chunk_remat else sk)
        args = (q[:, i:i + q_chunk], q_positions[:, i:i + q_chunk],
                kb[:, keys], vb[:, keys], kpos[keys])
        outs.append(checkpoint(one_chunk, *args, use_reentrant=False)
                    if remat else one_chunk(*args))
    return torch.cat(outs, dim=1)


def _gqa_decode_attend(q, k, v, *, n_rep: int, q_positions,
                       window: int | None, cap: float | None,
                       kv_valid_len, causal: bool = True):
    """One-token attention against the cache without repeating KV heads.

    q: (B, 1, H, hd) with H = KV·n_rep; k/v: (B, S, KV, hd).  q is viewed
    as (KV, group), so each kv head serves its group of query heads.
    """
    b, _, h, hd = q.shape
    sk = k.shape[1]
    kv = k.shape[2]
    qg = q.reshape(b, kv, n_rep, hd)
    scale = hd ** -0.5

    s = torch.einsum("bkgd,bskd->bkgs", _bf16(qg), _bf16(k)) * scale
    if cap is not None:
        s = softcap(s, cap)
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)
    mask = _mask(kpos, q_positions[:, :1], causal=causal, window=window,
                 kv_valid_len=kv_valid_len)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", _bf16(p), _bf16(v))
    return o.reshape(b, 1, h, hd).to(q.dtype)


def attention(params: Attention, x: torch.Tensor, *, cfg, mode: str,
              positions: torch.Tensor, cache: AttnCache | None = None,
              cur_len: torch.Tensor | None = None,
              layer_window: int | None = None,
              kv_source: torch.Tensor | None = None,
              is_cross: bool = False,
              rope_enabled: bool = True,
              q_chunk: int = 1024):
    """One attention block.

    Args:
      x: (B, Sq, D) residual-stream input (already normed).
      mode: "train" | "prefill" | "decode".
      positions: (B, Sq) absolute positions of x's tokens.
      cache/cur_len: decode-mode KV cache and (B,) valid lengths;
        prefill mode returns a fresh cache.
      layer_window: sliding window size for local layers (None = global).
      kv_source: if given, keys/values come from this sequence instead of x
        (cross-attention). Cross K/V are cached at prefill.
    Returns (out (B,Sq,D), new_cache | None).
    """
    hp = cfg.padded_num_heads
    n_rep = hp // _kv_heads(cfg)
    dt = x.dtype
    cross = is_cross or kv_source is not None
    if is_placed(x):
        return _placed_attention(params, x, cfg=cfg, mode=mode, cache=cache,
                                 cur_len=cur_len, layer_window=layer_window,
                                 rope_enabled=rope_enabled and not cross,
                                 q_chunk=q_chunk, kv_source=kv_source,
                                 cross=cross)

    q = _proj(x, params.wq)
    if cross and mode == "decode":
        k_new = v_new = None           # cross K/V precomputed at prefill
    else:
        src = kv_source if cross else x
        k_new = _proj(src, params.wk)
        v_new = _proj(src, params.wv)

    if params.has_qk_norm:
        q = rmsnorm(q, params.q_norm)
        if k_new is not None:
            k_new = rmsnorm(k_new, params.k_norm)

    if rope_enabled and not cross:
        sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta)
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
        q = apply_rope(q, sin, cos)
        if k_new is not None:
            k_new = apply_rope(k_new, sin, cos)

    q = shard(q, "batch", None, "heads", None)

    new_cache = None
    if mode == "decode":
        if cache is None or cur_len is None:
            raise ValueError("decode needs a cache and cur_len")
        if k_new is not None and not cross:
            # scatter this step's K/V at cur_len (one slot a lane), out of
            # place: the engine keeps the old cache for retired lanes
            bidx = torch.arange(x.shape[0], device=x.device)
            slot = cur_len.long()
            new_cache = AttnCache(
                k=cache.k.index_put((bidx, slot),
                                    k_new[:, 0].to(cache.k.dtype)),
                v=cache.v.index_put((bidx, slot),
                                    v_new[:, 0].to(cache.v.dtype)))
        else:
            new_cache = cache
        k_full = shard(new_cache.k, "batch", "kv_seq", None, None)
        v_full = shard(new_cache.v, "batch", "kv_seq", None, None)
        if cross:
            valid = torch.full_like(cur_len, k_full.shape[1])  # encoder ctx
        else:
            valid = cur_len + 1
        out = _gqa_decode_attend(
            q, k_full.to(dt), v_full.to(dt), n_rep=n_rep,
            q_positions=positions, window=layer_window,
            cap=cfg.attn_softcap, kv_valid_len=valid, causal=not cross)
    else:
        k_new = shard(k_new, "batch", None, "kv", None)
        v_new = shard(v_new, "batch", None, "kv", None)
        out = _chunked_scores_attend(
            q, _repeat_kv(k_new, n_rep), _repeat_kv(v_new, n_rep),
            q_positions=positions, causal=not cross, window=layer_window,
            cap=cfg.attn_softcap, kv_valid_len=None, q_chunk=q_chunk,
            chunk_remat=cfg.attn_chunk_remat and not cross
            and layer_window is None)
        if mode == "prefill":
            new_cache = AttnCache(k=shard(k_new, "batch", "kv_seq", None, None),
                                  v=shard(v_new, "batch", "kv_seq", None, None))

    out = shard(out, "batch", None, "heads", None)
    return _out(out, params.wo), new_cache


class _ReplicatedProj(torch.autograd.Function):
    """``x @ w`` for a weight replicated over the model axis whose output
    every model shard uses on its own heads (the kv projections, Mamba's
    shared B/C).  Backward: ``dx`` from the shard's own ``dy`` (a partial
    sum, reduced with the region's input), and ``dw`` from the ``dy``
    summed over the model axis, each shard computing its 1/tp slice of
    ``w``'s rows and gathering the rest: GSPMD's split of a replicated
    weight's gradient, so no shard repeats it."""

    @staticmethod
    def forward(ctx, x, w, mesh, tp, r):
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.tp, ctx.r = mesh, tp, r
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed._functional_collectives as fc

        x, w = ctx.saved_tensors
        mesh, tp, r = ctx.mesh, ctx.tp, ctx.r
        dx = dy @ w.T
        group = (mesh, mesh.mesh_dim_names.index("model"))
        dy = fc.wait_tensor(fc.all_reduce(dy.contiguous(), "sum", group))
        rows = w.shape[0] // tp
        xs = x[..., r * rows:(r + 1) * rows].reshape(-1, rows)
        dw = xs.T @ dy.reshape(-1, dy.shape[-1])
        return dx, all_gather(dw, mesh, "model", 0), None, None, None


def replicated_proj(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w`` (w 2-D, cast to x's dtype) inside a region, with
    :class:`_ReplicatedProj`'s backward where the model axis is wider than
    one and divides w's rows; the plain product otherwise."""
    w = w.to(x.dtype)
    tp = mesh_ways(mesh, "model")
    if tp == 1 or w.shape[0] % tp or not torch.is_grad_enabled():
        return x @ w
    return _ReplicatedProj.apply(x, w, mesh, tp, mesh_rank(mesh, "model"))


def _placed_attention(params: Attention, x, *, cfg, mode: str, cache,
                      cur_len, layer_window, rope_enabled: bool,
                      q_chunk: int, kv_source=None, cross: bool = False,
                      causal: bool = True):
    """The block on a placed ``x`` (B, Sq, D): see the module docstring.
    Returns (out (B, Sq, D) DTensor, new_cache | None); the prefill cache
    comes back with its sequence on ``kv_seq``.

    ``cross``: keys and values come from the placed ``kv_source`` (the
    encoder's output, batch on the data axes) at prefill and from the
    cache, read only, at decode; nothing is masked.  ``causal=False``: the
    whisper encoder's bidirectional block."""
    causal = causal and not cross
    mesh = x.device_mesh
    hp, kvp = cfg.padded_num_heads, _kv_heads(cfg)
    n_rep = hp // kvp
    kv_ax = "heads" if kvp == hp else "kv"
    lp = lambda t, *ax: logical_placements(mesh, t.shape, *ax)  # noqa: E731
    x_pl = lp(x, "batch", None, "embed")
    wq_pl = lp(params.wq, None, "heads", None)
    wk_pl = lp(params.wk, None, kv_ax, None)
    wo_pl = lp(params.wo, "heads", None, None)
    heads_sh = model_sharded(wq_pl, mesh)
    if heads_sh != model_sharded(wo_pl, mesh):
        raise ValueError("wq and wo disagree on the heads sharding")
    tp = mesh_ways(mesh, "model")
    r = mesh_rank(mesh, "model")
    norms = [(params.q_norm, lp(params.q_norm, None)),
             (params.k_norm, lp(params.k_norm, None))] \
        if params.has_qk_norm else [(None, None), (None, None)]
    out_pl = partial_over_model(x_pl, mesh, heads_sh)
    h_loc = hp // tp if heads_sh else hp
    kv_loc = kvp // tp if model_sharded(wk_pl, mesh) else kvp
    q0, kv0 = (r * h_loc if heads_sh else 0), \
        (r * kv_loc if kv_loc < kvp else 0)
    scale = cfg.head_dim ** -0.5

    def kv_proj(xl, w):
        if kv_loc < kvp:
            return _proj(xl, w)
        d, h, k = w.shape
        return replicated_proj(xl, w.reshape(d, h * k), mesh).reshape(
            *xl.shape[:-1], h, k)

    def project(xl, src, wq, wk, wv, qn, kn, pos):
        q, k, v = _proj(xl, wq), kv_proj(src, wk), kv_proj(src, wv)
        if qn is not None:
            q, k = rmsnorm(q, qn), rmsnorm(k, kn)
        if rope_enabled:
            sin, cos = rope(pos, cfg.head_dim, cfg.rope_theta)
            sin, cos = sin[:, :, None, :], cos[:, :, None, :]
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        return q, k, v

    def kv_for_local_heads(t):
        """(B, S, KV_loc, hd) -> the kv head of each local q head."""
        if h_loc == kv_loc * n_rep and kv0 * n_rep == q0:
            return _repeat_kv(t, n_rep)
        idx = (q0 + torch.arange(h_loc, device=t.device)) // n_rep - kv0
        return t.index_select(2, idx)

    # the kv weights' gradient comes back summed over the model axis
    # (replicated_proj); over the data axes it is partial
    wk_in = (wk_pl,) if kv_loc < kvp else (
        wk_pl, partial_where_replicated(wk_pl, mesh, summed=("model",)))
    if mode != "decode":
        src = kv_source if cross else x

        def body(xl, sl, wq, wk, wv, wo, qn, kn):
            b, sq, _ = xl.shape
            pos = torch.arange(sq, dtype=torch.int32,
                               device=xl.device)[None].expand(b, sq)
            q, k, v = project(xl, xl if sl is None else sl, wq, wk, wv, qn,
                              kn, pos)
            o = _chunked_scores_attend(
                q, kv_for_local_heads(k), kv_for_local_heads(v),
                q_positions=pos, causal=causal, window=layer_window,
                cap=cfg.attn_softcap, kv_valid_len=None, q_chunk=q_chunk)
            return _out(o, wo), k, v

        kv_pl = logical_placements(
            mesh, (*src.shape[:2], *params.wk.shape[1:]), "batch", None,
            kv_ax, None)
        out, k, v = run_local(
            body, mesh, [(x, x_pl),
                         (kv_source, lp(kv_source, "batch", None, "embed"))
                         if cross else (None, None),
                         (params.wq, wq_pl), (params.wk, *wk_in),
                         (params.wv, *wk_in), (params.wo, wo_pl), *norms],
            (out_pl, kv_pl, kv_pl))
        new_cache = None
        if mode == "prefill":
            new_cache = AttnCache(
                k=shard(k, "batch", "kv_seq", None, None),
                v=shard(v, "batch", "kv_seq", None, None))
        return out, new_cache

    if cache is None or cur_len is None:
        raise ValueError("decode needs a cache and cur_len")
    c_pl = lp(cache.k, "batch", "kv_seq", None, None)
    seq_sh = model_sharded(c_pl, mesh)
    vec_pl = lp(cur_len, "batch")
    s_glob = cache.k.shape[1]

    def body(xl, wq, wk, wv, wo, qn, kn, ck, cv, cur):
        b = xl.shape[0]
        s_loc = ck.shape[1]
        if cross:                   # the cache holds the encoder's K/V
            q = _proj(xl, wq)
        else:
            q, k_new, v_new = project(xl, xl, wq, wk, wv, qn, kn,
                                      cur[:, None])
            if kv_loc < kvp:               # the cache holds every kv head
                k_new = all_gather(k_new, mesh, "model", 2)
                v_new = all_gather(v_new, mesh, "model", 2)
            # this step's K/V at cur_len, written by the shard that holds it
            slot = cur.long() - (r * s_loc if seq_sh else 0)
            mine = (slot >= 0) & (slot < s_loc)
            slot = slot.clamp(0, s_loc - 1)
            bidx = torch.arange(b, device=xl.device)
            keep = mine[:, None, None]
            ck = ck.index_put((bidx, slot), torch.where(
                keep, k_new[:, 0].to(ck.dtype), ck[bidx, slot]))
            cv = cv.index_put((bidx, slot), torch.where(
                keep, v_new[:, 0].to(cv.dtype), cv[bidx, slot]))
        valid = torch.full_like(cur, s_glob) if cross else cur + 1
        kf, vf = ck.to(q.dtype), cv.to(q.dtype)
        if not seq_sh and heads_sh and h_loc % n_rep == 0:
            # the whole cache here: the shard's own heads against their
            # kv heads
            k0, nk = q0 // n_rep, h_loc // n_rep
            o = _gqa_decode_attend(
                q, kf[:, :, k0:k0 + nk], vf[:, :, k0:k0 + nk], n_rep=n_rep,
                q_positions=cur[:, None], window=layer_window,
                cap=cfg.attn_softcap, kv_valid_len=valid, causal=causal)
            return _out(o, wo), ck, cv
        if heads_sh:
            q = all_gather(q, mesh, "model", 2)
        if not seq_sh:
            o = _gqa_decode_attend(
                q, kf, vf, n_rep=n_rep, q_positions=cur[:, None],
                window=layer_window, cap=cfg.attn_softcap,
                kv_valid_len=valid, causal=causal)
        else:
            kvh = kf.shape[2]
            qg = q.reshape(b, kvh, n_rep, cfg.head_dim)
            sc = torch.einsum("bkgd,bskd->bkgs", _bf16(qg), _bf16(kf)) \
                * scale
            if cfg.attn_softcap is not None:
                sc = softcap(sc, cfg.attn_softcap)
            kpos = r * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                            device=xl.device)
            mask = _mask(kpos, cur[:, None], causal=causal,
                         window=layer_window, kv_valid_len=valid)
            sc = torch.where(mask, sc, -1e30)
            m = all_reduce(torch.amax(sc, dim=-1, keepdim=True), mesh,
                           "model", "max")
            e = torch.exp(sc - m)
            den = all_reduce(e.sum(dim=-1, keepdim=True), mesh, "model")
            o = torch.einsum("bkgs,bskd->bkgd", _bf16(e / den), _bf16(vf))
            o = all_reduce(o, mesh, "model")
            o = o.reshape(b, 1, hp, cfg.head_dim).to(q.dtype)
        return _out(o[:, :, q0:q0 + h_loc], wo), ck, cv

    kv_w = [(None, None), (None, None)] if cross else \
        [(params.wk, wk_pl), (params.wv, wk_pl)]
    out, k, v = run_local(
        body, mesh, [(x, x_pl), (params.wq, wq_pl), *kv_w,
                     (params.wo, wo_pl), *norms,
                     (cache.k, c_pl), (cache.v, c_pl), (cur_len, vec_pl)],
        (out_pl, c_pl, c_pl))
    # the cross cache is read only: the step returns the one it was given
    return out, cache if cross else AttnCache(k=k, v=v)


def encoder_attention(params: Attention, x: torch.Tensor, *, cfg,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Bidirectional self-attention (whisper encoder).  On a placed ``x``
    its heads run on the model axis, as the decoder's do."""
    if is_placed(x):
        return _placed_attention(params, x, cfg=cfg, mode="train",
                                 cache=None, cur_len=None, layer_window=None,
                                 rope_enabled=False, q_chunk=q_chunk,
                                 causal=False)[0]
    n_rep = cfg.padded_num_heads // _kv_heads(cfg)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)
    q = shard(_proj(x, params.wq), "batch", None, "heads", None)
    k = _proj(x, params.wk)
    v = _proj(x, params.wv)
    out = _chunked_scores_attend(
        q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), q_positions=pos,
        causal=False, window=None, cap=cfg.attn_softcap,
        kv_valid_len=None, q_chunk=q_chunk)
    return _out(out, params.wo)
