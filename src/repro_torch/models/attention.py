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
(q_chunk, Sk).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..distributed.sharding import shard
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
                           kv_valid_len, q_chunk: int):
    """Tiled softmax(QKᵀ)V.  q: (B,Sq,H,hd), k/v: (B,Sk,H,hd).

    q_positions: (B, Sq) absolute positions of the queries (for causal and
    sliding-window masks against key positions 0..Sk-1).
    kv_valid_len: None or (B,) — keys at index >= valid_len are masked.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)
    kb, vb = _bf16(k), _bf16(v)

    def one_chunk(qc, qpos):                  # (B, cq, H, hd), (B, cq)
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
        return one_chunk(q, q_positions)

    while sq % q_chunk:          # largest divisor ≤ requested chunk
        q_chunk -= 1
    return torch.cat([one_chunk(q[:, i:i + q_chunk],
                                q_positions[:, i:i + q_chunk])
                      for i in range(0, sq, q_chunk)], dim=1)


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
            cap=cfg.attn_softcap, kv_valid_len=None, q_chunk=q_chunk)
        if mode == "prefill":
            new_cache = AttnCache(k=shard(k_new, "batch", "kv_seq", None, None),
                                  v=shard(v_new, "batch", "kv_seq", None, None))

    out = shard(out, "batch", None, "heads", None)
    return _out(out, params.wo), new_cache


def encoder_attention(params: Attention, x: torch.Tensor, *, cfg,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Bidirectional self-attention (whisper encoder)."""
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
