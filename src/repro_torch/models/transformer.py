"""Unified LM: one model covering all assigned families via ArchConfig.

Port of ``repro.models.transformer``.  Families: dense (qwen3/llama3/
gemma2/nemotron), moe (dbrx/arctic), ssm (mamba2), hybrid (jamba),
enc-dec audio (whisper, stub frontend), vlm (llava, stub frontend).

:class:`Transformer` is an ``nn.Module`` whose layers are modules
(attention, MLP, MoE, Mamba-2) holding ``nn.Parameter``s at the JAX
package's shapes and names, in float32 (``cfg.param_dtype``); every
weight is cast to the compute dtype where it is used.  The layer loop is
a Python loop over :func:`layer_plan`: the JAX package scans stacked
blocks of :func:`block_size` layers, a compile-size device with no torch
counterpart, so caches here are a list with one entry per layer.

Modes: "train" (no cache), "prefill" (returns cache), "decode" (one token,
consumes/returns cache).  With ``cfg.remat``, a train-mode forward that
records gradients recomputes each layer in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint`` of
each block does.

A model placed over a process mesh (``distributed.partition.place``: its
parameters DTensors) runs the same loop on DTensors: the annotations
redistribute the residual stream, and each block, the vocab-sharded
embedding and the head run on local shards (their modules say how).  The
placed path covers the dense and Mamba-2 families; MoE, the hybrid stack
and the whisper / llava front ends raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.sharding import (current_rules, is_placed,
                                    logical_placements, mesh_rank,
                                    model_sharded, partial_over_model,
                                    run_local, shard, use_rules)
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import mamba as mamba_mod
from .layers import dense_init, embed_init, layernorm, rmsnorm, softcap

__all__ = ["LayerSpec", "layer_plan", "block_size", "stack_position",
           "lm_init", "lm_apply", "init_cache", "Transformer"]


@dataclass(frozen=True)
class LayerSpec:
    kind: str                  # "attn" | "mamba"
    window: int | None = None  # sliding window (gemma2 local layers)
    ffn: str | None = "dense"  # "dense" | "moe" | None
    cross: bool = False        # decoder cross-attention (whisper)


def layer_plan(cfg) -> list[LayerSpec]:
    plan = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            kind = "mamba"
        elif cfg.attn_layer_period:
            kind = ("attn" if i % cfg.attn_layer_period == cfg.attn_layer_offset
                    else "mamba")
        else:
            kind = "attn"
        window = None
        if cfg.local_global_period and kind == "attn":
            if i % cfg.local_global_period != cfg.local_global_period - 1:
                window = cfg.sliding_window
        ffn = None if cfg.family == "ssm" else "dense"
        if cfg.moe_num_experts and (i % cfg.moe_period == cfg.moe_period - 1):
            ffn = "moe"
        plan.append(LayerSpec(kind=kind, window=window, ffn=ffn,
                              cross=cfg.is_encdec))
    return plan


def block_size(plan: list[LayerSpec]) -> int:
    """The smallest repeating period of the plan (the JAX package stacks
    layers in blocks of this many)."""
    n = len(plan)
    for p in range(1, n + 1):
        if n % p == 0 and all(plan[i] == plan[i % p] for i in range(n)):
            return p
    return n


def stack_position(cfg, name: str) -> tuple[str, int, int] | None:
    """Where the JAX package keeps the port's parameter ``name``: the
    dotted path of its stacked leaf, this layer's index on the stacking
    axis and that axis' length; None for a leaf it does not stack.

    Decoder layer ``b·bs + j`` is index ``b`` of ``blocks.p{j}`` (``bs``
    the plan's block size), encoder layer ``i`` index ``i`` of
    ``encoder.layers``."""
    parts = name.split(".")
    if parts[0] == "layers":
        i, bs = int(parts[1]), block_size(layer_plan(cfg))
        return (".".join([f"blocks.p{i % bs}", *parts[2:]]), i // bs,
                cfg.num_layers // bs)
    if parts[:2] == ["encoder", "layers"]:
        return (".".join(["encoder.layers", *parts[3:]]), int(parts[2]),
                cfg.encoder_layers)
    return None


def _remat(cfg, mode: str) -> bool:
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def _under_rules(fn):
    """``fn`` run under the rules active now: a remat recomputation runs
    in the backward, which the autograd engine runs on a device thread of
    its own, where the (thread-local) rules are not installed."""
    rules = current_rules()
    if rules is None:
        return fn

    def run(*args, **kw):
        with use_rules(rules):
            return fn(*args, **kw)
    return run


class Norm(nn.Module):
    """RMSNorm ``scale`` (zero-init, applied as 1 + scale) or LayerNorm
    ``scale`` / ``bias``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        if cfg.norm_type == "layernorm":
            self.scale = nn.Parameter(torch.ones((d,), device=device))
            self.bias = nn.Parameter(torch.zeros((d,), device=device))
        else:
            self.scale = nn.Parameter(torch.zeros((d,), device=device))
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            return layernorm(x, self.scale, self.bias)
        return rmsnorm(x, self.scale)


class Layer(nn.Module):
    """One decoder layer: its mixer (``attn`` or ``mamba``), the optional
    cross-attention, and its FFN (``mlp`` and/or ``moe``) with their norms,
    named as the JAX package's layer dict."""

    def __init__(self, cfg, spec: LayerSpec, *,
                 generator: torch.Generator | None):
        super().__init__()
        g = generator
        dev = g.device if g is not None else None
        self.spec = spec
        self.ln1 = Norm(cfg, dev)
        if spec.kind == "attn":
            self.attn = attn_mod.attention_params(cfg, generator=g)
        else:
            self.mamba = mamba_mod.mamba_params(cfg, generator=g)
        if cfg.sandwich_norm:
            self.ln1_post = Norm(cfg, dev)
        if spec.cross:
            self.ln_cross = Norm(cfg, dev)
            self.cross = attn_mod.attention_params(cfg, cross=True,
                                                   generator=g)
        if spec.ffn is not None:
            self.ln2 = Norm(cfg, dev)
            if spec.ffn == "moe":
                self.moe = ffn_mod.moe_params(cfg, generator=g)
                if cfg.moe_dense_residual:
                    self.mlp = ffn_mod.ffn_params(
                        cfg, d_ff=cfg.dense_residual_ff, generator=g)
            else:
                self.mlp = ffn_mod.ffn_params(cfg, generator=g)
            if cfg.sandwich_norm:
                self.ln2_post = Norm(cfg, dev)

    def forward(self, x: torch.Tensor, *, cfg, mode: str,
                positions: torch.Tensor, cache: dict | None,
                cur_len: torch.Tensor | None,
                enc_out: torch.Tensor | None):
        spec = self.spec
        aux = None
        new_cache: dict = {}

        h = shard(self.ln1(x), "batch", None, "embed")
        if spec.kind == "attn":
            a, c_new = attn_mod.attention(
                self.attn, h, cfg=cfg, mode=mode, positions=positions,
                cache=cache.get("self") if cache else None, cur_len=cur_len,
                layer_window=spec.window,
                rope_enabled=cfg.max_position == 0)
        elif mode == "decode":
            a, c_new = mamba_mod.mamba_decode_step(self.mamba, h, cfg,
                                                   cache["self"])
        else:
            a, c_new = mamba_mod.mamba_apply(
                self.mamba, h, cfg,
                cache=cache.get("self") if cache else None,
                want_cache=(mode == "prefill"))
        if c_new is not None:
            new_cache["self"] = c_new
        if hasattr(self, "ln1_post"):
            a = self.ln1_post(a)
        x = x + shard(a, "batch", "seq_act", "embed")

        if spec.cross:
            h = self.ln_cross(x)
            a, cc_new = attn_mod.attention(
                self.cross, h, cfg=cfg, mode=mode, positions=positions,
                cache=cache.get("cross") if cache else None, cur_len=cur_len,
                kv_source=enc_out, is_cross=True, rope_enabled=False)
            if cc_new is not None:
                new_cache["cross"] = cc_new
            x = x + a

        if spec.ffn is not None:
            h = shard(self.ln2(x), "batch", None, "embed")
            if spec.ffn == "moe":
                f, aux = ffn_mod.moe_apply(self.moe, h, cfg,
                                           group_size=cfg.moe_group)
                if hasattr(self, "mlp"):             # arctic dense residual
                    f = f + ffn_mod.ffn_apply(self.mlp, h, cfg)
            else:
                f = ffn_mod.ffn_apply(self.mlp, h, cfg)
            if hasattr(self, "ln2_post"):
                f = self.ln2_post(f)
            x = x + shard(f, "batch", "seq_act", "embed")

        return shard(x, "batch", "seq_act", "embed"), new_cache, aux


def _layer_cache(batch: int, max_len: int, cfg, spec: LayerSpec,
                 dtype, device) -> dict:
    c: dict = {}
    kvp = attn_mod._kv_heads(cfg)
    if spec.kind == "attn":
        c["self"] = attn_mod.init_attn_cache(batch, max_len, kvp,
                                             cfg.head_dim, dtype,
                                             device=device)
    else:
        c["self"] = mamba_mod.init_mamba_cache(batch, cfg, dtype,
                                               device=device)
    if spec.cross:
        c["cross"] = attn_mod.init_attn_cache(batch, cfg.encoder_seq, kvp,
                                              cfg.head_dim, dtype,
                                              device=device)
    return c


# ---------------------------------------------------------------------------
# Whisper-style encoder (bidirectional, stub frontend provides embeddings)
# ---------------------------------------------------------------------------

class EncoderLayer(nn.Module):
    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        dev = generator.device if generator is not None else None
        self.ln1 = Norm(cfg, dev)
        self.attn = attn_mod.attention_params(cfg, generator=generator)
        self.ln2 = Norm(cfg, dev)
        self.mlp = ffn_mod.ffn_params(cfg, generator=generator)


class Encoder(nn.Module):
    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        dev = generator.device if generator is not None else None
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, generator=generator)
            for _ in range(cfg.encoder_layers))
        self.final_norm = Norm(cfg, dev)


def _encoder_layer(lp: EncoderLayer, x: torch.Tensor, cfg) -> torch.Tensor:
    x = x + attn_mod.encoder_attention(lp.attn, lp.ln1(x), cfg=cfg)
    return x + ffn_mod.ffn_apply(lp.mlp, lp.ln2(x), cfg)


def _encode(params: Encoder, frames: torch.Tensor, cfg) -> torch.Tensor:
    x = frames.to(cfg.dtype)
    for lp in params.layers:
        if _remat(cfg, "train"):
            x = checkpoint(_under_rules(_encoder_layer), lp, x, cfg,
                           use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, cfg)
    return params.final_norm(x)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The LM's parameters (``embed`` (Vp, D), ``layers``, ``final_norm``,
    and where the config has them ``lm_head`` (D, Vp), ``pos_embed``
    (max_position, D) and the whisper ``encoder``), drawn from
    ``generator`` on its device.  ``generator=None`` builds an
    uninitialised skeleton on the default device (``convert`` loads the
    JAX package's weights into one)."""

    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        self.cfg = cfg
        g = generator
        dev = g.device if g is not None else None
        self.layers = nn.ModuleList(Layer(cfg, spec, generator=g)
                                    for spec in layer_plan(cfg))
        self.embed = nn.Parameter(embed_init(cfg.padded_vocab, cfg.d_model,
                                             generator=g))
        self.final_norm = Norm(cfg, dev)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init((cfg.d_model, cfg.padded_vocab), generator=g))
        self.pos_embed = nn.Parameter(embed_init(
            cfg.max_position, cfg.d_model, generator=g)) \
            if cfg.max_position else None
        self.encoder = Encoder(cfg, generator=g) if cfg.is_encdec else None

    def forward(self, batch: dict, **kw):
        return lm_apply(self, batch, self.cfg, **kw)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, dtype,
                          device=self.embed.device)


def lm_init(cfg, *, generator: torch.Generator | None = None,
            device=None) -> Transformer:
    """A :class:`Transformer` for ``cfg`` drawn from ``generator`` (None: a
    generator seeded 0 on ``device``) and moved to ``device`` (None: the
    CUDA card; raises without one)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return Transformer(cfg, generator=generator).to(dev)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None) -> list:
    """One zeroed cache entry per layer: ``{"self": AttnCache |
    MambaCache[, "cross": AttnCache]}`` (``device=None``: the card)."""
    dev = resolve_device(device)
    return [_layer_cache(batch, max_len, cfg, spec, dtype, dev)
            for spec in layer_plan(cfg)]


def lm_apply(model: Transformer, batch: dict, cfg, *, mode: str = "train",
             cache: list | None = None,
             cur_len: torch.Tensor | None = None):
    """Forward pass.

    batch: {"tokens": (B,S) int} (+"patches" (B,P,D) for vlm prefill/train,
    +"frames" (B,S_enc,D) for enc-dec).
    Returns (logits (B,S,Vp), new_cache (a list per layer) | None, aux).
    """
    dt = cfg.dtype
    tokens = batch["tokens"]
    B = tokens.shape[0]
    placed = is_placed(model.embed)
    if placed:
        _check_placeable(cfg, batch)
        x = _placed_embed(model.embed, tokens, cfg)
    else:
        emb = shard(model.embed, "vocab", "embed")
        # gather, then cast: the same values as casting the table first
        x = emb[tokens.long()].to(dt)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)

    if batch.get("patches") is not None:
        x = torch.cat([batch["patches"].to(dt), x], dim=1)

    S = x.shape[1]
    if mode == "decode":
        if cur_len is None:
            raise ValueError("decode needs cur_len")
        positions = cur_len[:, None]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    if cfg.max_position:
        pe = model.pos_embed[positions.clamp(0, cfg.max_position - 1).long()]
        x = x + pe.to(dt)

    enc_out = None
    if cfg.is_encdec and mode != "decode":   # decode: cross K/V in the cache
        enc_out = _encode(model.encoder, batch["frames"], cfg)

    x = shard(x.to(dt), "batch", "seq_act", "embed")
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    rz = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = []
    remat = _remat(cfg, mode)
    for i, layer in enumerate(model.layers):
        kw = dict(cfg=cfg, mode=mode, positions=positions,
                  cache=cache[i] if cache is not None else None,
                  cur_len=cur_len, enc_out=enc_out)
        x, nc, aux = checkpoint(_under_rules(layer), x, use_reentrant=False,
                                **kw) if remat else layer(x, **kw)
        new_cache.append(nc)
        if aux is not None:
            lb = lb + aux["lb_loss"]
            rz = rz + aux["router_z"]

    x = model.final_norm(x)
    if placed:
        logits = _placed_head(model, x, cfg)
    else:
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        logits = x @ head.to(dt)
    if cfg.final_softcap:
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    logits = shard(logits, "batch", None, "vocab")
    return (logits, new_cache if any(new_cache) else None,
            {"lb_loss": lb, "router_z": rz})


def _check_placeable(cfg, batch: dict) -> None:
    if cfg.moe_num_experts or cfg.is_encdec or cfg.max_position or \
            cfg.family == "hybrid" or batch.get("patches") is not None:
        raise NotImplementedError(
            f"{cfg.name}: the placed path covers the dense and Mamba-2 "
            f"families (MoE, the hybrid stack, whisper and llava come "
            f"later)")


def _placed_embed(embed, tokens, cfg):
    """The vocab-sharded lookup on local shards: each model shard looks
    up the tokens in its vocab slice and zeroes the rest, leaving a
    partial sum over the model axis (GSPMD's masked gather)."""
    mesh = embed.device_mesh
    e_pl = logical_placements(mesh, embed.shape, "vocab", None)
    t_pl = logical_placements(mesh, tokens.shape, "batch", None)
    x_pl = logical_placements(mesh, (*tokens.shape, cfg.d_model),
                              "batch", None, "embed")
    sharded = model_sharded(e_pl, mesh)
    r = mesh_rank(mesh, "model")
    dt = cfg.dtype

    def body(table, tok):
        v_loc = table.shape[0]
        idx = tok.long() - (r * v_loc if sharded else 0)
        mine = (idx >= 0) & (idx < v_loc)
        x = table[idx.clamp(0, v_loc - 1)].to(dt)
        if sharded:
            x = torch.where(mine[..., None], x, torch.zeros((), dtype=dt,
                                                            device=x.device))
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
        return x

    return run_local(body, mesh, [(embed, e_pl), (tokens, t_pl)],
                     partial_over_model(x_pl, mesh, sharded))


def _placed_head(model, x, cfg):
    """logits = x · head on local shards: the hidden state gathered over
    the sequence, each model shard's vocab columns (GSPMD's program)."""
    mesh = x.device_mesh
    x_pl = logical_placements(mesh, x.shape, "batch", None, "embed")
    tied = cfg.tie_embeddings
    w = model.embed if tied else model.lm_head
    w_pl = logical_placements(mesh, w.shape, *(("vocab", None) if tied
                                               else (None, "vocab")))
    out_pl = logical_placements(mesh, (*x.shape[:2], cfg.padded_vocab),
                                "batch", None, "vocab")

    def body(xl, wl):
        return xl @ (wl.T if tied else wl).to(xl.dtype)

    return run_local(body, mesh, [(x, x_pl), (w, w_pl)], out_pl)
