"""Architecture + run configuration dataclasses.

One :class:`ArchConfig` instance fully determines a model; the 10 assigned
architectures live in sibling modules (``qwen3_4b.py`` …) and register
themselves in ``configs.registry``.  ``reduced()`` derives the CPU-smoke
variant of any config (same family/feature flags, tiny dims).

Field for field the dataclasses of ``repro.configs.base``, followed by the
port's own fields (:data:`PORT_FIELDS`: a per-layer pattern, grouped Mamba
heads, attention without rotary embedding, the sigmoid router's dropless
held-expert MoE with a shared expert), which every architecture of the JAX
package leaves at their defaults; ``dtype`` is the compute dtype as a
``torch.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced", "PORT_FIELDS",
           "PATTERN_KINDS"]

# a pattern's letters: a block of one Mamba-2 mixer, one MoE or one
# attention mixer (Nemotron-H's ``hybrid_override_pattern``)
PATTERN_KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|ssm|hybrid|moe|audio|vlm|snn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 ⇒ d_model // num_heads

    # attention features
    qk_norm: bool = False                  # qwen3
    attn_softcap: float | None = None      # gemma2 (50.0)
    final_softcap: float | None = None     # gemma2 (30.0)
    sliding_window: int | None = None      # gemma2 local layers (4096)
    local_global_period: int = 0           # gemma2: 2 ⇒ alternate local/global
    rope_theta: float = 1e4
    activation: str = "silu"
    norm_type: str = "rmsnorm"             # rmsnorm|layernorm
    tie_embeddings: bool = False
    sandwich_norm: bool = False            # gemma2: post-block norms
    embed_scale: bool = False              # gemma2: ×sqrt(d_model)
    max_position: int = 0                  # >0 ⇒ learned pos-emb, no RoPE

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_period: int = 1                    # every k-th layer is MoE (jamba: 2)
    moe_dense_residual: bool = False       # arctic: dense FFN in parallel
    dense_residual_ff: int = 0             # arctic: width of the dense branch
    moe_capacity_factor: float = 1.25
    moe_group: int = 1024                  # dispatch group size (memory knob)

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0             # jamba: 8 ⇒ 1 attn per 8 layers
    attn_layer_offset: int = 4             # position of attn inside the block

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                   # frames after conv frontend (stub)

    # frontend stubs
    frontend: str | None = None            # None|"audio"|"vision"
    num_patches: int = 0                   # vision stub: patches per image

    # numerics / memory plan
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"               # adamw|adafactor (giant archs)
    remat: bool = True
    scan_layers: bool = True

    # padding for TP divisibility (0 ⇒ num_heads); see DESIGN.md §8
    padded_num_heads: int = 0

    # ---- the port's own fields (PORT_FIELDS); JAX's archs keep defaults
    # per-layer pattern: layer i is one pre-norm block of kind
    # PATTERN_KINDS[layer_pattern[i]] ("" ⇒ the family's plan)
    layer_pattern: str = ""
    ssm_num_heads: int = 0                 # >0 ⇒ d_inner = heads·head_dim
    ssm_groups: int = 1                    # B/C groups; the gated norm's too
    use_rope: bool = True                  # False: attention with no RoPE
    # recompute each query chunk's scores in the backward and stop its
    # keys at its last query (long causal sequences)
    attn_chunk_remat: bool = False
    # "softmax": top-k of the softmax, capacity dispatch; "sigmoid": the
    # sigmoid router with a correction bias, dropless held-expert dispatch
    moe_router: str = "softmax"
    moe_routed_scale: float = 1.0          # routed weights × this (sigmoid)
    moe_shared_ff: int = 0                 # >0 ⇒ a shared expert this wide
    moe_experts_held: int = 0              # experts this chip holds (0: all)
    moe_expert_offset: int = 0             # the first of them

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.padded_num_heads == 0:
            object.__setattr__(self, "padded_num_heads", self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 for clean TP sharding."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def d_inner(self) -> int:               # mamba inner width
        if self.ssm_num_heads:
            return self.ssm_num_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def experts_held(self) -> int:
        """Experts whose weights this model holds (of ``moe_num_experts``
        routed over)."""
        return self.moe_experts_held or self.moe_num_experts

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = V * d                                     # embed
        if not self.tie_embeddings:
            total += V * d                                # lm head

        def attn_params():
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        n_mats = 3 if self.activation in ("silu", "gelu") else 2

        def dense_ffn(ff=None):
            return n_mats * d * (ff or self.d_ff)

        def moe_ffn():
            per = n_mats * d * self.d_ff
            return (self.experts_held * per + d * self.moe_num_experts
                    + n_mats * d * self.moe_shared_ff)   # shared expert

        def mamba_params():
            di, H = self.d_inner, self.ssm_heads
            N = self.ssm_state * self.ssm_groups    # B/C widths
            return (d * (2 * di + 2 * N + H)   # wz,wx,wb,wc,wdt projections
                    + self.ssm_conv * (di + 2 * N)
                    + di * d + 3 * H + di)     # out_proj, A/D/dt_bias, norm

        block = {"mamba": mamba_params, "attn": attn_params, "moe": moe_ffn}
        for c in self.layer_pattern[:L]:       # one norm and one mixer
            total += d + block[PATTERN_KINDS[c]]()
        for i in range(0 if self.layer_pattern else L):
            is_attn = True
            if self.attn_layer_period:
                is_attn = (i % self.attn_layer_period) == self.attn_layer_offset
            if self.family == "ssm":
                is_attn = False
            total += attn_params() if is_attn else mamba_params()
            if self.family == "ssm":
                continue                       # mamba2: no separate FFN
            is_moe = self.moe_num_experts > 0 and (i % self.moe_period == self.moe_period - 1)
            total += moe_ffn() if is_moe else dense_ffn()
            if is_moe and self.moe_dense_residual:
                total += dense_ffn(self.dense_residual_ff or self.d_ff)
            total += 2 * d                     # norms
        total += d                             # final norm
        if self.is_encdec:
            # encoder layers: self-attn + ffn (+ cross-attn already in dec L)
            total += self.encoder_layers * (attn_params() + dense_ffn() + 2 * d)
            total += self.num_layers * attn_params()   # decoder cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts only top-k experts."""
        if self.moe_num_experts == 0:
            return self.param_count()
        full = self.param_count()
        per_expert = (3 if self.activation in ("silu", "gelu") else 2) \
            * self.d_model * self.d_ff
        if self.layer_pattern:
            n_moe_layers = self.layer_pattern[:self.num_layers].count("E")
        else:
            n_moe_layers = sum(
                1 for i in range(self.num_layers)
                if (i % self.moe_period == self.moe_period - 1))
        # a token passes through top_k of the E experts routed over: of
        # the ones held here, top_k · held / E on average
        e, held = self.moe_num_experts, self.experts_held
        inactive = n_moe_layers * per_expert \
            * (held * e - self.moe_top_k * held) // e
        return int(full - inactive)


# the fields the JAX package's ArchConfig lacks, in their order
PORT_FIELDS = ("layer_pattern", "ssm_num_heads", "ssm_groups", "use_rope",
               "attn_chunk_remat", "moe_router", "moe_routed_scale",
               "moe_shared_ff", "moe_experts_held", "moe_expert_offset")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train|prefill|decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ArchConfig:
    """CPU-smoke variant: same family & feature flags, tiny dims."""
    heads = max(1, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    if cfg.layer_pattern:       # the pattern's prefix holding every kind
        layers = max(layers, 1 + max(cfg.layer_pattern.index(c)
                                     for c in set(cfg.layer_pattern)))
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=max(layers, cfg.attn_layer_period or layers),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=d_model * 2,
        vocab_size=vocab,
        padded_num_heads=heads,
        compute_dtype="float32",
    )
    if cfg.moe_num_experts:
        kw["moe_num_experts"] = min(cfg.moe_num_experts, 4)
        kw["moe_top_k"] = min(cfg.moe_top_k, 2)
        kw["moe_group"] = 16
        # no capacity drops at smoke scale: keeps decode == prefill exact
        kw["moe_capacity_factor"] = 8.0
        if cfg.moe_dense_residual:
            kw["dense_residual_ff"] = d_model
    if cfg.moe_shared_ff:
        kw["moe_shared_ff"] = d_model * 2
    if cfg.moe_experts_held:
        kw["moe_experts_held"] = kw["moe_num_experts"]
        kw["moe_expert_offset"] = 0
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 8
    if cfg.ssm_num_heads:       # d_inner from expand · d_model again
        kw["ssm_num_heads"] = 0
        kw["ssm_groups"] = min(cfg.ssm_groups, 2)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if cfg.max_position:
        kw["max_position"] = 256
    if cfg.num_patches:
        kw["num_patches"] = 8
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    return replace(cfg, **kw)
