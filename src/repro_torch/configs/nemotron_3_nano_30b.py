"""nemotron-3-nano-30b-a3b — hybrid Mamba-2 / MoE / GQA (``nemotron_h``).
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]  52 pre-norm blocks after
``hybrid_override_pattern``: 23 Mamba-2 (M: 64 heads of 64 in 8 B/C groups,
state 128), 23 MoE (E: 128 relu² experts of 1,856, 6 a token by a sigmoid
router with a correction bias, weights renormalised × 2.5, one shared
relu² expert of 3,712) and 6 GQA attention mixers (*: 32 q / 2 kv heads of
128, no rotary embedding).  Untied head over 131,072 ids.  The port's
only: the JAX package has no such architecture."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="nemotron-3-nano-30b-a3b", family="hybrid",
    num_layers=52, d_model=2688, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=1856, vocab_size=131072, activation="squared_relu",
    moe_num_experts=128, moe_top_k=6,
    ssm_state=128, ssm_head_dim=64, ssm_conv=4, ssm_chunk=128,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    ssm_num_heads=64, ssm_groups=8, use_rope=False, attn_chunk_remat=True,
    moe_router="sigmoid", moe_routed_scale=2.5, moe_shared_ff=3712,
    optimizer="adamw",
))
