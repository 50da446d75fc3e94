"""gemma2-9b — dense, local/global alternating, logit softcaps, sandwich
norms, gated-gelu, tied embeddings. [arXiv:2408.00118; hf]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    d_ff=14336, vocab_size=256000,
    activation="gelu", attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global_period=2,
    sandwich_norm=True, embed_scale=True, tie_embeddings=True,
    rope_theta=1e4, optimizer="adamw",
))
