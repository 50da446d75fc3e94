"""whisper-small — encoder-decoder audio transformer, MHA (12 heads),
learned positions, layernorm.  Conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, 768). [arXiv:2212.04356]
Q/KV heads pad 12→16 for TP (DESIGN.md §8)."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500,
    norm_type="layernorm", activation="gelu", max_position=32768,
    frontend="audio", padded_num_heads=16,
    optimizer="adamw",
))
