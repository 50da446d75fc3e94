"""llava-next-34b — VLM: dense LM backbone + anyres patch embeddings.
Vision tower is a STUB: input_specs() provides precomputed patch embeddings
(B, num_patches, d_model). [hf:llava-hf/llava-v1.6]  Heads pad 56→64."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    activation="silu", rope_theta=5e6,
    frontend="vision", num_patches=2880, padded_num_heads=64,
    optimizer="adafactor",
))
