"""qwen3-4b — dense, GQA (32q/8kv), qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, activation="silu", rope_theta=1e6,
    optimizer="adamw",
))
