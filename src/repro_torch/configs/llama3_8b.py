"""llama3-8b — dense, GQA (32q/8kv), 128k vocab. [arXiv:2407.21783]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    activation="silu", rope_theta=5e5,
    optimizer="adamw",
))
