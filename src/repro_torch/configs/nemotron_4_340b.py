"""nemotron-4-340b — dense, GQA (96q/8kv), squared-ReLU (ungated) FFN.
[arXiv:2402.16819]  Giant: adafactor states + FSDP (DESIGN.md §4)."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    activation="squared_relu", rope_theta=1e4,
    optimizer="adafactor",
))
