"""dbrx-132b — fine-grained MoE, 16 experts top-4 every layer, GQA 48q/8kv.
[hf:databricks/dbrx-base]"""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe_num_experts=16, moe_top_k=4, moe_period=1,
    activation="silu", rope_theta=5e5,
    optimizer="adafactor",
))
