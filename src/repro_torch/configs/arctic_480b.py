"""arctic-480b — 128 experts top-2 + dense residual branch, GQA 56q/8kv.
[hf:Snowflake/snowflake-arctic-base; hf]  Heads pad 56→64 for TP."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    moe_num_experts=128, moe_top_k=2, moe_period=1,
    moe_dense_residual=True, dense_residual_ff=7168 * 2,
    activation="silu", padded_num_heads=64,
    optimizer="adafactor",
))
