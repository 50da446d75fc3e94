"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every other
layer. [arXiv:2403.19887; hf]  8-layer block: attn at offset 4, rest mamba;
odd layers MoE."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    moe_num_experts=16, moe_top_k=2, moe_period=2,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    attn_layer_period=8, attn_layer_offset=4,
    optimizer="adafactor",
))
