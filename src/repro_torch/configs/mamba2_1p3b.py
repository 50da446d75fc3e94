"""mamba2-1.3b — attention-free SSM (SSD). [arXiv:2405.21060]
48L, d_model 2048, d_inner 4096, 64 heads of 64, state 128."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    head_dim=1,  # unused (attention-free)
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    optimizer="adamw",
))
