"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  The single shared attention+MLP block is applied
after every 6th mamba layer (6 sites over 38 layers); it runs
sliding-window attention over 4096 keys (ring-buffer cache in decode).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    attn_window=4096,
))
