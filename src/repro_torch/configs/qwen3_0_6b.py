"""qwen3-0.6b [dense]: qk_norm, GQA.  28L d_model=1024 16H (kv=8)
d_ff=3072 vocab=151936  [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,          # qwen3 uses head_dim 128 (> d_model/heads)
    qk_norm=True,
    rope_theta=1e6,
))
