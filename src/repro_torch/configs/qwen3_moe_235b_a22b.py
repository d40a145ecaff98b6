"""qwen3-moe-235b-a22b [moe]: 128 experts top-8.  94L d_model=4096
64H (kv=4) d_ff=1536 vocab=151936  [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
))
