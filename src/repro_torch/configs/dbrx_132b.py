"""dbrx-132b [moe]: 16 experts top-4, fine-grained.  40L d_model=6144
48H (kv=8) d_ff=10752 vocab=100352  [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=5e5,
))
