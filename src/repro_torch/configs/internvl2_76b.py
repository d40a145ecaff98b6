"""internvl2-76b [vlm]: InternViT + InternLM2 backbone.  80L d_model=8192
64H (kv=8) d_ff=28672 vocab=128256  [arXiv:2404.16821; unverified].
The InternViT frontend is a stub: inputs are precomputed patch embeddings
interleaved with text embeddings, shape (B, S, d_model), made by
``models.frontends.synthetic_patch_embeddings``."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    embedding_inputs=True,   # frontend stub
    param_dtype="bfloat16",
))
