"""hubert-xlarge [audio]: encoder-only transformer backbone (w2v2 arch).
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504  [arXiv:2106.07447;
unverified].  The conv feature-extractor frontend is a stub: inputs are
precomputed 20 ms frame embeddings (B, S, d_model), made by
``models.frontends.synthetic_frame_embeddings``."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,            # encoder-only: bidirectional attention
    embedding_inputs=True,   # frontend stub
))
