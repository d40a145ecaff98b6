"""llama3-405b [dense]: GQA, 128k vocab.  126L d_model=16384 128H (kv=8)
d_ff=53248 vocab=128256  [arXiv:2407.21783; unverified].

Parameters are kept in a bf16 master dtype at this scale, as the JAX
package's config keeps them (fp32 masters and Adam moments for 405 B
parameters fill no single host or card).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    param_dtype="bfloat16",
))
