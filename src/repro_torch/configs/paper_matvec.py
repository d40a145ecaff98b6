"""paper-matvec: the paper's own exemplar job (Fig. 2) -- coded A @ X.

An (M x D) matrix splits into k row-blocks, MDS-encodes into n coded
tasks, and the job completes when any k workers finish.  A tiny
LM-shaped placeholder is registered under the same name, as the JAX
package registers it, so that ``--arch paper-matvec`` resolves.
"""
import dataclasses

from .base import ModelConfig, register


@dataclasses.dataclass(frozen=True)
class MatVecConfig:
    name: str = "paper-matvec"
    rows: int = 12288          # M: one CU = rows/n rows
    cols: int = 8192           # D
    n_workers: int = 12        # the paper's n
    dtype: str = "float32"


CONFIG = MatVecConfig()

# the LM-shaped placeholder of the same name
register(ModelConfig(
    name="paper-matvec",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=1024,
))
