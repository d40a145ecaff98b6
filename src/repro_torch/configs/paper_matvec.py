"""paper-matvec: the paper's own exemplar job (Fig. 2) -- coded A @ X.

An (M x D) matrix splits into k row-blocks, MDS-encodes into n coded
tasks, and the job completes when any k workers finish.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MatVecConfig:
    name: str = "paper-matvec"
    rows: int = 12288          # M: one CU = rows/n rows
    cols: int = 8192           # D
    n_workers: int = 12        # the paper's n
    dtype: str = "float32"


CONFIG = MatVecConfig()
