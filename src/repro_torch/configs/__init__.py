"""Configurations the port runs: the paper's coded mat-vec job."""
from .paper_matvec import CONFIG, MatVecConfig

__all__ = ["CONFIG", "MatVecConfig"]
