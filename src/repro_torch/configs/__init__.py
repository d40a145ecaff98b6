"""Configurations the port runs: the paper's coded mat-vec job, and the
model zoo's serving configs (``get_config("qwen3-0.6b")``,
``get_config("mamba2-1.3b")``)."""
from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                   applicable_shapes, get_config, register)
from .paper_matvec import CONFIG, MatVecConfig

__all__ = ["ARCH_IDS", "CONFIG", "MatVecConfig", "ModelConfig", "SHAPES",
           "ShapeConfig", "applicable_shapes", "get_config", "register"]
