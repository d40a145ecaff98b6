"""Configurations the port runs: the paper's coded mat-vec job, and the
model zoo's configs by id (``get_config("qwen3-0.6b")``; every id of
``ARCH_IDS`` is served, and the dense, SSM and hybrid families are also
trained by ``launch.train``)."""
from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                   applicable_shapes, get_config, register)
from .paper_matvec import CONFIG, MatVecConfig

__all__ = ["ARCH_IDS", "CONFIG", "MatVecConfig", "ModelConfig", "SHAPES",
           "ShapeConfig", "applicable_shapes", "get_config", "register"]
