"""Architecture config schema and registry (a copy of the JAX package's
``configs/base.py``; the fields and their defaults are the same).

Every architecture of the JAX package has a config module here with the
same values: the dense, MoE, SSM, hybrid and embedding-input (vlm, audio)
families, and the paper's coded mat-vec job with its LM-shaped
placeholder.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

_REGISTRY: dict = {}

ARCH_IDS = [
    "zamba2-1.2b",
    "deepseek-7b",
    "llama3-405b",
    "qwen3-0.6b",
    "yi-9b",
    "dbrx-132b",
    "qwen3-moe-235b-a22b",
    "mamba2-1.3b",
    "hubert-xlarge",
    "internvl2-76b",
    "paper-matvec",  # the paper's own coded mat-vec job (Fig. 2 exemplar)
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (exact public config)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False
    causal: bool = True
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid: one shared attention block applied every `attn_every` ssm layers
    attn_every: int = 0
    # sliding-window attention size (0 = full attention)
    attn_window: int = 0
    # frontend stub: inputs are precomputed embeddings instead of token ids
    embedding_inputs: bool = False
    # numerics
    param_dtype: str = "float32"     # checkpointed master dtype
    compute_dtype: str = "bfloat16"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    remat: str = "full"              # none | full | dots (training only)
    # attention implementation name and flash block sizes; the port's
    # full-sequence attention is always its flash kernel, and only the
    # blockwise decode path (kv_len) reads flash_block_kv
    attn_impl: str = "flash"
    flash_block_q: int = 512
    flash_block_kv: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """Look up an architecture config by id, importing its module on demand."""
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Shape cells that are well-defined for this architecture: long_500k
    only for sub-quadratic archs (ssm/hybrid); no decode shapes for
    encoder-only models."""
    names = ["train_4k", "prefill_32k"]
    if cfg.family not in ("encoder", "audio"):
        names.append("decode_32k")
        if cfg.family in ("ssm", "hybrid"):
            names.append("long_500k")
    return tuple(names)
