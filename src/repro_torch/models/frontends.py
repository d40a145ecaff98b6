"""Modality frontend stubs for the audio and vlm architectures (a port of
the JAX package's ``models/frontends.py``).

The transformer backbone is the architecture; the frontend (wav2vec-style
conv feature extractor for hubert, InternViT for internvl2) is replaced by
precomputed frame / patch embeddings: the model takes (B, S, d_model)
embedding tensors, and these helpers make deterministic synthetic ones
from a seeded ``torch.Generator``, on its device unless ``device`` is
given.  The laws are the reference's; the numbers are not (``jax.random``
and ``torch.Generator`` draw different streams from one seed).
"""
from __future__ import annotations

import math

import torch

from .._device import target
from ..configs.base import ModelConfig
from .params import dtype_of


def _normal(cfg: ModelConfig, generator: torch.Generator, batch: int,
            seq: int, device) -> torch.Tensor:
    return torch.randn((batch, seq, cfg.d_model), generator=generator,
                       dtype=torch.float32, device=target(generator, device))


def synthetic_frame_embeddings(cfg: ModelConfig, generator: torch.Generator,
                               batch: int, seq: int,
                               dtype: str = "bfloat16",
                               device=None) -> torch.Tensor:
    """Stand-in for a 20 ms-hop audio feature extractor's output: N(0, 1)
    / sqrt(d_model), (batch, seq, d_model) in ``dtype``."""
    x = _normal(cfg, generator, batch, seq, device)
    return (x / math.sqrt(cfg.d_model)).to(dtype_of(dtype))


def synthetic_patch_embeddings(cfg: ModelConfig, generator: torch.Generator,
                               batch: int, seq: int,
                               dtype: str = "bfloat16",
                               device=None) -> torch.Tensor:
    """Stand-in for InternViT patch embeddings projected to the LM width:
    0.02 N(0, 1), (batch, seq, d_model) in ``dtype``."""
    x = _normal(cfg, generator, batch, seq, device)
    return (0.02 * x).to(dtype_of(dtype))


def synthetic_embeddings(cfg: ModelConfig, generator: torch.Generator,
                         batch: int, seq: int, dtype: str = "bfloat16",
                         device=None) -> torch.Tensor:
    """``cfg``'s stand-in inputs: frames for the audio family (hubert),
    patches for the others (internvl2)."""
    make = (synthetic_frame_embeddings if cfg.family == "audio"
            else synthetic_patch_embeddings)
    return make(cfg, generator, batch, seq, dtype, device)
