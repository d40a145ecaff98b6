"""Family dispatch: one model API over the ported architectures (a port of
the JAX package's ``models/api.py``, serving path).

    init_params / forward / init_cache / decode_step / padded_vocab

``transformer`` serves the dense family, ``ssm_lm`` the pure-SSM family.
The other families (MoE, hybrid, encoder, vlm, audio) come with the
training slice and raise here.  ``forward`` is the body of the reference's
prefill cell (``launch/steps.py::build_prefill_cell``) and ``decode_step``
the body of its ``serve_step``.
"""
from __future__ import annotations

from .._device import DEFAULT_DEVICE
from ..configs.base import ModelConfig
from . import ssm_lm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm_lm}


def model_module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} comes with the training slice "
            f"(ROADMAP Queue 1 slice 5); ported: {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def model_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s family."""
    mod = model_module(cfg)
    return mod.TransformerLM if mod is transformer else mod.Mamba2LM


def init_params(cfg: ModelConfig, generator):
    """The family's module, parameters drawn from ``generator`` (a seeded
    ``torch.Generator``) on its device."""
    return model_module(cfg).init_params(cfg, generator)


def forward(cfg: ModelConfig, params, tokens, positions=None):
    """Logits (B, S, V_pad) of tokens (B, S): the prefill path."""
    return model_module(cfg).forward(cfg, params, tokens, positions)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE):
    return model_module(cfg).init_cache(cfg, batch, max_len, dtype, device)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """(logits (B, 1, V_pad), cache) for tokens (B, 1) at ``pos``; the
    cache is updated in place."""
    return model_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def padded_vocab(cfg: ModelConfig) -> int:
    return transformer.padded_vocab(cfg)
