"""Mamba2 LM, pure SSM (a port of the pure-SSM branch of the JAX
package's ``models/ssm_lm.py``, serving path).

``Mamba2LM`` holds ``embed``, ``layers.<name>`` stacked along a leading
``num_layers`` axis (``layers.A_log`` (L, H), ...), ``final_norm`` and
``lm_head``.  The Zamba2-style hybrid (``attn_every > 0``) and training
(``train_forward``, ``loss_fn``) are ROADMAP Queue 1 items (zamba2 +
sliding window; mamba2 training through the ssd path) and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from . import layers as L
from . import mamba2 as M
from .params import StackedParams, dtype_of, parameter
from .transformer import padded_vocab


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_every > 0:
        raise NotImplementedError(
            f"{cfg.name}: the SSM + shared-attention hybrid is not ported "
            f"yet (ROADMAP Queue 1, zamba2 + sliding window)")


class Mamba2LM(torch.nn.Module):
    """Pure-SSM LM; parameters uninitialised until ``init_params`` or
    ``convert.params_to_port`` fills them.  ``trainable``: every parameter
    requires a gradient (though ``train_forward`` raises until the SSM
    family's training is ported)."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE,
                 trainable: bool = False):
        super().__init__()
        _check_supported(cfg)
        device = resolve(device)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        v = padded_vocab(cfg)
        self.embed = parameter((v, cfg.d_model), dt, device, trainable)
        self.layers = StackedParams(M.layer_shapes(cfg, cfg.num_layers), dt,
                                    device, trainable)
        self.final_norm = parameter((cfg.d_model,), dt, device, trainable)
        self.lm_head = parameter((cfg.d_model, v), dt, device, trainable)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, positions)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                trainable: bool = False) -> Mamba2LM:
    """Parameters with the reference's laws, drawn from ``generator`` on its
    device."""
    model = Mamba2LM(cfg, generator.device, trainable)
    model.embed.copy_(L.embed_init(generator, model.embed.shape,
                                   model.embed.dtype))
    M.init_layer_params(dict(model.layers.named_parameters()), generator)
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(L.dense_init(generator, model.lm_head.shape,
                                     cfg.d_model, model.lm_head.dtype))
    return model


def _logits(cfg: ModelConfig, params: Mamba2LM,
            x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return h @ params.lm_head.to(dtype_of(cfg.compute_dtype))


@torch.no_grad()
def forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad).  Prefill path: one
    ``ssd_scan`` launch per layer on the card.  ``positions`` is unused (an
    SSM has no position embedding); it keeps the family API uniform."""
    x = params.embed[tokens].to(dtype_of(cfg.compute_dtype))
    for i in range(cfg.num_layers):
        x = x + M.mamba2_block(cfg, params.layers.layer(i), x)
    return _logits(cfg, params, x)


def train_forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    raise NotImplementedError(
        f"{cfg.name}: training the SSM family (ssd_scan has no backward "
        f"yet) is a ROADMAP Queue 1 item (mamba2 training through the ssd "
        f"path)")


def loss_fn(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    return train_forward(cfg, params, tokens)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Zero decode state.  ``max_len`` and ``dtype`` are unused by the pure
    SSM (its state is O(1) in length, the conv tails in the compute dtype
    and h in fp32); they keep the family API uniform."""
    return {"ssm": M.init_block_state(cfg, cfg.num_layers, batch, device)}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Mamba2LM, cache: Dict[str, Any],
                tokens: torch.Tensor, pos: int):
    """One token for the whole stack.  tokens (B, 1).  Returns
    (logits (B, 1, V), cache), the cache's tensors updated in place."""
    x = params.embed[tokens].to(dtype_of(cfg.compute_dtype))
    st = cache["ssm"]
    for i in range(cfg.num_layers):
        out, new = M.mamba2_block_decode(
            cfg, params.layers.layer(i), x,
            {name: t[i] for name, t in st.items()})
        for name, t in new.items():
            st[name][i] = t
        x = x + out
    return _logits(cfg, params, x), cache
