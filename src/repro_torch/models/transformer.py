"""Decoder/encoder transformer LM family, dense and MoE (a port of the JAX
package's ``models/transformer.py``).

Covers deepseek-7b, llama3-405b, qwen3-0.6b (qk_norm), yi-9b, dbrx-132b
and qwen3-moe-235b-a22b (MoE), hubert-xlarge (encoder-only, embedding
inputs) and internvl2-76b (embedding inputs).

``TransformerLM`` holds the parameters under the reference's pytree names
and shapes: ``layers.<name>`` stacked along a leading ``num_layers`` axis
(``layers.wq`` (L, d, H, hd), ...; a MoE layer's ``router`` (L, d, E) and
experts ``w_gate`` / ``w_up`` (L, E, d, f), ``w_down`` (L, E, f, d)),
``embed`` (absent when the inputs are embeddings), ``final_norm`` and
``lm_head``.  The forward pass is a loop over layers.  ``forward`` (the
prefill path) takes no gradient; ``train_forward`` is the same loop with
gradients and the config's activation rematerialisation, and ``loss_fn``
its token cross-entropy.  With ``embedding_inputs`` the model takes
(B, S, d) embeddings where the others take (B, S) token ids, and
``causal=False`` (the encoder) makes the full-sequence attention
bidirectional.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..sharding import P
from . import layers as L
from .moe import moe_ffn
from .params import StackedParams, dtype_of, parameter


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 128."""
    return (cfg.vocab_size + 127) // 128 * 128


def _layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f, nl = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    shapes = {
        "attn_norm": (nl, d),
        "wq": (nl, d, h, hd),
        "wk": (nl, d, kv, hd),
        "wv": (nl, d, kv, hd),
        "wo": (nl, h, hd, d),
        "mlp_norm": (nl, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (nl, hd)
        shapes["k_norm"] = (nl, hd)
    if cfg.num_experts:
        e = cfg.num_experts
        shapes.update(router=(nl, d, e), w_gate=(nl, e, d, f),
                      w_up=(nl, e, d, f), w_down=(nl, e, f, d))
    else:
        shapes.update(w_gate=(nl, d, f), w_up=(nl, d, f), w_down=(nl, f, d))
    return shapes


def partition_specs(cfg: ModelConfig, fsdp: str = "data",
                    tp: str = "model") -> dict:
    """The reference's ``P`` tree, congruent with ``param_shapes``: TP
    shards the head / ffn / expert / vocab axes over ``tp`` where the
    count divides 16 (the production model-axis size), FSDP a
    complementary axis over ``fsdp``; KV projections whose head count
    does not divide 16 stay replicated over ``tp``."""
    def head_spec(nheads):
        return tp if nheads % 16 == 0 else None

    specs_l = {
        "attn_norm": P(None, None),
        "wq": P(None, fsdp, head_spec(cfg.num_heads), None),
        "wk": P(None, fsdp, head_spec(cfg.num_kv_heads), None),
        "wv": P(None, fsdp, head_spec(cfg.num_kv_heads), None),
        "wo": P(None, head_spec(cfg.num_heads), None, fsdp),
        "mlp_norm": P(None, None),
    }
    if cfg.qk_norm:
        specs_l["q_norm"] = P(None, None)
        specs_l["k_norm"] = P(None, None)
    if cfg.num_experts:
        ep = tp if cfg.num_experts % 16 == 0 else None
        ffn_tp = None if ep else tp
        specs_l.update(router=P(None, fsdp, None),
                       w_gate=P(None, ep, fsdp, ffn_tp),
                       w_up=P(None, ep, fsdp, ffn_tp),
                       w_down=P(None, ep, ffn_tp, fsdp))
    else:
        specs_l.update(w_gate=P(None, fsdp, tp), w_up=P(None, fsdp, tp),
                       w_down=P(None, tp, fsdp))
    tree: dict = {"layers": specs_l}
    if not cfg.embedding_inputs:
        tree["embed"] = P(tp, fsdp)
    tree["final_norm"] = P(None)
    tree["lm_head"] = P(fsdp, tp)
    return tree


class TransformerLM(torch.nn.Module):
    """Decoder (or encoder) LM; parameters uninitialised until
    ``init_params`` or ``convert.params_to_port`` fills them.  No ``embed``
    when ``cfg.embedding_inputs``.  ``trainable``: every parameter requires
    a gradient (the training path); else none does (serving)."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE,
                 trainable: bool = False):
        super().__init__()
        device = resolve(device)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        v = padded_vocab(cfg)
        self.layers = StackedParams(_layer_shapes(cfg), dt, device, trainable)
        if not cfg.embedding_inputs:
            self.embed = parameter((v, cfg.d_model), dt, device, trainable)
        self.final_norm = parameter((cfg.d_model,), dt, device, trainable)
        self.lm_head = parameter((cfg.d_model, v), dt, device, trainable)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, positions)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                trainable: bool = False) -> TransformerLM:
    """Parameters with the reference's laws (norms 1, truncated-normal
    fan-in weights, the router and experts by their input axis, 0.02
    embedding), drawn from ``generator`` on its device."""
    model = TransformerLM(cfg, generator.device, trainable)
    for name, p in sorted(model.layers.named_parameters()):
        shape = p.shape
        if "norm" in name:
            p.fill_(1.0)
            continue
        fan_in = shape[-2] if len(shape) > 2 else shape[-1]
        if name == "wo":
            fan_in = shape[1] * shape[2]
        if name in ("wq", "wk", "wv"):
            fan_in = shape[1]
        p.copy_(L.dense_init(generator, shape, fan_in, p.dtype))
    if not cfg.embedding_inputs:
        model.embed.copy_(L.embed_init(generator, model.embed.shape,
                                       model.embed.dtype))
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(L.dense_init(generator, model.lm_head.shape,
                                     cfg.d_model, model.lm_head.dtype))
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                x: torch.Tensor, positions: torch.Tensor,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos: Optional[int] = None):
    """One attention sub-block.  With ``cache_kv`` the step's keys and
    values are first written into the cache at ``cache_pos``."""
    dtype = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)

    def proj(w):
        return (h @ w.reshape(d, -1).to(dtype)).view(b, s, w.shape[1],
                                                     w.shape[2])

    q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache_kv is not None:
        kc, vc = cache_kv
        # the reference's dynamic_update_slice, written in place into the
        # caller's cache tensors (it returns a new cache)
        kc[:, cache_pos:cache_pos + s] = k.to(kc.dtype)
        vc[:, cache_pos:cache_pos + s] = v.to(vc.dtype)
        out = L.attention(q, kc, vc, causal=True, q_offset=cache_pos,
                          block_kv=cfg.flash_block_kv,
                          kv_len=cache_pos + s)
    else:
        out = L.attention(q, k, v, causal=cfg.causal, q_offset=0,
                          block_kv=cfg.flash_block_kv)
    hh, hd = lp["wo"].shape[0], lp["wo"].shape[1]
    return out.reshape(b, s, hh * hd) @ lp["wo"].reshape(hh * hd, d).to(dtype)


def _ffn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.num_experts:
        return moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"],
                       lp["w_down"], top_k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor)
    return L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _embed(cfg: ModelConfig, params: TransformerLM,
           tokens: torch.Tensor) -> torch.Tensor:
    if cfg.embedding_inputs:
        # already (B, S, d) embeddings
        return tokens.to(dtype_of(cfg.compute_dtype))
    # gather, then cast: bit for bit the reference's cast-then-gather,
    # without casting the whole table on every call
    return params.embed[tokens].to(dtype_of(cfg.compute_dtype))


def _unembed(cfg: ModelConfig, params: TransformerLM,
             x: torch.Tensor) -> torch.Tensor:
    dtype = dtype_of(cfg.compute_dtype)
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return h @ params.lm_head.to(dtype)


def _layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = x + _attn_block(cfg, lp, x, positions)
    return x + _ffn_block(cfg, lp, x)


def _forward(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: str) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    for lp in params.layers.unbind():
        x = L.remat_call(remat, _layer, cfg, lp, x, positions)
    return _unembed(cfg, params, x)


@torch.no_grad()
def forward(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward of tokens (B, S) (or embeddings (B, S, d))
    -> logits (B, S, V_pad).  Prefill path: one flash-attention launch per
    layer on the card, causal or not as ``cfg.causal``, no gradient."""
    return _forward(cfg, params, tokens, positions, remat="none")


def train_forward(cfg: ModelConfig, params: TransformerLM,
                  tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``forward`` with gradients: the reference's train path.

    ``cfg.remat`` (``layers.remat_call``, per layer): ``"full"``
    recomputes each layer in the backward (the reference's
    ``jax.checkpoint`` of the scan body); ``"dots"`` saves the
    projections' outputs and recomputes the rest; under either a layer's
    flash kernel launches twice a step.  ``"none"`` keeps every
    activation.
    """
    return _forward(cfg, params, tokens, positions, cfg.remat)


def loss_fn(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``train_forward``'s logits (the padded
    vocab tail never appears in labels)."""
    return L.cross_entropy_loss(train_forward(cfg, params, tokens), labels)


# --------------------------------------------------------------------------
# KV-cache serving path
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE):
    """Stacked KV cache: a pair of zero (L, B, S_max, KV, hd) tensors (two
    tensors, since decode writes them in place)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt, device = dtype_of(dtype), resolve(device)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: str = "bfloat16"):
    """``init_cache``'s pair as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def cache_specs(cfg: ModelConfig, fsdp: str = "data", tp: str = "model"):
    """KV-cache specs (L, B, S, KV, hd): the batch over ``fsdp``; the KV
    heads over ``tp`` when their count divides 16, else the head dim."""
    if cfg.num_kv_heads % 16 == 0:
        spec = P(None, fsdp, None, tp, None)
    else:
        spec = P(None, fsdp, None, None, tp)
    return (spec, spec)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, cache,
                tokens: torch.Tensor, pos: int):
    """One autoregressive step: tokens (B, 1) (or embeddings (B, 1, d)) at
    position ``pos``.  Returns (logits (B, 1, V), cache), the cache updated
    in place.  Attention over the cache is causal for every family, the
    encoders' too, as in the reference (``applicable_shapes`` lists no
    decode cell for an encoder)."""
    pos = int(pos)
    x = _embed(cfg, params, tokens)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    kc_all, vc_all = cache
    for i in range(cfg.num_layers):
        lp = params.layers.layer(i)
        x = x + _attn_block(cfg, lp, x, positions,
                            cache_kv=(kc_all[i], vc_all[i]), cache_pos=pos)
        x = x + _ffn_block(cfg, lp, x)
    return _unembed(cfg, params, x), cache
