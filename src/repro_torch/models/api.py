"""Family dispatch: one model API over the ported architectures (a port of
the JAX package's ``models/api.py``).

    init_params / param_shapes / partition_specs
    forward / train_forward / loss_fn
    init_cache / cache_shapes / cache_specs / decode_step / padded_vocab

``ssm_lm`` serves the pure-SSM family (mamba2) and the SSM +
shared-attention hybrid (zamba2); ``transformer`` serves every other
family (dense, MoE, encoder-only, the embedding-input vlm and audio), as
the reference's ``model_module`` sends them.  An embedding-input family
takes (B, S, d) embeddings (``models.frontends``) where the others take
token ids.  An encoder's decode step is the reference's: causal over the
cache, although ``applicable_shapes`` lists no decode cell for it.
``forward`` is the body of the reference's prefill cell
(``launch/steps.py::build_prefill_cell``) and takes no gradient;
``train_forward`` and ``loss_fn`` are the reference's differentiable
``forward`` and ``loss_fn``; ``decode_step`` is the body of its
``serve_step``.

On a ``launch.mesh`` mesh (``mesh=`` of ``build``, ``init_params`` and
``init_cache``) a module of any family holds this rank's block of every
leaf and its forward runs the placed computation (``models.transformer``,
``models.ssm_lm``); ``placement`` gives each leaf's spec.  The
``split`` argument of ``forward``, ``train_forward`` and
``decode_step`` names the process group over which the tokens' rows are
the global batch's blocks, which an MoE's token groups need
(``models.moe``).
"""
from __future__ import annotations

from .._device import DEFAULT_DEVICE
from ..configs.base import ModelConfig
from . import ssm_lm, transformer

_SSM_FAMILIES = ("ssm", "hybrid")


def model_module(cfg: ModelConfig):
    return ssm_lm if cfg.family in _SSM_FAMILIES else transformer


def model_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s family."""
    mod = model_module(cfg)
    return mod.TransformerLM if mod is transformer else mod.Mamba2LM


def build(cfg: ModelConfig, device=DEFAULT_DEVICE, trainable: bool = False,
          mesh=None):
    """The family's module, parameters uninitialised; on ``mesh`` this
    rank's blocks (see the module doc)."""
    return model_class(cfg)(cfg, device, trainable, mesh)


def init_params(cfg: ModelConfig, generator, trainable: bool = False,
                mesh=None):
    """The family's module, parameters drawn from ``generator`` (a seeded
    ``torch.Generator``) on its device; ``trainable``: they require
    gradients.  On ``mesh`` the same global values, this rank's blocks."""
    return model_module(cfg).init_params(cfg, generator, trainable, mesh)


def placement(cfg: ModelConfig) -> dict:
    """Each leaf's spec by dotted name (``layers.wq``, ...) as the port
    places it on a mesh: ``partition_specs``'."""
    specs = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                specs[f"{prefix}{k}"] = v
    walk(partition_specs(cfg), "")
    return specs


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter pytree as ``meta`` tensors (shape and
    dtype, no storage): ``{"layers": {name: ...}, "embed": ..., ...}``."""
    tree: dict = {}
    for name, p in model_class(cfg)(cfg, device="meta").named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return tree


def partition_specs(cfg: ModelConfig, fsdp: str = "data", tp: str = "model"):
    """The reference's partition-spec tree (``launch.mesh.P`` leaves),
    congruent with ``param_shapes``."""
    return model_module(cfg).partition_specs(cfg, fsdp, tp)


def forward(cfg: ModelConfig, params, tokens, positions=None, split=None):
    """Logits (B, S, V_pad) of tokens (B, S) (embeddings (B, S, d) for an
    embedding-input family): the prefill path."""
    return model_module(cfg).forward(cfg, params, tokens, positions, split)


def train_forward(cfg: ModelConfig, params, tokens, positions=None,
                  split=None):
    """``forward`` with gradients and ``cfg.remat``: the train path."""
    return model_module(cfg).train_forward(cfg, params, tokens, positions,
                                           split)


def loss_fn(cfg: ModelConfig, params, tokens, labels):
    """Mean token cross-entropy of ``train_forward``'s logits."""
    return model_module(cfg).loss_fn(cfg, params, tokens, labels)


def token_nll(cfg: ModelConfig, params, logits, labels):
    """Per-token cross-entropy (B, S) in fp32 of ``train_forward``'s
    logits (on a mesh, of the rank's vocab columns, reduced over
    ``model``)."""
    return transformer.token_nll(cfg, params, logits, labels)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE, mesh=None):
    """A zero cache; on ``mesh`` this rank's block of it by
    ``cache_specs``."""
    return model_module(cfg).init_cache(cfg, batch, max_len, dtype, device,
                                        mesh)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: str = "bfloat16"):
    """``init_cache``'s tree as ``meta`` tensors (shape and dtype, no
    storage): the reference's ``cache_shapes``."""
    return model_module(cfg).cache_shapes(cfg, batch, max_len, dtype)


def cache_specs(cfg: ModelConfig, fsdp: str = "data", tp: str = "model"):
    """The reference's spec tree of ``init_cache``."""
    return model_module(cfg).cache_specs(cfg, fsdp, tp)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, split=None):
    """(logits (B, 1, V_pad), cache) for tokens (B, 1) (embeddings
    (B, 1, d)) at ``pos``; the cache is updated in place."""
    return model_module(cfg).decode_step(cfg, params, cache, tokens, pos,
                                         split)


def padded_vocab(cfg: ModelConfig) -> int:
    return transformer.padded_vocab(cfg)
