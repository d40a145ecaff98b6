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

On a ``launch.mesh`` mesh (``mesh=``) a module holds this rank's block of
every leaf, by ``partition_specs`` (GSPMD's placement of the
reference's), and its forward inserts the collectives GSPMD would
(``parallel``): each layer gathers its ``data``-sharded leaves inside the
function that ``layers.remat_call`` wraps (FSDP: the backward gathers
them again and reduce-scatters their gradients); the attention runs on
the rank's query heads and the KV heads they read, ``wo`` row-parallel
then a reduce over ``model`` (heads over ``model`` where H % 16 == 0;
else every rank computes the whole block); the FFN is column- then
row-parallel, an MoE on the rank's experts (E % 16 == 0) or FFN columns;
the embedding is vocab-parallel and the logits are the rank's vocab
columns, whose cross-entropy reduces over ``model``.  A leaf replicated
over ``model`` but used inside the sharded region (``q_norm``,
``k_norm``, ``wk`` / ``wv`` where KV % 16 != 0, the router) enters it
through ``parallel.copy_to_model``, so its gradient is summed there.  The
decode cache is the rank's block of ``cache_specs``: where it shards the
head dim, the scores are partial sums over it, all-reduced over
``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .. import parallel
from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..sharding import P, local_block
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


def _global_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's global shape by dotted name (``layers.wq``, ...)."""
    v, d = padded_vocab(cfg), cfg.d_model
    shapes = {f"layers.{n}": s for n, s in _layer_shapes(cfg).items()}
    if not cfg.embedding_inputs:
        shapes["embed"] = (v, d)
    shapes.update(final_norm=(d,), lm_head=(d, v))
    return shapes


def _flat_specs(cfg: ModelConfig) -> Dict[str, P]:
    tree = partition_specs(cfg)
    out = {f"layers.{n}": s for n, s in tree.pop("layers").items()}
    out.update(tree)
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a placed module's computation splits over its mesh: the
    ``data`` and ``model`` groups (None for one rank), the model axis's
    size ``m`` and this rank's index ``r`` on it, which axes the attention
    splits, this rank's query heads, the KV heads they read, its experts,
    the first vocab row of its block, each layer leaf's spec without the
    layer axis, and the leaves that enter the model-sharded region
    replicated (``copy_to_model``)."""
    data: Any
    model: Any
    m: int
    r: int
    heads: bool                  # query heads (and wo's rows) over model
    kv_heads: bool               # KV heads over model (KV % 16 == 0);
                                 # else, with m > 1, the cache's head dim
    q_heads: slice               # this rank's query heads (global)
    kv_read: Union[slice, list]  # the KV heads they read, in order
    experts: Optional[slice]     # this rank's experts (expert parallel)
    vocab_lo: int
    specs: Dict[str, P]
    partial: frozenset

    def __deepcopy__(self, memo):
        return self                 # it names process groups


def _kv_read(lo: int, hi: int, n_rep: int) -> Union[slice, list]:
    """The KV heads that query heads [lo, hi) read (head h reads h //
    n_rep): a slice where every one of them serves the same number of
    those query heads, so that the kernel's pairing (query head j with KV
    head j // (Hl / KVl)) holds; else one KV head per query head."""
    per_q = [h // n_rep for h in range(lo, hi)]
    first, last = per_q[0], per_q[-1]
    kv = last - first + 1
    if len(per_q) % kv == 0 and all(
            per_q[j] == first + j // (len(per_q) // kv)
            for j in range(len(per_q))):
        return slice(first, last + 1)
    return per_q


def layout(cfg: ModelConfig, mesh,
           layer_specs: Optional[Dict[str, P]] = None) -> Optional[Layout]:
    """The ``Layout`` of ``cfg`` on ``mesh`` (None without a mesh).
    ``layer_specs``: the specs of the leaves a layer's computation takes,
    without a layer axis, where they are not this family's stacked layers
    (the hybrid's shared block, ``models.ssm_lm``); a config without
    attention heads has an empty attention layout."""
    if mesh is None:
        return None
    sizes = mesh.sizes
    m = sizes.get("model", 1)
    coord = dict(zip(mesh.axis_names, mesh.coordinate()))
    r = coord.get("model", 0)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    heads = m > 1 and h > 0 and h % 16 == 0
    kv_heads = m > 1 and kv > 0 and kv % 16 == 0
    q_heads = slice(r * h // m, (r + 1) * h // m) if heads else slice(0, h)
    if kv_heads or not h:
        kv_read: Union[slice, list] = slice(r * kv // m, (r + 1) * kv // m)
    else:
        kv_read = _kv_read(q_heads.start, q_heads.stop, h // kv)
    experts = None
    if cfg.num_experts and m > 1 and cfg.num_experts % 16 == 0:
        e = cfg.num_experts
        experts = slice(r * e // m, (r + 1) * e // m)
    partial = set()
    if heads:
        partial |= {"q_norm", "k_norm"} if cfg.qk_norm else set()
        partial |= set() if kv_heads else {"wk", "wv"}
    if cfg.num_experts and m > 1:
        partial.add("router")
    specs = _flat_specs(cfg)
    v_rows = local_block(mesh, specs["lm_head"], (cfg.d_model,
                                                  padded_vocab(cfg)))[1]
    if layer_specs is None:
        layer_specs = {n[len("layers."):]: P(*s[1:])
                       for n, s in specs.items() if n.startswith("layers.")}
    return Layout(
        data=mesh.group("data") if "data" in sizes else None,
        model=mesh.group("model") if "model" in sizes else None,
        m=m, r=r, heads=heads, kv_heads=kv_heads, q_heads=q_heads,
        kv_read=kv_read,
        experts=experts, vocab_lo=v_rows.start, specs=dict(layer_specs),
        partial=frozenset(partial))


class TransformerLM(torch.nn.Module):
    """Decoder (or encoder) LM; parameters uninitialised until
    ``init_params`` or ``convert.params_to_port`` fills them.  No ``embed``
    when ``cfg.embedding_inputs``.  ``trainable``: every parameter requires
    a gradient (the training path); else none does (serving).  ``mesh``:
    each parameter is this rank's block of its leaf (``partition_specs``),
    on the mesh's device."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE,
                 trainable: bool = False, mesh=None):
        super().__init__()
        device = resolve(device)
        if mesh is not None and device.type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.layout = layout(cfg, mesh)
        specs = _flat_specs(cfg) if mesh is not None else {}
        shapes = _global_shapes(cfg)
        dt = dtype_of(cfg.param_dtype)
        self.layers = StackedParams(
            _layer_shapes(cfg), dt, device, trainable,
            {n: specs[f"layers.{n}"] for n in _layer_shapes(cfg)}
            if specs else None, mesh)
        for name in ("embed", "final_norm", "lm_head"):
            if name in shapes:
                setattr(self, name, parameter(shapes[name], dt, device,
                                              trainable, specs.get(name),
                                              mesh))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, positions)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                trainable: bool = False, mesh=None) -> TransformerLM:
    """Parameters with the reference's laws (norms 1, truncated-normal
    fan-in weights, the router and experts by their input axis, 0.02
    embedding), drawn from ``generator`` on its device.  On a mesh each
    leaf is drawn whole, as on one device, and the rank keeps its block:
    the same global values on any mesh."""
    model = TransformerLM(cfg, generator.device, trainable, mesh)
    specs = _flat_specs(cfg)
    shapes = _global_shapes(cfg)

    def keep(name: str, p: torch.Tensor, value: torch.Tensor) -> None:
        p.copy_(value[local_block(mesh, specs[name], value.shape)])

    for name, p in sorted(model.layers.named_parameters()):
        shape = shapes[f"layers.{name}"]
        if "norm" in name:
            p.fill_(1.0)
            continue
        fan_in = shape[-2] if len(shape) > 2 else shape[-1]
        if name == "wo":
            fan_in = shape[1] * shape[2]
        if name in ("wq", "wk", "wv"):
            fan_in = shape[1]
        keep(f"layers.{name}", p,
             L.dense_init(generator, shape, fan_in, p.dtype))
    if not cfg.embedding_inputs:
        keep("embed", model.embed, L.embed_init(
            generator, shapes["embed"], model.embed.dtype))
    model.final_norm.fill_(1.0)
    keep("lm_head", model.lm_head, L.dense_init(
        generator, shapes["lm_head"], cfg.d_model, model.lm_head.dtype))
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _placed(lay: Optional[Layout], lp: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """A layer's leaves as its computation uses them: the ``partial`` ones
    through ``copy_to_model``, then every ``data``-sharded one gathered
    over ``data`` (the identity without a mesh)."""
    if lay is None:
        return lp
    out = {}
    for name, t in lp.items():
        if name in lay.partial:
            t = parallel.copy_to_model(t, lay.model)
        spec = lay.specs[name]
        if "data" in spec:
            t = parallel.gather_data(t, spec.index("data"), lay.data)
        out[name] = t
    return out


def _qkv(cfg: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
         positions: torch.Tensor, lay: Optional[Layout] = None,
         all_kv: bool = False):
    """The attention sub-block's queries, keys and values (B, S, heads,
    hd), normed (``qk_norm``) and rotated.  On a ``lay`` with the query
    heads over ``model``: the rank's query heads, and the KV heads they
    read (``all_kv``: every KV head the rank holds)."""
    dtype = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    tp = lay is not None and lay.heads
    if tp:
        h = parallel.copy_to_model(h, lay.model)

    def proj(w):
        return (h @ w.reshape(d, -1).to(dtype)).view(b, s, w.shape[1],
                                                     w.shape[2])

    wk, wv = lp["wk"], lp["wv"]
    if tp and not lay.kv_heads and not all_kv:
        wk, wv = wk[:, lay.kv_read], wv[:, lay.kv_read]
    q, k, v = proj(lp["wq"]), proj(wk), proj(wv)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_out(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
              out: torch.Tensor, lay: Optional[Layout] = None
              ) -> torch.Tensor:
    """``wo`` of the attention's output (B, S, heads, hd); on a ``lay``
    with the heads over ``model``, its partial sums reduced there."""
    b, s = out.shape[:2]
    hh, hd, d = lp["wo"].shape
    out = out.reshape(b, s, hh * hd) @ lp["wo"].reshape(hh * hd, d).to(
        dtype_of(cfg.compute_dtype))
    tp = lay is not None and lay.heads
    return parallel.reduce_from_model(out, lay.model) if tp else out


def _attn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                x: torch.Tensor, positions: torch.Tensor,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos: Optional[int] = None,
                lay: Optional[Layout] = None):
    """One attention sub-block (within ``cfg.attn_window`` keys where it is
    set).  With ``cache_kv`` the step's keys and values are first written
    into the cache at ``cache_pos``.  On a ``lay``: the rank's query heads
    and the KV heads they read (every KV head, at the rank's head-dim
    slice, into a cache whose head dim is over ``model``), ``wo``'s
    partial sums reduced over ``model``."""
    s = x.shape[1]
    tp = lay is not None and lay.heads
    split_hd = cache_kv is not None and lay is not None and lay.m > 1 \
        and not lay.kv_heads
    q, k, v = _qkv(cfg, lp, x, positions, lay, all_kv=split_hd)

    if split_hd:
        kc, vc = cache_kv
        n = kc.shape[-1]
        cols = slice(lay.r * n, (lay.r + 1) * n)
        kc[:, cache_pos:cache_pos + s] = k[..., cols].to(kc.dtype)
        vc[:, cache_pos:cache_pos + s] = v[..., cols].to(vc.dtype)
        q_all = parallel.gather_model(q, 2, lay.model) if tp else q
        out = L.attention_split_hd(q_all, kc, vc, cols, lay.model,
                                   q_offset=cache_pos, kv_len=cache_pos + s)
        if tp:
            out = out[:, :, lay.q_heads]
    elif cache_kv is not None:
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
                          block_kv=cfg.flash_block_kv,
                          window=cfg.attn_window)
    return _attn_out(cfg, lp, out, lay)


def _ffn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor, lay: Optional[Layout] = None,
               split=None) -> torch.Tensor:
    """The MLP sub-block; on a ``lay`` with a model axis, column- then
    row-parallel (an MoE on the rank's experts or FFN columns, its token
    groups formed over ``split``'s rows), the partial sums reduced over
    ``model``."""
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    tp = lay is not None and lay.m > 1
    if tp:
        h = parallel.copy_to_model(h, lay.model)
    if cfg.num_experts:
        y = moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                    top_k=cfg.experts_per_token,
                    capacity_factor=cfg.capacity_factor,
                    experts=lay.experts if lay is not None else None,
                    split=split)
    else:
        y = L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return parallel.reduce_from_model(y, lay.model) if tp else y


def _embed(cfg: ModelConfig, params: TransformerLM,
           tokens: torch.Tensor) -> torch.Tensor:
    dtype = dtype_of(cfg.compute_dtype)
    if cfg.embedding_inputs:
        # already (B, S, d) embeddings
        return tokens.to(dtype)
    lay = params.layout
    table = params.embed
    if lay is not None:
        table = parallel.gather_data(table, 1, lay.data)
    if lay is None or lay.m == 1:
        # gather, then cast: bit for bit the reference's cast-then-gather,
        # without casting the whole table on every call
        return table[tokens].to(dtype)
    # vocab-parallel: the rows of the rank's block, zeros for the others,
    # summed over model (one nonzero term: exact)
    local = tokens - lay.vocab_lo
    own = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
    return parallel.reduce_from_model(
        rows.masked_fill(~own[..., None], 0), lay.model)


def _unembed(cfg: ModelConfig, params: TransformerLM,
             x: torch.Tensor) -> torch.Tensor:
    """Logits (..., V_pad); on a mesh, the rank's vocab columns."""
    dtype = dtype_of(cfg.compute_dtype)
    lay = params.layout
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head
    if lay is not None:
        head = parallel.gather_data(head, 0, lay.data)
        h = parallel.copy_to_model(h, lay.model)
    return h @ head.to(dtype)


def _layer(cfg: ModelConfig, lay: Optional[Layout],
           lp: Dict[str, torch.Tensor], x: torch.Tensor,
           positions: torch.Tensor, split=None) -> torch.Tensor:
    lp = _placed(lay, lp)
    x = x + _attn_block(cfg, lp, x, positions, lay=lay)
    return x + _ffn_block(cfg, lp, x, lay, split)


def _forward(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: str,
             split=None) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    for lp in params.layers.unbind():
        x = L.remat_call(remat, _layer, cfg, params.layout, lp, x, positions,
                         split)
    return _unembed(cfg, params, x)


@torch.no_grad()
def forward(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            split=None) -> torch.Tensor:
    """Full-sequence forward of tokens (B, S) (or embeddings (B, S, d))
    -> logits (B, S, V_pad) (on a mesh the rank's vocab columns).  Prefill
    path: one flash-attention launch per layer on the card, causal or not
    as ``cfg.causal``, no gradient.  ``split``: the process group whose
    ranks hold the global batch's rows in blocks, this rank ``tokens``
    (None: ``tokens`` are the whole batch), which an MoE's token groups
    are formed over (``models.moe.moe_ffn``)."""
    return _forward(cfg, params, tokens, positions, "none", split)


def train_forward(cfg: ModelConfig, params: TransformerLM,
                  tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  split=None) -> torch.Tensor:
    """``forward`` with gradients: the reference's train path.

    ``cfg.remat`` (``layers.remat_call``, per layer): ``"full"``
    recomputes each layer in the backward (the reference's
    ``jax.checkpoint`` of the scan body), its FSDP gathers included;
    ``"dots"`` saves the projections' outputs and recomputes the rest;
    under either a layer's flash kernel launches twice a step.
    ``"none"`` keeps every activation.  ``split`` as ``forward``'s.
    """
    return _forward(cfg, params, tokens, positions, cfg.remat, split)


def token_nll(cfg: ModelConfig, params: TransformerLM, logits: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy (B, S) in fp32 of ``train_forward``'s
    logits; on a mesh over the rank's vocab columns, reduced over
    ``model`` (``layers.token_nll``)."""
    lay = params.layout
    if lay is None or lay.m == 1:
        return L.token_nll(logits, labels)
    return L.token_nll(logits, labels, lay.vocab_lo, lay.model)


def loss_fn(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``train_forward``'s logits (the padded
    vocab tail never appears in labels)."""
    return token_nll(cfg, params, train_forward(cfg, params, tokens),
                     labels).mean()


# --------------------------------------------------------------------------
# KV-cache serving path
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE, mesh=None):
    """Stacked KV cache: a pair of zero (L, B, S_max, KV, hd) tensors (two
    tensors, since decode writes them in place); on a mesh this rank's
    block of each (``cache_specs``)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if mesh is not None:
        block = local_block(mesh, cache_specs(cfg)[0], shape)
        shape = tuple(sl.stop - sl.start for sl in block)
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
                tokens: torch.Tensor, pos: int, split=None):
    """One autoregressive step: tokens (B, 1) (or embeddings (B, 1, d)) at
    position ``pos``.  Returns (logits (B, 1, V), cache), the cache updated
    in place.  Attention over the cache is causal for every family, the
    encoders' too, as in the reference (``applicable_shapes`` lists no
    decode cell for an encoder).  On a mesh: the rank's rows of the
    cache's batch, its block of the cache, its vocab columns; ``split``
    as ``forward``'s."""
    pos = int(pos)
    lay = params.layout
    x = _embed(cfg, params, tokens)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    kc_all, vc_all = cache
    for i in range(cfg.num_layers):
        lp = _placed(lay, params.layers.layer(i))
        x = x + _attn_block(cfg, lp, x, positions,
                            cache_kv=(kc_all[i], vc_all[i]), cache_pos=pos,
                            lay=lay)
        x = x + _ffn_block(cfg, lp, x, lay, split)
    return _unembed(cfg, params, x), cache
