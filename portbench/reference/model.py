"""The models' shared pieces in plain fp32 PyTorch, and the forward
passes by family.

Parameters are a dictionary by dotted name (``weights.param_shapes``'
layout, the layers' leaves ``layers.<name>`` stacked along a leading
layer axis).  The library: RMSNorm, rotary embedding on the half-split
pairs, causal grouped-query attention (optionally within a window), a
projection, the depthwise causal convolution, the SSD recurrence in
chunks, the head and the token cross-entropy.  Each family's module
(``portbench/families/``) builds its forward from them; ``hidden`` and
``decode_over_prefix`` run the one of the spec's family.  Everything is
computed for the rows given; the callers loop over rows and blocks so
that the full sizes fit.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..spec import Spec, family_of
from .numerics import Numerics

Params = Dict[str, torch.Tensor]
Q_BLOCK = 1024


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by positions pos (S,): pairs (i, i + hd/2),
    frequencies theta ** (-i / (hd/2)) rounded once to fp32."""
    half = x.shape[-1] // 2
    expo = torch.arange(half, dtype=torch.float64, device=x.device) / half
    freqs = (1.0 / theta ** expo).float()
    ang = pos.float()[:, None] * freqs                     # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(num: Numerics, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor,
           window: int = 0) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, hd) at positions q_pos over k, v
    (B, Sk, KV, hd) at k_pos (both ascending), keeping keys within
    ``window`` of the query (0: all); query head h reads KV head
    h // (H / KV).  Blocks of Q_BLOCK queries over the keys they can
    see."""
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    kv_of = torch.arange(h, device=q.device) // (h // kvh)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for lo in range(0, q.shape[1], Q_BLOCK):
        qb, qp = q[:, lo:lo + Q_BLOCK], q_pos[lo:lo + Q_BLOCK]
        first = 0 if window <= 0 else int(qp[0]) - window + 1
        keep = (k_pos >= first) & (k_pos <= int(qp[-1]))
        idx = keep.nonzero()[:, 0]
        ks, vs, kp = k[:, idx][:, :, kv_of], v[:, idx][:, :, kv_of], k_pos[idx]
        s = num.einsum("bqhd,bkhd->bhqk", qb * scale, ks)
        mask = kp[None, :] <= qp[:, None]
        if window > 0:
            mask &= (qp[:, None] - kp[None, :]) < window
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(num.einsum("bhqk,bkhd->bqhd", p, vs))
    return torch.cat(outs, dim=1)


def _proj(num: Numerics, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, ...) -> (..., *w.shape[1:])."""
    out = num.mm(x.reshape(-1, x.shape[-1]), w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: y_t = sum_i w_i x_{t - K + 1 + i}."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """y of the SSD recurrence from a zero state: x (B, S, H, P), dt (B, S,
    H), A (H,), Bm / Cm (B, S, N) shared by the heads; S a multiple of
    ``chunk``.  Within a chunk the quadratic form, between chunks the
    state."""
    b, s, h, p = x.shape
    n, nc = Bm.shape[-1], s // chunk
    xs = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    Bs, Cs = Bm.reshape(b, nc, chunk, n), Cm.reshape(b, nc, chunk, n)
    lcum = torch.cumsum(dts * A, dim=2)                     # (b, nc, Q, h)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    diff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (b,nc,t,s,h)
    decay = torch.exp(diff.masked_fill(~tril[None, None, :, :, None],
                                       float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", Cs, Bs)
    y = torch.einsum("bctsh,bcshp->bcthp",
                     cb[..., None] * decay * dts[:, :, None], xs)
    # each chunk's own contribution to the state at its end
    tail = torch.exp(lcum[:, :, -1:] - lcum) * dts          # (b,nc,Q,h)
    own = torch.einsum("bcsh,bcsn,bcshp->bchpn", tail, Bs, xs)
    hstate = x.new_zeros(b, h, p, n)
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("btn,bhpn->bthp", Cs[:, c], hstate)
                     * torch.exp(lcum[:, c])[..., None])
        hstate = hstate * torch.exp(lcum[:, c, -1])[:, :, None, None] \
            + own[:, c]
    return (y + torch.stack(inter, dim=1)).reshape(b, s, h, p)


def layer_params(P: Params, i: int) -> Params:
    return {n[len("layers."):]: t[i] for n, t in P.items()
            if n.startswith("layers.")}


def run_layer(fn, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``fn(x)``; where ``remat``, recomputed in the backward."""
    return checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


def hidden(spec: Spec, num: Numerics, P: Params, tokens: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S), by
    the spec's family; ``remat``: each layer recomputed in the
    backward."""
    return family_of(spec).hidden(spec, num, P, tokens, remat)


def logits(num: Numerics, P: Params, h: torch.Tensor) -> torch.Tensor:
    return _proj(num, h, P["lm_head"])


def decode_over_prefix(spec: Spec, num: Numerics, P: Params,
                       tokens: torch.Tensor, p_lo: int, prefix_kv,
                       ) -> tuple:
    """The spec's family fed ``tokens`` (B, T) at positions p_lo .. p_lo +
    T - 1 after a KV cache prefix: ``prefix_kv(layer)`` gives that layer's
    (k, v) at positions 0 .. p_lo - 1.  Returns (final hidden (B, T, d),
    k and v written at the T positions)."""
    return family_of(spec).decode_over_prefix(spec, num, P, tokens, p_lo,
                                              prefix_kv)


def token_nll(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lg, dim=-1) - lg.gather(
        -1, labels[..., None].long())[..., 0]


def row_loss(spec: Spec, num: Numerics, P: Params, tokens: torch.Tensor,
             labels: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy of each row (B,)."""
    return token_nll(logits(num, P, hidden(spec, num, P, tokens, remat)),
                     labels).mean(-1)
