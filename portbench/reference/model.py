"""The models' forward passes in plain fp32 PyTorch.

Parameters are a dictionary by dotted name (``weights.param_shapes``'
layout).  The dense decoder (qwen3): pre-norm RMSNorm, q/k/v projections,
per-head RMSNorm of q and k (qk-norm), rotary embedding on the half-split
pairs, causal grouped-query attention, the output projection, SwiGLU, a
final RMSNorm and the head.  The hybrid (zamba2): Mamba2 layers (RMSNorm;
z, x, B, C, dt projections; a width-4 depthwise causal convolution and
SiLU on x, B and C; dt = softplus(dt_raw + dt_bias), A = -exp(A_log); the
SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t
computed in chunks; y + D x; RMSNorm of y * silu(z); the out projection)
and after every ``attn_every``-th of them one shared attention + MLP
block, a dense decoder layer without qk-norm whose attention keeps the
last ``window`` keys.  Everything is computed for the rows given; the
callers loop over rows and blocks so that the full sizes fit.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..spec import Spec
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


def qkv(spec: Spec, num: Numerics, lp: Params, x: torch.Tensor,
        pos: torch.Tensor):
    h = rms(x, lp["attn_norm"], spec.eps)
    q, k, v = (_proj(num, h, lp[n]) for n in ("wq", "wk", "wv"))
    if spec.qk_norm:
        q, k = rms(q, lp["q_norm"], spec.eps), rms(k, lp["k_norm"], spec.eps)
    return rope(q, pos, spec.rope_theta), rope(k, pos, spec.rope_theta), v


def attn_out_and_mlp(spec: Spec, num: Numerics, lp: Params, x: torch.Tensor,
                     att: torch.Tensor) -> torch.Tensor:
    x = x + _proj(num, att.flatten(-2), lp["wo"].flatten(0, 1))
    h = rms(x, lp["mlp_norm"], spec.eps)
    g, u = _proj(num, h, lp["w_gate"]), _proj(num, h, lp["w_up"])
    return x + _proj(num, F.silu(g) * u, lp["w_down"])


def decoder_layer(spec: Spec, num: Numerics, lp: Params, x: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = qkv(spec, num, lp, x, pos)
    return attn_out_and_mlp(spec, num, lp, x,
                            attend(num, q, k, v, pos, pos, window))


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


def mamba_layer(spec: Spec, num: Numerics, lp: Params,
                x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hh, p = spec.ssm_heads, spec.ssm_head_dim
    h = rms(x, lp["norm"], spec.eps)
    z, xin, Braw, Craw, dtraw = (_proj(num, h, lp[n]) for n in
                                 ("wz", "wx", "wB", "wC", "wdt"))
    xc = F.silu(causal_conv(xin, lp["conv_x"]))
    Bc = F.silu(causal_conv(Braw, lp["conv_B"]))
    Cc = F.silu(causal_conv(Craw, lp["conv_C"]))
    dt = torch.logaddexp(dtraw + lp["dt_bias"],
                         torch.zeros((), device=x.device))
    A = -torch.exp(lp["A_log"])
    chunk = min(spec.ssm_chunk, s)
    pad = (-s) % chunk
    xh = xc.reshape(b, s, hh, p)
    if pad:
        y = ssd(F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
                F.pad(Bc, (0, 0, 0, pad)), F.pad(Cc, (0, 0, 0, pad)),
                chunk)[:, :s]
    else:
        y = ssd(xh, dt, A, Bc, Cc, chunk)
    y = (y + xh * lp["D"][:, None]).reshape(b, s, -1)
    y = rms(y * F.silu(z), lp["gate_norm"], spec.eps)
    return x + _proj(num, y, lp["out_proj"])


def layer_params(P: Params, i: int) -> Params:
    return {n[len("layers."):]: t[i] for n, t in P.items()
            if n.startswith("layers.")}


def shared_params(P: Params) -> Params:
    return {n[len("shared_attn."):]: t for n, t in P.items()
            if n.startswith("shared_attn.")}


def hidden(spec: Spec, num: Numerics, P: Params, tokens: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S);
    ``remat``: each layer recomputed in the backward."""
    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    x = P["embed"][tokens]
    if spec.family == "dense":
        for i in range(spec.layers):
            x = run(lambda x, i=i: decoder_layer(spec, num, layer_params(P, i),
                                                 x), x)
    else:
        sp = shared_params(P)
        for i in range(spec.layers):
            x = run(lambda x, i=i: mamba_layer(spec, num, layer_params(P, i),
                                               x), x)
            if spec.attn_every and (i + 1) % spec.attn_every == 0 \
                    and (i + 1) // spec.attn_every <= spec.sites:
                x = run(lambda x: decoder_layer(spec, num, sp, x,
                                                spec.window), x)
    return rms(x, P["final_norm"], spec.eps)


def logits(num: Numerics, P: Params, h: torch.Tensor) -> torch.Tensor:
    return _proj(num, h, P["lm_head"])


def decode_over_prefix(spec: Spec, num: Numerics, P: Params,
                       tokens: torch.Tensor, p_lo: int, prefix_kv,
                       ) -> tuple:
    """The dense decoder fed ``tokens`` (B, T) at positions p_lo .. p_lo +
    T - 1 after a cache prefix: ``prefix_kv(layer)`` gives that layer's
    (k, v) at positions 0 .. p_lo - 1, (B, p_lo, KV, hd).  Returns (final
    hidden (B, T, d), k and v written at the T positions, each (L, B, T,
    KV, hd))."""
    t = tokens.shape[1]
    pos = p_lo + torch.arange(t, device=tokens.device)
    k_pos = torch.arange(p_lo + t, device=tokens.device)
    x = P["embed"][tokens]
    ks, vs = [], []
    for i in range(spec.layers):
        lp = layer_params(P, i)
        q, k, v = qkv(spec, num, lp, x, pos)
        pk, pv = prefix_kv(i)
        att = attend(num, q, torch.cat([pk.float(), k], 1),
                     torch.cat([pv.float(), v], 1), pos, k_pos)
        x = attn_out_and_mlp(spec, num, lp, x, att)
        ks.append(k)
        vs.append(v)
        del pk, pv
    return rms(x, P["final_norm"], spec.eps), torch.stack(ks), torch.stack(vs)


def token_nll(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lg, dim=-1) - lg.gather(
        -1, labels[..., None].long())[..., 0]


def row_loss(spec: Spec, num: Numerics, P: Params, tokens: torch.Tensor,
             labels: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy of each row (B,)."""
    return token_nll(logits(num, P, hidden(spec, num, P, tokens, remat)),
                     labels).mean(-1)
