"""Mamba2 (SSD -- state-space duality) blocks (a port of the JAX package's
``models/mamba2.py``, serving path).

Prefill runs the chunked SSD scan through ``kernels/ssd_scan`` (the CUDA
kernel on the card, the plain chunked form on the CPU); decode keeps the
recurrent state (B, H, P, N) and a depthwise-conv tail buffer.

Shapes follow the paper's notation: d_in = expand * d_model, heads
H = d_in / head_dim, head dim P, state size N, n_groups G = 1 (B and C
shared across heads).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ssd_chunked, ssd_scan
from . import layers as L
from .params import dtype_of

__all__ = ["CONV_K", "N_GROUPS", "causal_conv", "causal_conv_step", "dims",
           "init_block_state", "init_layer_params", "layer_shapes",
           "mamba2_block", "mamba2_block_decode", "ssd_chunked",
           "ssd_decode_step"]

CONV_K = 4   # depthwise causal conv kernel width (Mamba default)
N_GROUPS = 1


def dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def layer_shapes(cfg: ModelConfig, nl: int) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    d_in, h, p, n = dims(cfg)
    gn = N_GROUPS * n
    return {
        "norm": (nl, d),
        "wz": (nl, d, d_in),
        "wx": (nl, d, d_in),
        "wB": (nl, d, gn),
        "wC": (nl, d, gn),
        "wdt": (nl, d, h),
        "conv_x": (nl, CONV_K, d_in),
        "conv_B": (nl, CONV_K, gn),
        "conv_C": (nl, CONV_K, gn),
        "A_log": (nl, h),
        "D": (nl, h),
        "dt_bias": (nl, h),
        "gate_norm": (nl, d_in),
        "out_proj": (nl, d_in, d),
    }


@torch.no_grad()
def init_layer_params(params: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> None:
    """Fill the stacked layer parameters in place with the reference's laws:
    norms and D are 1, A = -exp(A_log) uniform in [-16, -1), dt_bias the
    inverse softplus of dt ~ U[1e-3, 1e-1], truncated-normal fan-in
    weights."""
    for name, p in sorted(params.items()):
        shape = p.shape
        if "norm" in name or name == "D":
            p.fill_(1.0)
        elif name == "A_log":
            u = torch.empty(shape, device=p.device).uniform_(
                1.0, 16.0, generator=generator)
            p.copy_(torch.log(u))
        elif name == "dt_bias":
            u = torch.empty(shape, device=p.device).uniform_(
                1e-3, 1e-1, generator=generator)
            p.copy_(torch.log(torch.expm1(u)))
        elif name.startswith("conv"):
            p.copy_(L.dense_init(generator, shape, CONV_K, p.dtype))
        else:
            p.copy_(L.dense_init(generator, shape, shape[1], p.dtype))


# --------------------------------------------------------------------------
# Depthwise causal conv (width CONV_K) -- full-sequence and streaming forms
# --------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (K, C) -> (B, S, C); y[t] = sum_i w[i] x[t-K+1+i]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return out


def causal_conv_step(tail: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """Streaming step: tail (B, K-1, C) previous inputs, x_t (B, 1, C).
    Returns (y_t (B, 1, C), new_tail)."""
    window = torch.cat([tail, x_t], dim=1)                     # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w.to(x_t.dtype))[:, None]
    return y, window[:, 1:]


def ssd_decode_step(hstate: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor):
    """One-token recurrence.  hstate (B,H,P,N), x_t (B,H,P), dt_t (B,H),
    B_t/C_t (B,N).  Returns (y_t (B,H,P), h_new)."""
    f32 = torch.float32
    dA = torch.exp(dt_t.to(f32) * A.to(f32))                   # (B,H)
    upd = torch.einsum("bhp,bn->bhpn",
                       x_t.to(f32) * dt_t[..., None].to(f32), B_t.to(f32))
    h_new = hstate * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.to(f32))
    return y.to(x_t.dtype), h_new


# --------------------------------------------------------------------------
# Full mamba2 block
# --------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _project(cfg: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor):
    """Shared projections; returns (z, xin, Braw, Craw, dtraw) pre-conv."""
    dtype = dtype_of(cfg.compute_dtype)
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    return tuple(h @ lp[name].to(dtype)
                 for name in ("wz", "wx", "wB", "wC", "wdt"))


def _finish(cfg: ModelConfig, lp: Dict[str, torch.Tensor], y: torch.Tensor,
            x_conv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Skip (D), gating, norm, out-projection.  y/x_conv (B,S,H,P)."""
    d_in = dims(cfg)[0]
    b, s = y.shape[:2]
    y = y + x_conv * lp["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
    return y @ lp["out_proj"].to(y.dtype)


def _dt_and_A(lp, dtraw):
    dt = _softplus(dtraw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    return dt, A


def mamba2_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block (prefill): one ``ssd_scan`` per call."""
    d_in, heads, p, n = dims(cfg)
    b, s = x.shape[:2]
    z, xin, Braw, Craw, dtraw = _project(cfg, lp, x)
    xc = F.silu(causal_conv(xin, lp["conv_x"]))
    Bc = F.silu(causal_conv(Braw, lp["conv_B"]))
    Cc = F.silu(causal_conv(Craw, lp["conv_C"]))
    dt, A = _dt_and_A(lp, dtraw)
    xh = xc.reshape(b, s, heads, p)
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    # pad the tail; dt = 0 there makes the padded steps exact no-ops
    xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad)) if pad else xh
    dt_p = F.pad(dt, (0, 0, 0, pad)) if pad else dt
    B_p = F.pad(Bc, (0, 0, 0, pad)) if pad else Bc
    C_p = F.pad(Cc, (0, 0, 0, pad)) if pad else Cc
    y = ssd_scan(xh_p.contiguous(), dt_p.contiguous(), A.contiguous(),
                 B_p.contiguous(), C_p.contiguous(), chunk=chunk)[:, :s]
    return _finish(cfg, lp, y, xh, z)


def mamba2_block_decode(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                        x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One-token block step.  x (B, 1, d).  state: {"h": (B,H,P,N),
    "conv_x": (B,K-1,d_in), "conv_B": (B,K-1,N), "conv_C": (B,K-1,N)}.
    Returns (out, new_state)."""
    d_in, heads, p, n = dims(cfg)
    b = x.shape[0]
    z, xin, Braw, Craw, dtraw = _project(cfg, lp, x)
    xc, tail_x = causal_conv_step(state["conv_x"], xin, lp["conv_x"])
    Bc, tail_B = causal_conv_step(state["conv_B"], Braw, lp["conv_B"])
    Cc, tail_C = causal_conv_step(state["conv_C"], Craw, lp["conv_C"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    dt, A = _dt_and_A(lp, dtraw)
    xh = xc.reshape(b, heads, p)
    y, h_new = ssd_decode_step(state["h"], xh, dt[:, 0], A, Bc[:, 0],
                               Cc[:, 0])
    out = _finish(cfg, lp, y[:, None], xh[:, None], z)
    return out, {"h": h_new, "conv_x": tail_x, "conv_B": tail_B,
                 "conv_C": tail_C}


def init_block_state(cfg: ModelConfig, nl: int, batch: int,
                     device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Stacked zero decode state for nl layers."""
    d_in, heads, p, n = dims(cfg)
    dtype, device = dtype_of(cfg.compute_dtype), resolve(device)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return {
        "h": z((nl, batch, heads, p, n), torch.float32),
        "conv_x": z((nl, batch, CONV_K - 1, d_in), dtype),
        "conv_B": z((nl, batch, CONV_K - 1, N_GROUPS * n), dtype),
        "conv_C": z((nl, batch, CONV_K - 1, N_GROUPS * n), dtype),
    }
