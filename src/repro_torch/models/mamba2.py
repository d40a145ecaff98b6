"""Mamba2 (SSD -- state-space duality) blocks (a port of the JAX package's
``models/mamba2.py``).

Prefill and training run the chunked SSD scan through ``kernels/ssd_scan``
(the CUDA kernel on the card, the plain chunked form on the CPU); under
gradients it runs inside ``SSDTrain``, whose backward is the plain
chunked form's autograd, as the reference's training is autodiff through
``jnp``.  Decode keeps the recurrent state (B, H, P, N) and a
depthwise-conv tail buffer.

Shapes follow the paper's notation: d_in = expand * d_model, heads
H = d_in / head_dim, head dim P, state size N, n_groups G = 1 (B and C
shared across heads).

On a ``launch.mesh`` mesh (a ``Layout``) a block takes the rank's blocks
of its leaves (``layer_specs``, FSDP-gathered over ``data`` by the
caller) and runs on the rank's inner channels (``wz``, ``wx``,
``conv_x``, ``gate_norm``, ``out_proj`` where d_in % 16 == 0) and heads
(``wdt``, ``A_log``, ``D``, ``dt_bias``, the scan and the state where
H % 16 == 0), as GSPMD places the reference's: the normed input enters
the model region through ``parallel.copy_to_model``; B and C are whole
on every rank (``wB``, ``wC``, ``conv_B``, ``conv_C`` replicated, their
gradients partial over the rank's heads and summed by ``copy_to_model``);
the gated RMSNorm normalises over the whole d_in (its sum of squares
all-reduced over ``model``); ``out_proj`` is row-parallel, its partial
sums reduced over ``model``.  Where the heads stay whole while the inner
channels are sharded, the rank gathers its conv output over ``model``,
scans every head (the head leaves then replicated and partial, as B and
C) and keeps its inner columns of y.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import parallel
from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ssd_chunked, ssd_scan
from ..sharding import P, shard_shape
from . import layers as L
from .params import dtype_of

__all__ = ["CONV_K", "Layout", "N_GROUPS", "SSDTrain", "block_state_specs",
           "causal_conv", "causal_conv_step", "dims", "init_block_state",
           "init_layer_params", "layer_shapes", "layer_specs", "layout",
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


def layer_specs(cfg: ModelConfig, fsdp: str = "data",
                tp: str = "model") -> Dict[str, P]:
    """The reference's ``P`` of each stacked layer parameter."""
    d_in, h, p, n = dims(cfg)
    inner = tp if d_in % 16 == 0 else None
    head = tp if h % 16 == 0 else None
    return {
        "norm": P(None, None),
        "wz": P(None, fsdp, inner),
        "wx": P(None, fsdp, inner),
        "wB": P(None, fsdp, None),
        "wC": P(None, fsdp, None),
        "wdt": P(None, fsdp, head),
        "conv_x": P(None, None, inner),
        "conv_B": P(None, None, None),
        "conv_C": P(None, None, None),
        "A_log": P(None, head),
        "D": P(None, head),
        "dt_bias": P(None, head),
        "gate_norm": P(None, inner),
        "out_proj": P(None, inner, fsdp),
    }


def block_state_specs(cfg: ModelConfig, fsdp: str = "data",
                      tp: str = "model") -> Dict[str, P]:
    """The reference's ``P`` of each decode-state tensor (no batch
    axis: the reference replicates the SSM state over the batch axes)."""
    d_in, heads, p, n = dims(cfg)
    head = tp if heads % 16 == 0 else None
    inner = tp if d_in % 16 == 0 else None
    return {
        "h": P(None, None, head, None, None),
        "conv_x": P(None, None, None, inner),
        "conv_B": P(None, None, None, None),
        "conv_C": P(None, None, None, None),
    }


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a placed block splits over its mesh: the ``data`` and ``model``
    groups (None for one rank), the model axis's size ``m`` and this
    rank's index ``r`` on it, whether the inner channels and the heads
    are over ``model``, each leaf's spec without the layer axis, and the
    leaves replicated over ``model`` that enter its region
    (``copy_to_model``)."""
    data: Any
    model: Any
    m: int
    r: int
    inner: bool
    heads: bool
    specs: Dict[str, P]
    partial: frozenset

    def __deepcopy__(self, memo):
        return self                 # it names process groups


def layout(cfg: ModelConfig, mesh) -> Optional[Layout]:
    """The ``Layout`` of ``cfg``'s blocks on ``mesh`` (None without a
    mesh)."""
    if mesh is None:
        return None
    d_in, h, p, n = dims(cfg)
    sizes = mesh.sizes
    m = sizes.get("model", 1)
    inner = m > 1 and d_in % 16 == 0
    heads = m > 1 and h % 16 == 0
    partial = set()
    if inner:
        partial |= {"wB", "wC", "conv_B", "conv_C"}
        if not heads:
            partial |= {"wdt", "A_log", "D", "dt_bias"}
    return Layout(
        data=mesh.group("data") if "data" in sizes else None,
        model=mesh.group("model") if "model" in sizes else None,
        m=m, r=dict(zip(mesh.axis_names, mesh.coordinate())).get("model", 0),
        inner=inner, heads=heads,
        specs={k: P(*v[1:]) for k, v in layer_specs(cfg).items()},
        partial=frozenset(partial))


def init_layer_params(shapes: Dict[str, Tuple[int, ...]],
                      generator: torch.Generator,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The stacked layer parameters of ``shapes`` (whole), drawn in sorted
    order of their names with the reference's laws: norms and D are 1,
    A = -exp(A_log) uniform in [-16, -1), dt_bias the inverse softplus of
    dt ~ U[1e-3, 1e-1], truncated-normal fan-in weights."""
    out = {}
    dev = generator.device
    for name, shape in sorted(shapes.items()):
        if "norm" in name or name == "D":
            out[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif name == "A_log":
            u = torch.empty(shape, device=dev).uniform_(
                1.0, 16.0, generator=generator)
            out[name] = torch.log(u).to(dtype)
        elif name == "dt_bias":
            u = torch.empty(shape, device=dev).uniform_(
                1e-3, 1e-1, generator=generator)
            out[name] = torch.log(torch.expm1(u)).to(dtype)
        elif name.startswith("conv"):
            out[name] = L.dense_init(generator, shape, CONV_K, dtype)
        else:
            out[name] = L.dense_init(generator, shape, shape[1], dtype)
    return out


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


def _project(cfg: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
             lay: Optional[Layout] = None):
    """Shared projections; returns (z, xin, Braw, Craw, dtraw) pre-conv
    (z and xin on the rank's inner channels, dtraw on its heads)."""
    dtype = dtype_of(cfg.compute_dtype)
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    if lay is not None and lay.inner:
        h = parallel.copy_to_model(h, lay.model)
    return tuple(h @ lp[name].to(dtype)
                 for name in ("wz", "wx", "wB", "wC", "wdt"))


def _to_heads(xc: torch.Tensor, p: int, lay: Optional[Layout]
              ) -> torch.Tensor:
    """The conv output (..., inner) as (..., heads, P) for the scan: the
    rank's heads, or, where the heads are whole and the inner channels
    sharded, every head (gathered over ``model``)."""
    if lay is not None and lay.inner and not lay.heads:
        xc = parallel.gather_model(xc, xc.dim() - 1, lay.model)
    return xc.reshape(*xc.shape[:-1], -1, p)


def _finish(cfg: ModelConfig, lp: Dict[str, torch.Tensor], y: torch.Tensor,
            x_conv: torch.Tensor, z: torch.Tensor,
            lay: Optional[Layout] = None) -> torch.Tensor:
    """Skip (D), gating, norm, out-projection.  y/x_conv (B,S,H,P) (the
    scan's heads), z on the rank's inner channels."""
    b, s = y.shape[:2]
    y = y + x_conv * lp["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, -1)
    inner = lay is not None and lay.inner
    if inner and not lay.heads:
        n = y.shape[-1] // lay.m
        y = y[..., lay.r * n:(lay.r + 1) * n]
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps,
                   lay.model if inner else None)
    out = y @ lp["out_proj"].to(y.dtype)
    return parallel.reduce_from_model(out, lay.model) if inner else out


class SSDTrain(torch.autograd.Function):
    """The SSD scan with a recompute backward: the training route of
    ``ssd_scan``.

    Forward: ``ssd_scan`` on (x, dt, A, B, C), the CUDA kernel on a CUDA
    tensor, the plain chunked form on the CPU.  Saved: the five inputs,
    O(S) of them.  Backward: the plain ``ssd_chunked`` recomputed in fp32
    under autograd, and its gradients for the inputs that need one, cast
    back to their dtypes.  This is the reference's autodiff through
    ``jnp`` (its Pallas kernel has no backward); the chunks' (B, Q, Q, H)
    decay and weight tensors live only inside the backward, never among
    the step's saved activations.
    """

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                        Bm.contiguous(), Cm.contiguous(), chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            y = ssd_chunked(*leaves, ctx.chunk)[0]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy.float()))
        out = [next(grads).to(t.dtype) if n else None
               for t, n in zip(inputs, need)]
        return (*out, None)


def _dt_and_A(lp, dtraw):
    dt = _softplus(dtraw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    return dt, A


def mamba2_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor, lay: Optional[Layout] = None
                 ) -> torch.Tensor:
    """Full-sequence mamba2 block (train / prefill): one ``ssd_scan`` per
    call, inside ``SSDTrain`` when gradients are on and an input of the
    scan requires one (training), bare otherwise (prefill); on a ``lay``
    over the rank's heads (see the module doc)."""
    p = dims(cfg)[2]
    s = x.shape[1]
    z, xin, Braw, Craw, dtraw = _project(cfg, lp, x, lay)
    xc = F.silu(causal_conv(xin, lp["conv_x"]))
    Bc = F.silu(causal_conv(Braw, lp["conv_B"]))
    Cc = F.silu(causal_conv(Craw, lp["conv_C"]))
    dt, A = _dt_and_A(lp, dtraw)
    xh = _to_heads(xc, p, lay)
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    # pad the tail; dt = 0 there makes the padded steps exact no-ops
    xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad)) if pad else xh
    dt_p = F.pad(dt, (0, 0, 0, pad)) if pad else dt
    B_p = F.pad(Bc, (0, 0, 0, pad)) if pad else Bc
    C_p = F.pad(Cc, (0, 0, 0, pad)) if pad else Cc
    args = (xh_p, dt_p, A, B_p, C_p)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y = SSDTrain.apply(*args, chunk)
    else:
        y = ssd_scan(*(t.contiguous() for t in args), chunk=chunk)
    y = y[:, :s]
    return _finish(cfg, lp, y, xh, z, lay)


def mamba2_block_decode(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                        x: torch.Tensor, state: Dict[str, torch.Tensor],
                        lay: Optional[Layout] = None):
    """One-token block step.  x (B, 1, d).  state: {"h": (B,H,P,N),
    "conv_x": (B,K-1,d_in), "conv_B": (B,K-1,N), "conv_C": (B,K-1,N)}
    (on a ``lay``, the rank's blocks: ``block_state_specs``).  Returns
    (out, new_state)."""
    p = dims(cfg)[2]
    z, xin, Braw, Craw, dtraw = _project(cfg, lp, x, lay)
    xc, tail_x = causal_conv_step(state["conv_x"], xin, lp["conv_x"])
    Bc, tail_B = causal_conv_step(state["conv_B"], Braw, lp["conv_B"])
    Cc, tail_C = causal_conv_step(state["conv_C"], Craw, lp["conv_C"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    dt, A = _dt_and_A(lp, dtraw)
    xh = _to_heads(xc[:, 0], p, lay)
    y, h_new = ssd_decode_step(state["h"], xh, dt[:, 0], A, Bc[:, 0],
                               Cc[:, 0])
    out = _finish(cfg, lp, y[:, None], xh[:, None], z, lay)
    return out, {"h": h_new, "conv_x": tail_x, "conv_B": tail_B,
                 "conv_C": tail_C}


def init_block_state(cfg: ModelConfig, nl: int, batch: int,
                     device=DEFAULT_DEVICE,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """Stacked zero decode state for nl layers (on ``mesh``, this rank's
    block of each tensor: ``block_state_specs``)."""
    d_in, heads, p, n = dims(cfg)
    dtype, device = dtype_of(cfg.compute_dtype), resolve(device)
    specs = block_state_specs(cfg)

    def z(shape, dt, name):
        if mesh is not None:
            shape = shard_shape(mesh, specs[name], shape)
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "h": z((nl, batch, heads, p, n), torch.float32, "h"),
        "conv_x": z((nl, batch, CONV_K - 1, d_in), dtype, "conv_x"),
        "conv_B": z((nl, batch, CONV_K - 1, N_GROUPS * n), dtype, "conv_B"),
        "conv_C": z((nl, batch, CONV_K - 1, N_GROUPS * n), dtype, "conv_C"),
    }
