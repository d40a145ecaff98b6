"""The port's form of the hybrid (zamba2-1.2b): Mamba2 layers and, after
every ``attn_every``-th of them, one shared attention + MLP block.

A Mamba2 layer: RMSNorm; z, x, B, C, dt projections; a width-4 depthwise
causal convolution and SiLU on x, B and C; dt = softplus(dt_raw +
dt_bias), A = -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t^T, y_t = C_t h_t computed in chunks; y + D x; RMSNorm of y *
silu(z); the out projection.  The shared block is the dense decoder's
layer without qk-norm on the d-wide stream, its attention keeping the
last ``window`` keys; its leaves are ``shared_attn.<name>``.

The file's published keys (``mamba_d_state``, ``mamba_headdim``, ...) and
``run.attn_every``, ``run.attn_window``, ``run.attn_head_dim``.  Counts:
the shared block counts once for each site it is applied at, and the SSD
scan's operations (``counts.ssd_cost``) once a layer.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import counts, weights
from ..reference import model
from ..reference.model import Params, _proj, causal_conv, rms, ssd
from ..reference.numerics import Numerics
from ..spec import common
from . import dense


@dataclasses.dataclass(frozen=True)
class HybridSpec(dense.DenseSpec):
    ssm_state: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 0
    ssm_chunk: int = 0
    conv_k: int = 4
    attn_every: int = 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def sites(self) -> int:
        """Applications of the shared block."""
        return self.layers // self.attn_every if self.attn_every else 0


def spec_of(config: dict) -> HybridSpec:
    run = config["run"]
    return HybridSpec(**common(config), qk_norm=run.get("qk_norm", False),
                      ssm_state=config["mamba_d_state"],
                      ssm_head_dim=config["mamba_headdim"],
                      ssm_expand=config["mamba_expand"],
                      ssm_chunk=config["chunk_size"],
                      conv_k=config.get("mamba_d_conv", 4),
                      attn_every=run.get("attn_every", 0))


def program_checks(s: HybridSpec, run: dict) -> dict:
    return {**dense.program_checks(s, run), "ssm_state": s.ssm_state,
            "attn_every": s.attn_every, "ssm_head_dim": s.ssm_head_dim,
            "ssm_expand": s.ssm_expand, "ssm_chunk": s.ssm_chunk}


def mamba_shapes(s: HybridSpec) -> weights.Shapes:
    """One Mamba2 layer's leaves."""
    d, di, h, n, k = s.d, s.d_inner, s.ssm_heads, s.ssm_state, s.conv_k
    return {"norm": (d,), "wz": (d, di), "wx": (d, di), "wB": (d, n),
            "wC": (d, n), "wdt": (d, h), "conv_x": (k, di), "conv_B": (k, n),
            "conv_C": (k, n), "A_log": (h,), "D": (h,), "dt_bias": (h,),
            "gate_norm": (di,), "out_proj": (di, d)}


def param_shapes(s: HybridSpec) -> weights.Shapes:
    out = weights.decoder_layout(s, mamba_shapes(s))
    if s.sites:
        out.update({f"shared_attn.{n}": sh
                    for n, sh in dense.block_shapes(s).items()})
    return out


def fan_in(s: HybridSpec, name: str) -> int:
    leaf = name.split(".")[-1]
    if leaf.startswith("conv"):
        return s.conv_k
    return s.d_inner if leaf == "out_proj" else dense.fan_in(s, name)


def mamba_layer(spec: HybridSpec, num: Numerics, lp: Params,
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


def hidden(spec: HybridSpec, num: Numerics, P: Params, tokens: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    x = P["embed"][tokens]
    sp = {n[len("shared_attn."):]: t for n, t in P.items()
          if n.startswith("shared_attn.")}
    for i in range(spec.layers):
        x = model.run_layer(lambda x, i=i: mamba_layer(
            spec, num, model.layer_params(P, i), x), x, remat)
        if spec.attn_every and (i + 1) % spec.attn_every == 0 \
                and (i + 1) // spec.attn_every <= spec.sites:
            x = model.run_layer(lambda x: dense.decoder_layer(
                spec, num, sp, x, spec.window), x, remat)
    return rms(x, P["final_norm"], spec.eps)


def mamba_matrices(s: HybridSpec) -> float:
    """A Mamba2 layer's projections (its convolutions are not products)."""
    return dense.matrices({n: sh for n, sh in mamba_shapes(s).items()
                           if not n.startswith("conv")})


def matmul_params(s: HybridSpec) -> float:
    """Every layer's projections, the head, and the shared block once a
    site."""
    return (s.layers * mamba_matrices(s) + s.d * s.vocab_pad
            + s.sites * dense.matrices(dense.block_shapes(s)))


def ssd_flops(s: HybridSpec, batch: int, seq: int) -> float:
    return s.layers * counts.ssd_cost(batch, seq, s.ssm_heads,
                                      s.ssm_head_dim, s.ssm_state,
                                      s.ssm_chunk)[0]


def model_flops(s: HybridSpec, batch: int, seq: int, train: bool) -> float:
    flops = dense.forward_flops(s, matmul_params(s), s.sites, batch, seq)
    flops += ssd_flops(s, batch, seq)
    return 3.0 * flops if train else flops
