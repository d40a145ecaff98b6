"""Plain PyTorch versions of the Mamba2 SSD scan (G = 1: B and C shared
over heads).

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;   y_t = C_t h_t

``ssd_chunked`` is the port of ``models/mamba2.py::ssd_chunked``: the
chunked form the model computes, which the CUDA kernel is held to and the
wrapper runs for tensors on the CPU.  ``models/mamba2.py`` imports it from
here.  ``ssd_ref`` is the port of the sequential oracle
``ssd_scan/ref.py::ssd_ref``, the mathematically unambiguous form both are
tested against.

x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N); inside fp32, y in
``x.dtype``, the final state (B, H, P, N) in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD.  Returns (y (B,S,H,P), h_final (B,H,P,N)).  S must be a
    multiple of ``chunk``."""
    b, s, h, p = x.shape
    n = Bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    f32 = torch.float32
    xs = x.reshape(b, nc, chunk, h, p).to(f32)
    dts = dt.reshape(b, nc, chunk, h).to(f32)
    Bs = Bmat.reshape(b, nc, chunk, n).to(f32)
    Cs = Cmat.reshape(b, nc, chunk, n).to(f32)
    A32 = A.to(f32)
    tmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    hstate = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
              if h0 is None else h0.to(f32))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xs[:, c], dts[:, c], Bs[:, c], Cs[:, c]
        dA = dtc * A32                                          # (B,Q,H)
        lcum = torch.cumsum(dA, dim=1)                          # inclusive
        # intra-chunk term: decay(t, s) = exp(lcum_t - lcum_s) for s <= t
        diff = lcum[:, :, None, :] - lcum[:, None, :, :]        # (B,Q,Q,H)
        decay = torch.where(tmask[None, :, :, None], torch.exp(diff),
                            torch.zeros((), dtype=f32, device=x.device))
        cb = torch.einsum("bqn,bsn->bqs", Cc, Bc)               # (B,Q,Q)
        w = cb[..., None] * decay * dtc[:, None, :, :]          # (B,Q,Q,H)
        y_intra = torch.einsum("bqsh,bshp->bqhp", w, xc)
        # chunk state and inter-chunk term
        tail = lcum[:, -1:, :] - lcum                           # l_Q - l_s
        wB = Bc[:, :, None, :] * (torch.exp(tail) * dtc)[..., None]
        state = torch.einsum("bqhn,bqhp->bhpn", wB, xc)
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cc, hstate) * \
            torch.exp(lcum)[..., None]
        hstate = hstate * torch.exp(lcum[:, -1, :])[:, :, None, None] + state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), hstate


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor):
    """The sequential recurrence, one step at a time.  Returns
    (y (B,S,H,P) in ``x.dtype``, h_final (B,H,P,N) fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f32 = torch.float32
    hstate = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        dA = torch.exp(dtt * A.to(f32))                         # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None],
                           Bm[:, t].to(f32))
        hstate = hstate * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), hstate
