"""Capacity-based top-k Mixture-of-Experts FFN (a port of the JAX
package's ``models/moe.py``).

Dense dispatch: tokens are grouped, routed top-k, and placed into per-expert
capacity slots via one-hot dispatch/combine products (no ragged ops).

Capacity per expert per group:  C = ceil(g * top_k / E * capacity_factor),
rounded up to a multiple of 4.  Overflow tokens are dropped (standard
capacity-based behaviour); the router uses softmax-then-top-k with
probabilities renormalised over the selected experts (DBRX/Qwen3
convention).

The reference's ``constrain`` calls and its ``moe_a2a`` switch say how
GSPMD moves the expert outputs between the expert and the group axes of
a mesh (an all-to-all of the capacity rows, under the switch, instead of
a sum over the expert axis).  In the port every model rank holds its
data rank's tokens and routes them whole (the router is replicated over
``model``); with ``experts`` it runs its slice of the expert axis of
``dispatch`` and ``combine`` (expert parallelism), else every expert on
the FFN columns it holds, and its output is a partial sum that the
caller reduces over ``model`` (``models.transformer``).  So the port has
the one path, and ``moe_a2a`` is accepted (``layers.opt_enabled``) and
changes nothing.  The groups are the reference's, formed over the global
batch's tokens in order: g = min(``GROUP_SIZE``, the global token count).
On a mesh (``split``) a rank whose tokens are whole groups routes them
alone; otherwise it gathers the tokens over the ranks that hold the batch
(all-gather forward, a sum over the ranks and its block backward, as an
FSDP gather), routes the groups its own tokens fall in, and keeps its
rows.  The router, dispatch, expert and combine products are plain
matrix products outside any kernel, as the reference leaves them to XLA
(``torch.einsum``, in ``x.dtype``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import parallel

#: tokens a group (the reference's ``moe_ffn`` default)
GROUP_SIZE = 256


def expert_capacity(group_size: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(group_size * top_k / num_experts * capacity_factor + 0.999)
    return max(4, (c + 3) // 4 * 4)


def route(xg: torch.Tensor, router: torch.Tensor, top_k: int,
          cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine), each (ng, g, E, C) in ``xg.dtype``, for the
    grouped tokens ``xg`` (ng, g, d): token t of a group sits in slot c of
    expert e with weight combine[., t, e, c]; a (token, expert) pair past
    the expert's capacity ``cap`` has no slot (it is dropped)."""
    e = router.shape[1]
    logits = torch.einsum("ngd,de->nge", xg, router.to(xg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k: descending, the lower expert first among equal
    # probabilities; a stable descending sort picks the same experts
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)

    ng, g = xg.shape[:2]
    # one-hot expert assignment per top-k slot: (ng, g, k, E)
    assign = F.one_hot(gate_idx, e).float()
    # position of each (token, slot) within its expert queue, priority by
    # (slot, token) order: cumsum over the flattened (k, g) axis
    assign_kg = assign.transpose(1, 2).reshape(ng, top_k * g, e)
    pos_kg = torch.cumsum(assign_kg, dim=1) - assign_kg      # 0-based
    pos = pos_kg.reshape(ng, top_k, g, e).transpose(1, 2)    # (ng, g, k, E)
    keep = (pos < cap).float() * assign                      # drop overflow
    gate = gate_vals[..., None] * keep                       # (ng, g, k, E)

    # an expert is picked at most once per token, so the top-k axis is
    # reduced before the capacity one-hot: no (ng, g, k, E, C) tensor
    pos_r = (pos * keep).sum(dim=2)                          # (ng, g, E)
    keep_r = keep.sum(dim=2)                                 # 0/1
    gate_r = gate.sum(dim=2)
    oh = (F.one_hot(pos_r.long(), cap).to(xg.dtype)
          * keep_r[..., None].to(xg.dtype))                  # (ng, g, E, C)
    return oh, oh * gate_r[..., None].to(xg.dtype)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25,
            group_size: int = GROUP_SIZE,
            experts: Optional[slice] = None, split=None) -> torch.Tensor:
    """Top-k capacity-dispatch MoE with SwiGLU experts: x (B, S, d),
    router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d) -> (B, S, d)
    in ``x.dtype``.  ``experts``: the weights are those experts of the E
    that the router scores (expert parallelism), and the output is their
    part of the sum.  ``split``: the process group whose ranks hold the
    global batch's rows in blocks, in rank order, this rank ``x`` (None:
    ``x`` is the whole batch)."""
    b, s, d = x.shape
    e = router.shape[1]
    local = b * s
    tokens = local * parallel.size(split)
    g = min(group_size, tokens)
    if tokens % g:
        raise ValueError(f"tokens={tokens} not divisible by group={g}")
    cap = expert_capacity(g, e, top_k, capacity_factor)

    xs = x.reshape(local, d)
    keep = slice(0, local)
    if local % g:
        # part groups: the groups this rank's tokens fall in, from every
        # rank's tokens
        lo = parallel.rank(split) * local
        first, last = lo // g, -(-(lo + local) // g)
        xs = parallel.gather_data(xs, 0, split)[first * g:last * g]
        keep = slice(lo - first * g, lo - first * g + local)
    ng = xs.shape[0] // g
    xg = xs.reshape(ng, g, d)
    dispatch, combine = route(xg, router, top_k, cap)
    if experts is not None:
        dispatch, combine = dispatch[:, :, experts], combine[:, :, experts]
    xin = torch.einsum("ngec,ngd->necd", dispatch, xg)
    h_g = torch.einsum("necd,edf->necf", xin, w_gate.to(x.dtype))
    h_u = torch.einsum("necd,edf->necf", xin, w_up.to(x.dtype))
    h = F.silu(h_g) * h_u
    xout = torch.einsum("necf,efd->necd", h, w_down.to(x.dtype))
    y = torch.einsum("ngec,necd->ngd", combine, xout)
    return y.reshape(-1, d)[keep].reshape(b, s, d)
