"""AdamW with global-norm clipping, warmup-cosine schedule and micro-batch
gradient accumulation (a port of the JAX package's ``optim/adamw.py``).

Parameters are a model module (its ``named_parameters``) or a dictionary
of tensors; gradients and the moments are dictionaries under the same
names.  The arithmetic is the reference's, in its order: clip to the
global norm first, then ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
in fp32, the bias corrections ``1 - b ** step`` and the schedule in
float32 (numpy float32 scalars, as ``jnp`` computes them).  Not
``torch.optim.AdamW``, whose order and rounding differ.

Where the reference returns new pytrees, ``apply_updates`` updates the
parameters and the moments in place (one copy of each on the device) and
returns them.  Each tensor is updated on its own, in slices of at most
``UPDATE_SLICE`` elements, so the temporaries are the size of one slice,
not of the model or of a stacked expert leaf; the arithmetic is
elementwise, so the slices give the same values.  ``state_shapes`` is the
state as ``meta`` tensors (``launch.steps``' train cell); ``state_specs``
its partition specs, the moments' those of their parameters.

On a mesh the parameters, gradients and moments are a rank's blocks: the
update is elementwise, so it runs on them as they are, and the global
norm that clips the gradients sums every leaf's squares over the whole
mesh, a leaf held by ``replicas[name]`` ranks counted once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterable, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch

from .. import parallel
from ..obs import recorder as _trace
from ..sharding import P
from ..models.params import dtype_of

Params = Union[torch.nn.Module, Dict[str, torch.Tensor]]

#: elements of one leaf updated at a time: five fp32 temporaries of a
#: slice are 640 MB, where those of dbrx-132b's stacked expert leaf (1.06 B
#: elements a layer) would be 21 GB
UPDATE_SLICE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # schedule
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # moment dtype (fp32 default; bf16 halves optimizer memory)
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: int                            # updates applied so far
    mu: Dict[str, torch.Tensor]          # first moment, by parameter name
    nu: Dict[str, torch.Tensor]          # second moment


def named(params: Params) -> Dict[str, torch.Tensor]:
    """``params`` as a dictionary name -> tensor: a module's named
    parameters, or a dictionary whose nested dictionaries (such as
    ``models.api.param_shapes``'s tree) give dotted names."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out.update({f"{key}.{n}": t for n, t in named(value).items()})
        else:
            out[key] = value
    return out


def init(cfg: AdamWConfig, params: Params) -> OptState:
    dt = dtype_of(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    leaves = named(params)
    return OptState(step=0, mu={n: zeros(p) for n, p in leaves.items()},
                    nu={n: zeros(p) for n, p in leaves.items()})


def state_shapes(cfg: AdamWConfig, param_shapes: Params) -> OptState:
    """``init``'s state as ``meta`` tensors (shape and dtype, no storage):
    step 0 and the moments in ``cfg.moment_dtype`` by parameter name."""
    dt = dtype_of(cfg.moment_dtype)
    leaves = named(param_shapes)
    meta = lambda p: torch.empty(p.shape, dtype=dt, device="meta")  # noqa: E731
    return OptState(step=0, mu={n: meta(p) for n, p in leaves.items()},
                    nu={n: meta(p) for n, p in leaves.items()})


def state_specs(param_specs) -> OptState:
    """Partition specs of the state: the step replicated, each moment
    sharded as its parameter (``param_specs``: ``models.api.
    partition_specs``' tree), by parameter name."""
    specs = named(param_specs)
    return OptState(step=P(), mu=dict(specs), nu=dict(specs))


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in float32."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = np.clip((step - f32(cfg.warmup_steps))
                / f32(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    cos = f32(cfg.min_lr_ratio) + f32((1 - cfg.min_lr_ratio) * 0.5) * (
        f32(1.0) + np.cos(f32(math.pi) * t))
    return float(f32(cfg.lr) * warm * cos)


def global_norm(tree: Params, replicas: Optional[Dict[str, int]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (0-d tensor).
    With a ``group`` of more than one rank (the whole mesh) the tensors
    are a rank's blocks: each leaf's sum of squares over ``replicas[name]``
    (the ranks that hold the same block), summed over the group by one
    all-reduce."""
    leaves = named(tree)
    norms = torch._foreach_norm([x.float() for x in leaves.values()])
    if parallel.size(group) == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    counts = torch.tensor([float(replicas[n]) for n in leaves],
                          device=norms[0].device)
    sq = (torch.stack(norms).square() / counts).sum()
    return parallel.all_reduce(sq, group).sqrt()


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to at most ``max_norm`` in global norm, the norm);
    new tensors, in the gradients' dtypes."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


def apply_updates(cfg: AdamWConfig, params: Params,
                  grads: Dict[str, torch.Tensor], state: OptState,
                  replicas: Optional[Dict[str, int]] = None, group=None):
    """One AdamW step; returns (params, new_state, metrics) with
    ``metrics = {"grad_norm": 0-d tensor, "lr": float}``.  The parameters
    and the moments are updated in place; ``grads`` is read only.  On a
    mesh (``replicas``, ``group``: ``global_norm``'s) every tensor is the
    rank's block.  The global norm, the clip and the update are the span
    ``optim.adamw``."""
    leaves = named(params)
    with _trace.span("optim.adamw",
                     device=next(iter(leaves.values())).device):
        gnorm = global_norm(grads, replicas, group)
        scale = _clip_scale(gnorm, cfg.clip_norm)
        step = state.step + 1
        lr = schedule(cfg, step)
        f32 = np.float32
        b1, b2 = cfg.b1, cfg.b2
        c1 = float(f32(1.0) - f32(b1) ** f32(step))
        c2 = float(f32(1.0) - f32(b2) ** f32(step))
        with torch.no_grad():
            for name, p in leaves.items():
                g = grads[name].reshape(-1)
                p_all, m_all, v_all = (t.view(-1) for t in
                                       (p, state.mu[name], state.nu[name]))
                for lo in range(0, p_all.numel(), UPDATE_SLICE):
                    part = slice(lo, lo + UPDATE_SLICE)
                    p_, m, v = p_all[part], m_all[part], v_all[part]
                    g32 = (g[part].float() * scale).to(g.dtype).float()
                    m32, v32 = m.float(), v.float()  # the moments if fp32
                    m32.mul_(b1).add_(g32, alpha=1 - b1)
                    v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                    p32 = p_.float()
                    delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
                    delta.add_(p32, alpha=cfg.weight_decay)
                    p32.sub_(delta, alpha=lr)
                    for dst, src in ((p_, p32), (m, m32), (v, v32)):
                        if dst is not src:
                            dst.copy_(src)
        return params, OptState(step, state.mu, state.nu), \
            {"grad_norm": gnorm, "lr": lr}


def accumulate_grads(loss_fn: Callable, params: Params,
                     batches: Iterable, num_micro: int):
    """Sequential micro-batch gradient accumulation.

    ``loss_fn(params, micro) -> scalar``; ``batches``: ``num_micro``
    micro-batches (a tensor or sequence with a leading ``num_micro``
    axis).  Returns (mean loss, mean grads by name), fp32.
    """
    leaves = named(params)
    names = list(leaves)
    loss = torch.zeros((), dtype=torch.float32)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in leaves.items()}
    for i in range(num_micro):
        li = loss_fn(params, batches[i])
        gi = torch.autograd.grad(li, [leaves[n] for n in names])
        loss = loss.to(li.device) + li.detach().float() / num_micro
        for n, g in zip(names, gi):
            acc[n] += g.float() / num_micro
    return loss, acc
