"""Serving entry point: batched greedy decode with hedged (replicated) dispatch
(a port of the JAX package's ``launch/serve.py``).

Autoregressive decode is not a linear job, so MDS coding does not apply;
the paper's replication column does: each request batch is hedged across
``r`` replica servers and the first finisher wins.  The number of replicas
is planned from the service-time tail (replication pays off when the tail
is heavy and the deterministic part of latency is small).

The decode steps run for real on the device; the per-replica service times
are simulated with the paper's models.

    python -m repro_torch.launch.serve [--arch qwen3-0.6b] [--device cuda]

``--arch`` takes any architecture id at the reference's TINY scale, whose
``num_experts=0``, ``embedding_inputs=False`` and ``attn_every=0`` make
every model a dense, token-input transformer or a pure SSM here exactly as
in the reference.  ``serve`` itself serves any config with token inputs
and a decode step at any width: the dense, MoE, SSM and hybrid families
(the hybrid's ring-buffer window cache included).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, generator, resolve
from ..configs.base import ModelConfig, get_config
from ..core.distributions import BiModal, Pareto, ShiftedExp
from ..core.order_stats import expected_order_stat
from ..models import api

# the reference's tiny scale and straggler specs (launch/train.py:37-67)
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=512, ssm_state=16, ssm_head_dim=16, num_experts=0,
            attn_every=0, flash_block_kv=64, remat="none",
            embedding_inputs=False, qk_norm=False, head_dim=None,
            compute_dtype="float32", param_dtype="float32")


def parse_dist(spec: str):
    """'bimodal:B:eps' | 'sexp:delta:W' | 'pareto:lam:alpha' | 'none'."""
    if spec == "none":
        return None
    kind, a, b = spec.split(":")
    a, b = float(a), float(b)
    if kind == "bimodal":
        return BiModal(B=a, eps=b)
    if kind == "sexp":
        return ShiftedExp(delta=a, W=b)
    if kind == "pareto":
        return Pareto(lam=a, alpha=b)
    raise ValueError(spec)


def hedge_gain(dist, r: int) -> float:
    """E[min of r] / E[single] for the fitted service-time distribution."""
    single = expected_order_stat(lambda t: dist.tail(t), 1, 1,
                                 scale=max(dist.mean(), 1.0))
    hedged = expected_order_stat(lambda t: dist.tail(t), 1, r,
                                 scale=max(dist.mean(), 1.0))
    return hedged / single


def plan_replicas(dist, max_r: int = 4, cost_weight: float = 0.25) -> int:
    """Smallest r whose marginal latency gain beats the resource cost.

    cost_weight ~ the value of one replica-server's work; the paper's
    replication column corresponds to cost_weight -> 0.
    """
    best_r, best = 1, 1.0
    for r in range(2, max_r + 1):
        score = hedge_gain(dist, r) + cost_weight * (r - 1)
        if score < best:
            best, best_r = score, r
    return best_r


@dataclasses.dataclass(frozen=True)
class ServeResult:
    tokens: np.ndarray          # (B, gen) greedy tokens
    prompt_s: float             # host clock of the prompt's decode steps
    gen_s: float                # host clock of the generation steps
    sim_latency: Optional[float]  # simulated hedged service time, summed
    unhedged: Optional[float]   # E[one replica's service time] * gen

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens per second of the generation loop."""
        return self.tokens.size / self.gen_s


def serve(cfg: ModelConfig, params, tokens: torch.Tensor, gen: int,
          dist=None, r: int = 1) -> ServeResult:
    """Greedy decode of ``gen`` tokens after the prompt ``tokens`` (B, P),
    on the device of ``tokens`` and ``params``: the prompt goes in token by
    token through ``api.decode_step``, as the reference's loop does
    (serve.py:76-95).  With a service-time law ``dist``, each generated
    step's hedged service time is the minimum of ``r`` draws (on the host,
    from a generator seeded 1000 + step)."""
    b, plen = tokens.shape
    device = tokens.device
    cache = api.init_cache(cfg, b, plen + gen, dtype="float32",
                           device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits = None
    for i in range(plen):
        logits, cache = api.decode_step(cfg, params, cache,
                                        tokens[:, i:i + 1], i)
    sync()
    t1 = time.perf_counter()
    out = []
    sim_latency = 0.0 if dist is not None else None
    for i in range(gen):
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        out.append(nxt[:, 0])
        logits, cache = api.decode_step(cfg, params, cache, nxt, plen + i)
        if dist is not None:
            draws = dist.sample(generator(1000 + i, "cpu"), (r,))
            sim_latency += float(draws.min())
    gen_tokens = torch.stack(out, dim=1).cpu().numpy()
    sync()
    t2 = time.perf_counter()
    unhedged = None
    if dist is not None:
        unhedged = expected_order_stat(lambda t: dist.tail(t), 1, 1,
                                       scale=max(dist.mean(), 1.0)) * gen
    return ServeResult(gen_tokens, t1 - t0, t2 - t1, sim_latency, unhedged)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--straggle", default="pareto:0.05:1.8")
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_config(args.arch).scaled(**TINY)
    dist = parse_dist(args.straggle)
    r = plan_replicas(dist, args.max_replicas) if dist else 1
    print(f"hedging plan: r = {r} replicas "
          f"(tail gain {hedge_gain(dist, r):.2f}x)" if dist else "no hedging")

    gen = generator(0, device)
    params = api.init_params(cfg, gen)
    toks = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=device)
    res = serve(cfg, params, toks, args.gen, dist, r)
    print(f"generated {res.tokens.shape} tokens in "
          f"{res.prompt_s + res.gen_s:.2f}s wall on {device}")
    if dist is not None:
        print(f"simulated service latency: hedged {res.sim_latency:.2f} vs "
              f"unhedged E {res.unhedged:.2f} (r={r})")
    print("sample:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
