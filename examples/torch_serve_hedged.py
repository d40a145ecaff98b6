"""Hedged serving on the PyTorch port: the paper's replication column
applied to autoregressive decoding (coding does not apply to a nonlinear
job — DESIGN.md §6), with tail-latency planning from fitted telemetry.

    PYTHONPATH=src python examples/torch_serve_hedged.py               # card
    PYTHONPATH=src python examples/torch_serve_hedged.py --device cpu

The twin of ``examples/serve_hedged.py``: the service-time draws come
from seeded ``torch.Generator``s on ``--device``; the fit and the
replica plan are host numpy.
"""
import argparse

import numpy as np

from repro_torch._device import generator
from repro_torch.core.distributions import Pareto
from repro_torch.launch.serve import hedge_gain, plan_replicas
from repro_torch.runtime import Telemetry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the service times are drawn (default "
                         "cuda; cpu for the host)")
    args = ap.parse_args(argv)

    # 1. observe per-request latencies (simulated heavy-tail service)
    dist_true = Pareto(0.05, 1.6)
    telem = Telemetry(window=4096)
    telem.record_step(dist_true.sample(generator(0, args.device),
                                       (4096,)).cpu().numpy())
    fitted, family = telem.fit()
    print(f"fitted service model: {family} {fitted}")
    print(f"tail stats: {telem.straggle_stats()}")

    # 2. plan hedging
    for cost in (0.0, 0.1, 0.25, 0.5):
        r = plan_replicas(fitted, max_r=6, cost_weight=cost)
        print(f"  replica cost weight {cost:.2f} -> hedge r = {r} "
              f"(latency x{hedge_gain(fitted, r):.2f})")

    # 3. measure hedged tail latency
    draws = dist_true.sample(generator(1, args.device),
                             (20_000, 4)).cpu().numpy()
    for r in (1, 2, 4):
        lat = draws[:, :r].min(axis=1)
        print(f"  r={r}: mean {lat.mean():.3f}  p99 {np.quantile(lat, .99):.3f}")
    print("hedging collapses the p99 tail -- the paper's replication "
          "(k=1) column realized for serving")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
