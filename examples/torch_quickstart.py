"""Quickstart on the PyTorch port: Algorithm 1 on certified
(r, eps)-redundant costs.

Builds n=10 quadratic agents, certifies their (r, eps)-redundancy exactly,
runs the asynchronous server (waits for n-r fastest each round), and checks
the Theorem-1 error bound. The same setup and output as
``examples/quickstart.py``; the aggregation runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.async_engine import (AsyncEngine, EngineConfig,
                                           default_latency)
from repro_torch.core.redundancy import (certify_r_eps,
                                         make_redundant_quadratics,
                                         theoretical_bound)

N, D, R = 10, 5, 3


def main(argv=None):
    """Runs the example; returns the lines it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    costs = make_redundant_quadratics(N, D, spread=0.03, cond=1.5, seed=1)
    eps = certify_r_eps(costs, R, samples=3000)
    alpha, bound, gamma = theoretical_bound(costs, R, eps)
    mu = costs.mu()
    say(f"certified (r={R}, eps={eps:.4f})-redundancy; "
        f"mu={mu:.3f} gamma={gamma:.3f} alpha={alpha:.3f}")
    say(f"Theorem 1 bound: D = 2*r*mu*eps/(alpha*gamma) = {bound:.4f}")

    engine = AsyncEngine(
        grad_fn=lambda j, x, rng: costs.grad(j, x),
        x0=np.zeros(D),
        cfg=EngineConfig(
            n_agents=N, r=R, rule="sum",
            step_size=lambda t: 0.3 / (mu * N) / (1 + 3e-3 * t),
            proj_gamma=50.0, device=args.device),
        latency=default_latency(N, n_stragglers=2, factor=8.0),
        loss_fn=costs.loss, x_star=costs.global_min())

    hist = engine.run(3000)
    say(f"after 3000 rounds: ||x - x*|| = {hist.dist[-1]:.5f} "
        f"(<= D: {hist.dist[-1] <= bound})")
    say(f"cumulative communication time: {hist.cum_comm[-1]:.1f}s "
        f"(synchronous baseline would wait for every straggler)")
    return lines


if __name__ == "__main__":
    main()
