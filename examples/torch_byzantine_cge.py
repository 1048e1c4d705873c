"""Byzantine + straggler tolerance (§4) on the PyTorch port: CGE gradient
filter with f faulty agents sending adversarial vectors AND r stragglers
dropped per round. The same setup and output as
``examples/byzantine_cge.py``; the aggregation runs on the card unless
``--device cpu``. The default ``--agg-backend host`` applies the
reference rule op by op, as the reference example does; ``device`` runs
each iteration through the resident ledger and the rule's CUDA kernel
(CGE: ``masked_cge_reduce``).

    PYTHONPATH=src python examples/torch_byzantine_cge.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.async_engine import (AsyncEngine, EngineConfig,
                                           default_latency)
from repro_torch.core.redundancy import (certify_f_r_eps,
                                         make_redundant_quadratics)

N, D, R, F = 12, 6, 2, 2


def run(rule, attack, device="cuda", agg_backend="host"):
    costs = make_redundant_quadratics(N, D, spread=0.02, cond=1.5, seed=3)
    mu = costs.mu()
    eng = AsyncEngine(
        lambda j, x, rng: costs.grad(j, x), np.zeros(D),
        EngineConfig(n_agents=N, r=R, f=F, rule=rule, byz_ids=(0, 5),
                     attack=attack,
                     step_size=lambda t: 0.3 / (mu * N) / (1 + 3e-3 * t),
                     proj_gamma=50.0, agg_backend=agg_backend,
                     device=device),
        latency=default_latency(N, 2, 8.0),
        x_star=costs.global_min())
    return eng.run(2000).dist[-1]


def main(argv=None):
    """Runs the example; returns the lines it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--agg-backend", default="host",
                    choices=("host", "device"))
    args = ap.parse_args(argv)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    costs = make_redundant_quadratics(N, D, spread=0.02, cond=1.5, seed=3)
    eps = certify_f_r_eps(costs, F, R, samples=600)
    say(f"certified (f={F}, r={R}; eps={eps:.4f})-redundancy "
        f"(Definition 3)\n")
    say(f"{'attack':<18} {'no filter':>10} {'CGE':>8} {'trimmed':>8}")
    for attack in ("large_norm", "sign_flip", "random_gaussian"):
        d_sum, d_cge, d_tm = (run(rule, attack, args.device,
                                  args.agg_backend)
                              for rule in ("sum", "cge", "trimmed_mean"))
        say(f"{attack:<18} {d_sum:>10.4f} {d_cge:>8.4f} {d_tm:>8.4f}")
    say("\nCGE/trimmed-mean stay near x*; the unfiltered sum is driven "
        "to the boundary of W (Theorem 6 vs no-filter).")
    return lines


if __name__ == "__main__":
    main()
