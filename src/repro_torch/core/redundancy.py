"""(r, eps)-redundancy (Def. 1) and (f, r; eps)-redundancy (Def. 3):
construction and certification.

For quadratic costs Q_i(x) = 0.5 x'A_i x - b_i'x the subset minimizer is
closed-form, so redundancy parameters are computable *exactly* (exhaustive
over subsets for small n, sampled otherwise). This is the ground truth the
theory tests (Thms 1-4, 6) check against.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass
class QuadraticCosts:
    """Agent i: Q_i(x) = 0.5 x'A_i x - b_i'x. A: (n,d,d) SPD, b: (n,d)."""
    a: np.ndarray
    b: np.ndarray

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def d(self) -> int:
        return self.a.shape[1]

    def subset_min(self, idx: Sequence[int]) -> np.ndarray:
        idx = list(idx)
        return np.linalg.solve(self.a[idx].sum(0), self.b[idx].sum(0))

    def global_min(self) -> np.ndarray:
        return self.subset_min(range(self.n))

    def grad(self, i: int, x: np.ndarray) -> np.ndarray:
        return self.a[i] @ x - self.b[i]

    def grads(self, x: np.ndarray) -> np.ndarray:
        return np.einsum("ndk,k->nd", self.a, x) - self.b

    def loss(self, x: np.ndarray) -> float:
        return float(0.5 * x @ self.a.sum(0) @ x - self.b.sum(0) @ x)

    # -- constants for the theory ------------------------------------------
    def mu(self) -> float:
        """Lipschitz-smoothness: max_i lambda_max(A_i) (Assumption 1)."""
        return float(max(np.linalg.eigvalsh(ai)[-1] for ai in self.a))

    def gamma(self, r: int, samples: int = 200,
              rng: Optional[np.random.Generator] = None) -> float:
        """Strong convexity of subset *averages* |S| >= n-r (Assumption 2)."""
        rng = rng or np.random.default_rng(0)
        gam = np.inf
        for s in _subsets(self.n, self.n - r, samples, rng):
            avg = self.a[list(s)].mean(0)
            gam = min(gam, float(np.linalg.eigvalsh(avg)[0]))
        return gam


def _subsets(n: int, min_size: int, samples: int,
             rng: np.random.Generator):
    """All subsets of size in [min_size, n] if few enough, else sampled
    (biased to size=min_size where the extremes live)."""
    total = sum(_ncr(n, k) for k in range(min_size, n + 1))
    if total <= samples:
        for k in range(min_size, n + 1):
            yield from itertools.combinations(range(n), k)
    else:
        for _ in range(samples):
            k = min_size if rng.random() < 0.7 else int(
                rng.integers(min_size, n + 1))
            yield tuple(rng.choice(n, size=k, replace=False))


def _ncr(n, k):
    import math
    return math.comb(n, k)


def certify_r_eps(costs: QuadraticCosts, r: int, samples: int = 500,
                  rng: Optional[np.random.Generator] = None) -> float:
    """Smallest eps such that (r, eps)-redundancy (Def. 1) holds
    (exact if subsets enumerable, else a sampled lower bound)."""
    rng = rng or np.random.default_rng(0)
    x_star = costs.global_min()
    eps = 0.0
    for s in _subsets(costs.n, costs.n - r, samples, rng):
        xs = costs.subset_min(s)
        eps = max(eps, float(np.linalg.norm(xs - x_star)))
    return eps


def certify_f_r_eps(costs: QuadraticCosts, f: int, r: int,
                    samples: int = 500,
                    rng: Optional[np.random.Generator] = None) -> float:
    """Smallest eps for (f, r; eps)-redundancy (Def. 3): distance between
    minimizers of any |S| = n-f and any nested |Shat| >= n-r-2f."""
    rng = rng or np.random.default_rng(0)
    n = costs.n
    eps = 0.0
    for _ in range(samples):
        s = tuple(rng.choice(n, size=n - f, replace=False))
        xs = costs.subset_min(s)
        lo = max(n - r - 2 * f, 1)
        k = int(rng.integers(lo, len(s) + 1))
        shat = tuple(rng.choice(list(s), size=k, replace=False))
        eps = max(eps, float(np.linalg.norm(costs.subset_min(shat) - xs)))
    return eps


def theoretical_bound(costs: QuadraticCosts, r: int, eps: float,
                      samples: int = 200) -> Tuple[float, float, float]:
    """Theorem 1: returns (alpha, D, gamma). D = 2 r mu eps / (alpha gamma),
    alpha = 1 - (r/n)(mu/gamma). Requires alpha > 0."""
    mu = costs.mu()
    gam = costs.gamma(r, samples)
    alpha = 1.0 - (r / costs.n) * (mu / gam)
    d = np.inf if alpha <= 0 else 2 * r * mu * eps / (alpha * gam)
    return alpha, d, gam


# ---------------------------------------------------------------------------
# constructions with controllable redundancy


def make_redundant_quadratics(n: int, d: int, spread: float = 0.0,
                              cond: float = 5.0, seed: int = 0
                              ) -> QuadraticCosts:
    """Agents share a base quadratic; ``spread`` perturbs each agent's
    (A_i, b_i). spread=0 gives exact r-redundancy (Def. 2) for every r<n:
    all agents minimize at the same point."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    eigs = np.linspace(1.0, cond, d)
    a0 = q @ np.diag(eigs) @ q.T
    x_star = rng.normal(size=d)
    a = np.empty((n, d, d))
    b = np.empty((n, d))
    for i in range(n):
        qi, _ = np.linalg.qr(rng.normal(size=(d, d)))
        ei = eigs * (1.0 + spread * rng.uniform(-1, 1, size=d))
        a[i] = (1 - spread) * a0 + spread * (qi @ np.diag(ei) @ qi.T)
        # b_i = A_i x* + spread * noise -> all minimize near x_star
        b[i] = a[i] @ x_star + spread * rng.normal(size=d)
    return QuadraticCosts(a=a, b=b)


def make_shared_data_costs(n: int, d: int, n_data: int, overlap: int = 1,
                           noise: float = 0.1, seed: int = 0
                           ) -> QuadraticCosts:
    """Linear-regression agents over a shared data pool: each datum is
    assigned to ``overlap`` agents (replication creates redundancy, the
    distributed-learning story of §1.1). Q_i = mean squared error on D_i."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_data, d))
    w_true = rng.normal(size=d)
    ys = xs @ w_true + noise * rng.normal(size=n_data)
    a = np.zeros((n, d, d))
    b = np.zeros((n, d))
    counts = np.zeros(n)
    for j in range(n_data):
        owners = rng.choice(n, size=min(overlap, n), replace=False)
        for i in owners:
            a[i] += np.outer(xs[j], xs[j])
            b[i] += ys[j] * xs[j]
            counts[i] += 1
    counts = np.maximum(counts, 1)[:, None]
    return QuadraticCosts(a=a / counts[..., None], b=b / counts)
