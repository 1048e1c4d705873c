"""Step-size schedules. ``inv_t`` is the paper's Theorem 2(b) c/(t+1);
``constant`` is Theorem 2(a). Both satisfy the Robbins-Monro conditions the
asymptotic theorems need (constant does not — the paper analyzes it for the
linear-rate result instead)."""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(eta: float) -> Schedule:
    return lambda t: eta


def inv_t(c: float) -> Schedule:
    return lambda t: c / (t + 1.0)


def inv_sqrt(c: float, warmup: int = 0) -> Schedule:
    def f(t):
        if warmup and t < warmup:
            return c * (t + 1) / warmup
        return c / math.sqrt(max(t - warmup + 1, 1))
    return f


def cosine(peak: float, total: int, warmup: int = 0,
           floor: float = 0.0) -> Schedule:
    def f(t):
        if warmup and t < warmup:
            return peak * (t + 1) / warmup
        frac = min(max(t - warmup, 0) / max(total - warmup, 1), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * frac))
    return f


def paper_eta_bar(mu: float, gamma: float, alpha: float, n: int) -> float:
    """Theorem 2's stability ceiling: eta_bar = 2*gamma*alpha / (mu^2 n)."""
    return 2.0 * gamma * alpha / (mu ** 2 * n)
