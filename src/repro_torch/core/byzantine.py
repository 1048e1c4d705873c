"""Byzantine fault models (paper §4, eq. (17): faulty agents send an
arbitrary vector). Each attack maps the would-be honest gradient (and
context) to the sent vector."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def sign_flip(g, rng, scale: float = 2.0):
    return -scale * g


def random_gaussian(g, rng, scale: float = 10.0):
    return scale * rng.normal(size=g.shape)


def large_norm(g, rng, scale: float = 1e3):
    return scale * np.ones_like(g)


def zero(g, rng, scale: float = 0.0):
    return np.zeros_like(g)


def little_is_enough(g, rng, scale: float = 0.3):
    """Small coordinated perturbation (hard for norm-based filters)."""
    return g + scale * np.sign(g) * np.abs(g).mean()


ATTACKS: Dict[str, Callable] = {
    "sign_flip": sign_flip,
    "random_gaussian": random_gaussian,
    "large_norm": large_norm,
    "zero": zero,
    "little_is_enough": little_is_enough,
}
