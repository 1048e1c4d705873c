"""Synthetic datasets.

The container ships no MNIST, so the paper-reproduction experiments use a
distributional stand-in: 10-class images built from smooth random class
prototypes + per-sample noise/shift (same 28x28x1 shape, same train/test
protocol, genuinely learnable by LeNet). EXPERIMENTS.md documents the swap.

LM token streams are order-k Markov chains over a Zipf vocabulary — the
cross-entropy floor is the chain entropy, so training curves show real
learning on CPU-scale examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return self.x.shape[0]


def _smooth_noise(rng, shape, k: int = 5):
    base = rng.normal(size=shape)
    kernel = np.ones(k) / k
    for ax in (-2, -1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), ax, base)
    return base


def mnist_like(n_train: int = 6000, n_test: int = 1000, n_classes: int = 10,
               noise: float = 0.35, seed: int = 0
               ) -> Tuple[Dataset, Dataset]:
    """(train, test) of (N,28,28,1) float images in [-1,1], int labels."""
    rng = np.random.default_rng(seed)
    protos = _smooth_noise(rng, (n_classes, 28, 28)) * 2.0

    def make(n):
        y = rng.integers(0, n_classes, size=n)
        x = protos[y]
        # random small translation (keeps the task non-trivial)
        sx, sy = rng.integers(-2, 3, size=(2, n))
        x = np.stack([np.roll(np.roll(xi, a, 0), b, 1)
                      for xi, a, b in zip(x, sx, sy)])
        x = x + noise * rng.normal(size=x.shape)
        return Dataset(np.tanh(x)[..., None].astype(np.float32),
                       y.astype(np.int32))

    return make(n_train), make(n_test)


def markov_tokens(n_tokens: int, vocab: int = 256, order_state: int = 64,
                  seed: int = 0) -> np.ndarray:
    """Token stream from a random sparse Markov chain (learnable LM data)."""
    rng = np.random.default_rng(seed)
    # each state points to a small plausible next-token set
    nxt = rng.integers(0, vocab, size=(order_state, 8))
    out = np.empty(n_tokens, np.int32)
    s = 0
    for i in range(n_tokens):
        if rng.random() < 0.1:                       # exploration
            t = int(rng.integers(0, vocab))
        else:
            t = int(nxt[s, rng.integers(0, 8)])
        out[i] = t
        s = t % order_state
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Infinite iterator of (tokens, targets) windows."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        idx = rng.integers(0, n, size=batch)
        x = np.stack([tokens[i:i + seq] for i in idx])
        y = np.stack([tokens[i + 1:i + seq + 1] for i in idx])
        yield x, y
