"""Traffic made from the seed: Markov token streams, training rows,
per-agent step times and the closed loop's request sizes.

``markov_tokens`` is a frozen copy of the port's
``data/synthetic.py:markov_tokens`` (a random sparse Markov chain over the
vocabulary, learnable LM data). ``TrainRows`` takes windows of that
stream as ``data/synthetic.py:lm_batches`` does, but at offsets drawn
without replacement, so no two rows of a run are the same.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
SILVER = math.sqrt(2.0) - 1.0


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for each ``stream`` of the seed."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


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


# a run's stream holds this many of its longest windows (a training row
# or the longest prompt): its rows or prompts start at any of ~64x that
# many offsets
STREAM_WINDOWS = 64


def stream(seed: int, window: int, vocab: int) -> np.ndarray:
    """The seed's token stream for windows of at most ``window`` tokens."""
    return markov_tokens(STREAM_WINDOWS * window, vocab=vocab,
                         seed=int(rng(seed, 1).integers(1 << 62)))


class TrainRows:
    """Step t's ``(tokens, targets)``: ``agents`` rows of ``seq`` tokens,
    each a window of the stream at an offset no other row of the run has
    (one permutation of the offsets, from the seed)."""

    def __init__(self, seed: int, tokens: np.ndarray, agents: int, seq: int):
        self.tokens, self.agents, self.seq = tokens, agents, seq
        self.offsets = rng(seed, 2).permutation(len(tokens) - seq - 1)

    def step(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """Rows of step ``t`` (1-based)."""
        idx = self.offsets[(t - 1) * self.agents:t * self.agents]
        if len(idx) < self.agents:
            raise RuntimeError("the token stream has no fresh rows left")
        x = np.stack([self.tokens[i:i + self.seq] for i in idx])
        y = np.stack([self.tokens[i + 1:i + self.seq + 1] for i in idx])
        return x, y

    def iterate(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        t = 1
        while True:
            yield self.step(t)
            t += 1


class AgentTimes:
    """Per-agent step times of step t: ``lognormal(0, sigma) * factor``
    for the stragglers (fixed from the seed), plus the 0.1 s round trip,
    as the port's ``core.async_engine.LatencyModel`` draws them."""

    def __init__(self, seed: int, agents: int, stragglers: int,
                 factor: float, sigma: float):
        self.seed, self.agents, self.sigma = seed, agents, sigma
        ids = rng(seed, 3).choice(agents, size=stragglers, replace=False)
        self.slow = np.where(np.isin(np.arange(agents), ids), factor, 1.0)

    def step(self, t: int) -> np.ndarray:
        raw = rng(self.seed, 4, t).lognormal(0.0, self.sigma, self.agents)
        return raw * self.slow + 0.1

    def kept(self, t: int, r: int) -> np.ndarray:
        """The agents of S^t: all but the r slowest, in index order."""
        return np.sort(np.argsort(self.step(t), kind="stable")[:self.agents - r])


def _uniform(u: float, lo: int, hi: int) -> int:
    """``u`` in [0, 1) to a whole number in [lo, hi], uniform."""
    n = hi - lo + 1
    return lo + min(int(u * n), n - 1)


class Requests:
    """Request j of the seed: its prompt (a window of the seed's stream)
    and its output budget. Lengths follow golden- and silver-ratio
    sequences, so any run of consecutive requests covers the ranges
    evenly. The sizes are the same for every seed, in the same order:
    which requests meet in a step sets the tail of the time to first
    token, and a seed that reordered them would change the work."""

    def __init__(self, seed: int, traffic: Dict, tokens: np.ndarray):
        self.tokens, self.seed = tokens, seed
        self.p, self.o = traffic["prompt_len"], traffic["output_len"]
        self.u0, self.v0 = rng(0, 5).random(2)

    def size(self, j: int) -> Tuple[int, int]:
        u = (self.u0 + j * GOLDEN) % 1.0
        v = (self.v0 + j * SILVER) % 1.0
        return (_uniform(u, self.p["min"], self.p["max"]),
                _uniform(v, self.o["min"], self.o["max"]))

    def get(self, j: int) -> Tuple[np.ndarray, int]:
        s0, out = self.size(j)
        off = int(rng(self.seed, 6, j).integers(len(self.tokens) - s0))
        return self.tokens[off:off + s0].copy(), out
