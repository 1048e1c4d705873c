"""Redundancy-aware request dispatch (DESIGN.md §9).

The paper's Algorithm 1 waits for the first n-r gradient arrivals and
drops the stragglers; the identical rule applies to replicated inference
(Wu et al., arXiv:2303.18034; Liu/Gupta/Vaidya, arXiv:2211.08622): fan a
request out to n model replicas, take the first n-r completions, answer
from those. Honest replicas run the same weights and greedy decoding, so
*any* non-empty honest subset returns the identical token stream — the
redundancy r buys tail latency, not approximation (contrast training,
where dropping gradients costs (r, eps)-bounded error).

Byzantine replicas are the serving twin of §4's eq. (17): a faulty
replica returns an arbitrary token stream (modeled by corrupting the
honest one through ``core.byzantine.ATTACKS``) and, worst case, arrives
first — the same adversarial ordering the training engine uses. The
server recovers by per-position majority vote over the n-r received
streams, sound while the received set keeps an honest majority:
n - r - f > (n - r) / 2.

Latency is simulated with the training engine's heavy-tail
``LatencyModel`` — the point of the benchmark/tests is the *shape* of the
p99-vs-r curve, which only needs the paper's §5 straggler statistics.

Torch port of ``repro.serve.dispatch``: numpy over the port's
``core.async_engine`` and ``core.byzantine``, draw for draw the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.async_engine import (DefaultTransport, LatencyModel,
                                           Transport, default_latency)
from repro_torch.core.byzantine import ATTACKS


class NoQuorumError(RuntimeError):
    """Total outage: zero replicas could deliver this request right now.

    Typed so callers (``sim.scenario.run_serve``, the fleet controller)
    can requeue programmatically instead of string-matching a bare
    RuntimeError. Subclasses RuntimeError so pre-existing ``except
    RuntimeError`` handlers keep working unchanged.

    Attributes: ``rid`` (the dispatcher's request counter at failure),
    ``deliverable`` (how many replicas could have answered — 0 for the
    classic outage, >0 when a fleet controller gave up below its vote
    floor), ``wait`` (the quorum the dispatch was trying to fill).
    """

    def __init__(self, rid: int, deliverable: int, wait: int,
                 msg: str = "no live replica reachable — request lost"):
        super().__init__(msg)
        self.rid = int(rid)
        self.deliverable = int(deliverable)
        self.wait = int(wait)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    n_replicas: int
    r: int = 0                          # proceed after n - r completions
    byz_ids: Tuple[int, ...] = ()
    attack: Optional[str] = None        # key into byzantine.ATTACKS
    seed: int = 0

    def __post_init__(self):
        if not 0 <= self.r < self.n_replicas:
            raise ValueError(f"need 0 <= r < n, got r={self.r}")
        wait = self.n_replicas - self.r
        if self.byz_ids and len(self.byz_ids) >= (wait + 1) // 2:
            raise ValueError(
                f"{len(self.byz_ids)} Byzantine replicas can outvote the "
                f"{wait}-reply quorum")


@dataclasses.dataclass
class DispatchResult:
    tokens: np.ndarray                  # (L,) int32, majority-voted
    round_latency: float                # arrival time of the last used reply
    used: Tuple[int, ...]               # replica ids that made S
    n_received: int
    # DispatchConfig validates the honest-majority bound for the FULL
    # n-r quorum, but crashes can degrade the used set below it at run
    # time — when False, the voted tokens are NOT trustworthy
    quorum_honest: bool = True


def honest_majority(n_used: int, n_byz: int) -> bool:
    """Vote soundness predicate (eq. (18) at the serving layer): the used
    reply set keeps a STRICT honest majority — a tie is not sound because
    ``majority_vote`` breaks ties toward the smallest token, which an
    adversary can craft. The single source of truth for dispatch's
    ``quorum_honest`` and the sim harness's vote check."""
    return (n_used - n_byz) > n_used / 2


def majority_vote(streams: np.ndarray) -> np.ndarray:
    """(m, L) int -> (L,) per-position mode (ties -> smallest id, which is
    deterministic and irrelevant under an honest majority). Shared by the
    dispatcher and the e2e harness (repro_torch.sim.e2e), so 'the vote' means
    one thing at every layer.

    Batched: one (m, m, L) equality reduction instead of L interpreter
    round-trips through ``np.unique`` — m is the reply quorum (<= n, a
    handful), so the m^2 factor is noise next to the per-position Python
    loop it replaces. Tie-break preserved exactly: among the values of
    maximal multiplicity in a column, the smallest wins (``np.unique``
    returns sorted values, so ``argmax`` picked the first == smallest).
    """
    s = np.asarray(streams)
    if s.shape[1] == 0:
        return np.empty(0, s.dtype)
    s64 = s.astype(np.int64, copy=False)
    counts = (s64[None, :, :] == s64[:, None, :]).sum(axis=1)   # (m, L)
    maxc = counts.max(axis=0)
    # among max-count rows take the smallest value; non-candidates are
    # masked to +inf-equivalent (int64 max, unreachable for token ids)
    cand = np.where(counts == maxc[None, :], s64, np.iinfo(np.int64).max)
    return cand.min(axis=0).astype(s.dtype)


def corrupt_stream(tokens: np.ndarray, attack: Optional[str],
                   rng: np.random.Generator) -> np.ndarray:
    """What a Byzantine replica answers: the honest stream pushed through
    ``core.byzantine.ATTACKS`` (eq. (17) at the serving layer) and
    re-quantized to token ids. One helper so the dispatcher and the e2e
    harness corrupt identically."""
    if not attack:
        return np.asarray(tokens, np.int64)
    g = ATTACKS[attack](np.asarray(tokens, np.float64), rng)
    return np.abs(np.rint(g)).astype(np.int64)


class RedundantDispatcher:
    """``replica_fn(replica_id, request) -> (L,) int32 tokens`` is the
    deployment: honest replicas must be deterministic replicas of the same
    model (greedy decode). The dispatcher adds the waiting rule, the
    adversarial replicas, and the vote."""

    def __init__(self, replica_fn: Callable[[int, np.ndarray], np.ndarray],
                 cfg: DispatchConfig,
                 latency: Optional[LatencyModel] = None,
                 transport: Optional[Transport] = None):
        self.replica_fn = replica_fn
        self.cfg = cfg
        # same event-ordering seam as the training engine: latency draws,
        # liveness and drops all come from the (injectable) transport, so
        # one repro_torch.sim Scenario drives both stacks through one
        # fault model
        self.transport = transport or DefaultTransport(
            latency or default_latency(cfg.n_replicas))
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0.0                      # virtual wall clock of the fleet
        self._rid = 0                       # dispatch counter (NoQuorumError)

    def dispatch(self, request: np.ndarray,
                 wait_for_all: bool = False) -> DispatchResult:
        c = self.cfg
        lat = np.asarray(self.transport.round_latencies(self.now, self.rng),
                         float)
        alive = np.array([self.transport.alive(j, self.now)
                          for j in range(c.n_replicas)])
        order_key = lat.copy()
        for j in c.byz_ids:                 # adversarial worst case: first
            order_key[j] = 0.0
        order_key[~alive] = np.inf
        # inf = unreachable this round (crashed replica / dropped reply);
        # degrade elastically like the training engine's S^t
        deliverable = int(np.isfinite(order_key).sum())
        want = c.n_replicas if wait_for_all else c.n_replicas - c.r
        wait = min(want, deliverable)
        rid = self._rid
        self._rid += 1
        if wait == 0:
            raise NoQuorumError(rid, deliverable, want)
        chosen = np.argsort(order_key)[:wait]

        streams = []
        for j in chosen:
            toks = np.asarray(self.replica_fn(int(j), request), np.int64)
            if j in c.byz_ids and c.attack:
                toks = corrupt_stream(toks, c.attack, self.rng)
            streams.append(toks)
        tokens = majority_vote(np.stack(streams)).astype(np.int32)
        round_latency = float(np.max(order_key[chosen]))
        self.now += round_latency
        n_byz_used = len({int(j) for j in chosen} & set(c.byz_ids))
        return DispatchResult(tokens=tokens,
                              round_latency=round_latency,
                              used=tuple(int(j) for j in np.sort(chosen)),
                              n_received=wait,
                              quorum_honest=honest_majority(wait,
                                                            n_byz_used))

    def serve(self, requests: Sequence[np.ndarray],
              wait_for_all: bool = False):
        """Dispatch a workload; returns (list of token arrays, latencies).
        Reseed (same cfg.seed) before calling to compare waiting rules on
        identical latency draws."""
        results = [self.dispatch(r, wait_for_all=wait_for_all)
                   for r in requests]
        return ([r.tokens for r in results],
                np.array([r.round_latency for r in results]))

    def reseed(self) -> None:
        self.rng = np.random.default_rng(self.cfg.seed)
        self.now = 0.0
        self._rid = 0
        self.transport.reset()


def tail_latency(lats: np.ndarray, q: float = 99.0) -> float:
    return float(np.percentile(lats, q))


def honest_tokens(request: np.ndarray, length: int = 12) -> np.ndarray:
    """The canonical deterministic 'greedy model' stand-in every honest
    replica runs in tests, benchmarks and the sim conformance harness:
    the response depends only on the request, never on the replica id,
    so token parity means the same thing at every layer."""
    rng = np.random.default_rng(int(np.sum(request)) % (2 ** 31))
    return rng.integers(0, 256, length).astype(np.int32)


def prefix_mix_requests(n: int, share: float, prefix_len: int = 24,
                        suffix_len: int = 8, vocab: int = 256,
                        seed: int = 0, rng=None):
    """Shared-prefix request mix (DESIGN.md §13): with probability
    ``share`` a request is the workload's common prefix plus a fresh
    suffix — a flash crowd hitting the same system prompt / few-shot
    preamble — otherwise it is fully unique. The canonical workload for
    the prefix-cache benchmark and the ``flash_crowd_prefix`` scenario:
    at ``share=0`` every prompt is cold, at ``share=0.9`` the request
    stream itself carries the redundancy the cache exploits."""
    rng = np.random.default_rng(seed) if rng is None else rng
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for _ in range(n):
        if rng.random() < share:
            out.append(np.concatenate(
                [prefix, rng.integers(0, vocab, suffix_len).astype(np.int32)]))
        else:
            out.append(rng.integers(0, vocab,
                                    prefix_len + suffix_len).astype(np.int32))
    return out
