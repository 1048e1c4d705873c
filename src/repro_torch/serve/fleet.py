"""Fleet health & recovery: failure detection, hedged dispatch, rejoin
(DESIGN.md §16; counterpart of ``repro.serve.fleet``, numpy, copied so
jitter streams, transitions and dispatch results are the reference's).

``RedundantDispatcher`` implements the paper's first-(n−r) rule by
argsorting an oracle latency vector — fine for studying the *selection*,
but a real server never sees that vector: it sees replies arrive (or
not) and must infer liveness from silence. This module is the adaptive
layer on top of the same ``Transport`` seam:

- :class:`PhiAccrualDetector` — Hayashibara-style accrual failure
  detection. Each replica's observed message inter-arrival gaps feed a
  sliding window; suspicion is ``phi(t) = -log10 P(gap > t - last)``
  under a normal fit of the window. ``phi`` crossing soft/hard
  thresholds drives the per-replica health state machine
  ``healthy → suspect → dead → recovering → healthy`` (rejoined).
  Suspicion accrues **only while a request/heartbeat is outstanding**
  (``last_sent > last_seen``): silence you didn't probe is not evidence.
- :class:`FleetController` — the control plane: per-replica detector +
  state, probation credit for recovering replicas (their replies prove
  catch-up but are excluded from quorum and vote until
  ``probation_replies`` arrive), transition log, and ``agent_*``-keyed
  ``state_dict`` so :func:`repro_torch.checkpoint.elastic.reshard_agent_state`
  resizes controller state with the fleet.
- :class:`HedgedDispatcher` — deadline-hedged dispatch replacing the
  oracle argsort: fan a request out to the ``n-r`` healthiest countable
  replicas, collect replies against a deadline derived from the EWMA
  reply latency, fire hedged backups to untried non-suspect replicas
  when the quorum stalls, retry with exponential backoff + jitter, and
  degrade the quorum elastically — shrink toward the vote-soundness
  floor :func:`vote_floor` (never below: a vote consumed under the
  floor could be outvoted by the ``f`` Byzantine replicas), then shed
  low-priority traffic — instead of raising on outage.  Only after
  ``max_retries`` total-outage rounds does it raise the typed
  :class:`~repro_torch.serve.dispatch.NoQuorumError`.

The detector-off path is ``RedundantDispatcher`` itself: nothing here is
imported by the oracle dispatcher, so with the fleet controller disabled
every golden trace replays byte-identically (same contract as
``agg_backend="host"`` / ``superstep_k=1``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.async_engine import (DefaultTransport, Transport,
                                           default_latency)
from repro_torch.serve.dispatch import (DispatchResult, NoQuorumError,
                                        corrupt_stream, honest_majority,
                                        majority_vote)

# health states (order = dispatch preference; codes = state_dict encoding)
HEALTHY, SUSPECT, RECOVERING, DEAD = "healthy", "suspect", "recovering", \
    "dead"
STATE_CODES = {HEALTHY: 0, SUSPECT: 1, RECOVERING: 2, DEAD: 3}
CODE_STATES = {v: k for k, v in STATE_CODES.items()}


_JITTER_SALT = 0x6a17             # rng key lane: backoff jitter, nothing else
_FRONTEND_COUNTER = itertools.count()


def next_frontend_instance() -> int:
    """Process-unique frontend index. Two dispatchers/fleets built from
    the same :class:`FleetConfig` get distinct instance keys and hence
    **independent** backoff-jitter streams (two frontends sharing a seed
    must not hedge in lockstep), while each instance's stream is still a
    pure function of ``(seed, instance)`` — ``reseed()`` replays it."""
    return next(_FRONTEND_COUNTER)


def jitter_stream(seed: int, instance: int,
                  rid: Optional[int] = None) -> np.random.Generator:
    """The backoff-jitter generator for one frontend (optionally one
    request). Keyed off the *seed sequence* ``[seed, salt, instance(,
    rid)]`` so it is independent of the transport/latency stream
    ``default_rng(seed)`` — drawing jitter can never perturb the
    simulated arrival process, which is what keeps the no-fault golden
    paths bit-identical across frontends."""
    key = [int(seed), _JITTER_SALT, int(instance)]
    if rid is not None:
        key.append(int(rid))
    return np.random.default_rng(key)


def vote_floor(n_byz: int) -> int:
    """Minimum reply count at which the majority vote is sound no matter
    which replicas made the quorum: with ``f`` Byzantine replicas the
    used set must satisfy ``honest_majority`` even if all ``f`` are in
    it, i.e. ``m - f > m/2`` — the smallest such ``m`` is ``2f + 1``.
    The elastic quorum may shrink to this floor, never below it."""
    return 2 * int(n_byz) + 1


class PhiAccrualDetector:
    """Accrual failure detector over one replica's message arrivals.

    ``observe(t)`` records an arrival; ``phi(t)`` is the suspicion level
    ``-log10 P(gap > t - last)`` with the gap distribution fit as a
    normal over the last ``window`` observed inter-arrival gaps (std
    floored at ``std_floor_frac`` of the mean so a metronomic sender
    doesn't make the detector hair-triggered). Before ``min_samples``
    gaps the prior ``init_interval`` is used for both moments — a cold
    detector is deliberately slow to accuse.
    """

    def __init__(self, window: int = 16, min_samples: int = 3,
                 init_interval: float = 2.0, std_floor_frac: float = 0.2):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.init_interval = float(init_interval)
        self.std_floor_frac = float(std_floor_frac)
        self.gaps: List[float] = []
        self.last: Optional[float] = None

    def observe(self, t: float) -> None:
        if self.last is not None:
            self.gaps.append(max(float(t) - self.last, 0.0))
            if len(self.gaps) > self.window:
                del self.gaps[: len(self.gaps) - self.window]
        self.last = float(t) if self.last is None else max(self.last,
                                                           float(t))

    def phi(self, t: float) -> float:
        if self.last is None:
            return 0.0
        dt = float(t) - self.last
        if dt <= 0.0:
            return 0.0
        if len(self.gaps) >= self.min_samples:
            mean = float(np.mean(self.gaps))
            std = float(np.std(self.gaps))
        else:
            mean, std = self.init_interval, self.init_interval
        std = max(std, self.std_floor_frac * mean, 1e-6)
        # P(gap > dt) under N(mean, std): survival via erfc
        p_later = 0.5 * math.erfc((dt - mean) / (std * math.sqrt(2.0)))
        return -math.log10(max(p_later, 1e-15))


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of the fleet controller + hedged dispatcher. Defaults are
    tuned to the sim scenarios' timescale (``mean_lat≈1`` virtual s,
    heartbeats every couple of seconds)."""
    n_replicas: int
    r: int = 0
    byz_ids: Tuple[int, ...] = ()
    attack: Optional[str] = None
    seed: int = 0
    # detector / state machine
    phi_suspect: float = 1.0      # P(still alive) < 10%
    phi_dead: float = 3.0         # P(still alive) < 0.1%
    window: int = 16
    min_samples: int = 3
    init_interval: float = 2.0
    std_floor_frac: float = 0.2
    heartbeat_period: float = 2.0
    # hedging / backoff
    hedge_factor: float = 3.0     # deadline = factor x EWMA reply latency
    ewma_beta: float = 0.2
    backoff_base: float = 1.0
    backoff_cap: float = 8.0
    backoff_jitter: float = 0.25
    max_retries: int = 4
    # rejoin probation
    probation_replies: int = 2
    # SLA shedding: while the countable fleet is below the full n-r
    # quorum, requests with priority < shed_below are parked and retried
    # after the pass (scheduler priorities: higher = more important)
    shed_below: int = 0

    def __post_init__(self):
        if not 0 <= self.r < self.n_replicas:
            raise ValueError(f"need 0 <= r < n, got r={self.r}")
        wait = self.n_replicas - self.r
        if vote_floor(len(self.byz_ids)) > wait:
            raise ValueError(
                f"{len(self.byz_ids)} Byzantine replicas put the vote "
                f"floor {vote_floor(len(self.byz_ids))} above the "
                f"{wait}-reply quorum")

    @property
    def floor(self) -> int:
        return vote_floor(len(self.byz_ids))


@dataclasses.dataclass
class Transition:
    t: float
    replica: int
    old: str
    new: str


class FleetController:
    """Per-replica health state machine over accrual failure detection.

    Pure control plane: time is fed in by the caller (virtual or wall),
    evidence arrives through :meth:`observe` (any message from the
    replica — reply, heartbeat, probe ack) and :meth:`note_sent` (an
    expectation was created); :meth:`poll` applies the phi thresholds.
    No transport oracle is consulted — a replica is ``dead`` exactly
    when it went silent under an outstanding expectation.
    """

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        c = self.cfg
        n = c.n_replicas
        self.state: List[str] = [HEALTHY] * n
        self.det = [PhiAccrualDetector(c.window, c.min_samples,
                                       c.init_interval, c.std_floor_frac)
                    for _ in range(n)]
        self.last_sent = [-np.inf] * n
        self.ewma = [c.init_interval] * n
        self.probation = [0] * n
        self.transitions: List[Transition] = []
        self.deaths = 0               # healthy/suspect -> dead
        self.rejoins = 0              # recovering -> healthy

    # -- evidence --------------------------------------------------------
    def note_sent(self, j: int, t: float) -> None:
        self.last_sent[j] = max(self.last_sent[j], float(t))

    def note_latency(self, j: int, lat: float) -> None:
        b = self.cfg.ewma_beta
        self.ewma[j] = (1.0 - b) * self.ewma[j] + b * float(lat)

    def observe(self, j: int, t: float) -> str:
        """A message from replica j arrived at time t."""
        self.det[j].observe(t)
        old = self.state[j]
        if old == DEAD:
            self.probation[j] = self.cfg.probation_replies
            self._move(j, t, RECOVERING)
        elif old == SUSPECT:
            self._move(j, t, HEALTHY)
        elif old == RECOVERING:
            self.probation[j] -= 1
            if self.probation[j] <= 0:
                self._move(j, t, HEALTHY)
                self.rejoins += 1
        return self.state[j]

    # -- suspicion -------------------------------------------------------
    def phi(self, j: int, t: float) -> float:
        last = self.det[j].last
        if last is None or self.last_sent[j] <= last:
            return 0.0            # no outstanding expectation: no evidence
        return self.det[j].phi(t)

    def poll(self, t: float) -> List[Transition]:
        """Apply the phi thresholds; returns the transitions fired."""
        c = self.cfg
        fired: List[Transition] = []
        for j in range(c.n_replicas):
            if self.state[j] == DEAD:
                continue
            p = self.phi(j, t)
            if p >= c.phi_dead:
                if self.state[j] in (HEALTHY, SUSPECT):
                    self.deaths += 1
                fired.append(self._move(j, t, DEAD))
            elif p >= c.phi_suspect and self.state[j] == HEALTHY:
                fired.append(self._move(j, t, SUSPECT))
        return fired

    def _move(self, j: int, t: float, new: str) -> Transition:
        tr = Transition(t=float(t), replica=j, old=self.state[j], new=new)
        self.state[j] = new
        self.transitions.append(tr)
        return tr

    # -- dispatch queries ------------------------------------------------
    def countable(self, j: int) -> bool:
        """May replica j's replies enter quorum and vote? Recovering
        replicas are on probation (their replies only prove catch-up);
        dead ones cannot answer anyway."""
        return self.state[j] in (HEALTHY, SUSPECT)

    def n_countable(self) -> int:
        return sum(self.countable(j) for j in range(self.cfg.n_replicas))

    def ranked(self) -> List[int]:
        """All replicas, best dispatch target first: healthy before
        suspect before recovering before dead, faster EWMA first."""
        return sorted(range(self.cfg.n_replicas),
                      key=lambda j: (STATE_CODES[self.state[j]],
                                     self.ewma[j], j))

    def expected_latency(self) -> float:
        lats = [self.ewma[j] for j in range(self.cfg.n_replicas)
                if self.countable(j)]
        if not lats:
            lats = list(self.ewma)
        return float(np.mean(lats)) if lats else self.cfg.init_interval

    def degraded(self) -> bool:
        """Below the full first-(n-r) quorum: elastic shrink / shedding
        territory."""
        return self.n_countable() < self.cfg.n_replicas - self.cfg.r

    # -- checkpoint / elastic --------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Flat, ``agent_*``-keyed image: every per-replica leaf carries
        the leading n axis, so ``checkpoint.elastic.reshard_agent_state``
        resizes controller state with the fleet (joiners come back as
        zero rows = healthy cold detectors)."""
        n, w = self.cfg.n_replicas, self.cfg.window
        win = np.full((n, w), np.nan)
        wlen = np.zeros((n,), np.int32)
        seen = np.full((n,), np.nan)
        for j, d in enumerate(self.det):
            wlen[j] = len(d.gaps)
            win[j, : len(d.gaps)] = d.gaps
            if d.last is not None:
                seen[j] = d.last
        return {
            "agent_state": np.array([STATE_CODES[s] for s in self.state],
                                    np.int8),
            "agent_probation": np.asarray(self.probation, np.int32),
            "agent_ewma": np.asarray(self.ewma, np.float64),
            "agent_last_sent": np.asarray(self.last_sent, np.float64),
            "agent_last_seen": seen,
            "agent_gap_window": win,
            "agent_gap_len": wlen,
        }

    def load_state(self, flat: Dict[str, np.ndarray]) -> None:
        n = self.cfg.n_replicas
        st = np.asarray(flat["agent_state"])
        if st.shape[0] != n:
            raise ValueError(f"state for {st.shape[0]} replicas, "
                             f"controller has {n}")
        self.state = [CODE_STATES[int(c)] for c in st]
        self.probation = [int(x) for x in flat["agent_probation"]]
        # zero-filled joiners sanitize to the cold-start prior
        self.ewma = [float(x) if x > 0 else self.cfg.init_interval
                     for x in flat["agent_ewma"]]
        self.last_sent = [float(x) for x in flat["agent_last_sent"]]
        seen = np.asarray(flat["agent_last_seen"], np.float64)
        win = np.asarray(flat["agent_gap_window"], np.float64)
        wlen = np.asarray(flat["agent_gap_len"], np.int32)
        for j, d in enumerate(self.det):
            d.gaps = [float(g) for g in win[j, : int(wlen[j])]
                      if np.isfinite(g)]
            d.last = float(seen[j]) if np.isfinite(seen[j]) else None


class HedgedDispatcher:
    """Deadline-hedged first-(n−r) dispatch over observed liveness.

    The drop-in stand-in twin of ``RedundantDispatcher`` (same
    ``replica_fn`` contract, same ``DispatchResult``), but no oracle:
    per request it fans out to the ``n-r`` best countable replicas,
    replays the reply arrival process in virtual time through the
    ``Transport`` seam, hedges to untried replicas when the deadline
    passes, degrades to the vote floor, and retries total outages with
    exponential backoff + jitter before raising ``NoQuorumError``.
    """

    def __init__(self, replica_fn: Callable[[int, np.ndarray], np.ndarray],
                 cfg: FleetConfig,
                 transport: Optional[Transport] = None,
                 controller: Optional[FleetController] = None,
                 jitter_instance: Optional[int] = None):
        self.replica_fn = replica_fn
        self.cfg = cfg
        self.transport = transport or DefaultTransport(
            default_latency(cfg.n_replicas))
        self.ctrl = controller or FleetController(cfg)
        # two rng streams with distinct lifecycles: ``rng`` replays the
        # simulated world (transport latencies, delivery fates, Byzantine
        # corruption) and is a pure function of the seed so two
        # dispatchers replay the *same* world; ``_jrng`` draws backoff
        # jitter only and is additionally keyed by a per-instance index
        # so co-seeded frontends never back off in lockstep. reseed()
        # replays both (the instance key is part of this object).
        self.rng = np.random.default_rng(cfg.seed)
        self._jitter_instance = (next_frontend_instance()
                                 if jitter_instance is None
                                 else int(jitter_instance))
        self._jrng = jitter_stream(cfg.seed, self._jitter_instance)
        self.now = 0.0
        self._rid = 0
        # telemetry
        self.hedges = 0
        self.retries = 0
        self.outages = 0
        self.shed = 0

    # ------------------------------------------------------------------
    def _timeout(self) -> float:
        return self.cfg.hedge_factor * max(self.ctrl.expected_latency(),
                                           1e-3)

    def dispatch(self, request: np.ndarray,
                 wait_for_all: bool = False) -> DispatchResult:
        c = self.cfg
        want = c.n_replicas if wait_for_all else c.n_replicas - c.r
        rid = self._rid
        self._rid += 1
        self.ctrl.poll(self.now)    # suspicion accrued since the last call
        deliverable = 0
        for attempt in range(c.max_retries + 1):
            res, deliverable = self._attempt(request, want)
            if res is not None:
                return res
            if attempt < c.max_retries:
                self.retries += 1
                pause = min(c.backoff_base * (2.0 ** attempt),
                            c.backoff_cap)
                pause *= 1.0 + c.backoff_jitter * float(self._jrng.random())
                self.now += pause
                self.ctrl.poll(self.now)
        self.outages += 1
        raise NoQuorumError(rid, deliverable, want)

    def _attempt(self, request: np.ndarray, want: int):
        """One fan-out + hedge round; returns (result | None, countable
        reply count). None means the round ended below the vote floor —
        the caller backs off and retries."""
        c, ctrl, tp = self.cfg, self.ctrl, self.transport
        t0 = self.now
        seq = itertools.count()
        events: List[Tuple[float, int, int]] = []   # (t_arr, seq, replica)
        sent_at: Dict[int, float] = {}
        replies: Dict[int, np.ndarray] = {}
        done_t: Dict[int, float] = {}

        def send(j: int, t: float) -> None:
            sent_at[j] = t
            ctrl.note_sent(j, t)
            if not tp.alive(j, t):
                return                          # connection refused: silent
            lat = float(tp.task_latency(j, t, self.rng))
            t_arr = t + lat
            if not tp.alive(j, t_arr):
                return                          # died mid-request
            if tp.delivery_fate(j, t_arr, self.rng) == 0:
                return                          # reply eaten by the network
            heapq.heappush(events, (t_arr, next(seq), j))

        ranked = ctrl.ranked()
        for j in [j for j in ranked if ctrl.countable(j)][:want]:
            send(j, t0)
        # probe every non-countable replica: recovery discovery and
        # probation credit piggyback on the dispatch (a real server's
        # health checker; replies never enter quorum or vote)
        for j in ranked:
            if not ctrl.countable(j) and j not in sent_at:
                send(j, t0)

        deadline = t0 + self._timeout()
        while len(replies) < want:
            if events and events[0][0] <= deadline:
                t_arr, _, j = heapq.heappop(events)
                self.now = max(self.now, t_arr)
                pre_countable = ctrl.countable(j)
                ctrl.observe(j, t_arr)
                ctrl.note_latency(j, t_arr - sent_at[j])
                if pre_countable and j not in replies:
                    toks = np.asarray(self.replica_fn(int(j), request),
                                      np.int64)
                    if j in c.byz_ids and c.attack:
                        toks = corrupt_stream(toks, c.attack, self.rng)
                    replies[j] = toks
                    done_t[j] = t_arr
                continue
            # quorum stalled (or nothing in flight): suspicion + hedges
            if events:
                stall_t = deadline          # in flight but past deadline
            elif any(j not in sent_at and ctrl.countable(j)
                     for j in range(c.n_replicas)):
                stall_t = self.now          # hedge immediately
            else:
                break                       # nothing in flight, nobody left
            self.now = max(self.now, stall_t)
            ctrl.poll(self.now)
            untried = [j for j in ctrl.ranked()
                       if ctrl.countable(j) and j not in sent_at]
            if untried:
                need = max(want - len(replies), 1)
                for j in untried[:need]:
                    send(j, self.now)
                    self.hedges += 1
                deadline = self.now + self._timeout()
            elif events:
                deadline = events[0][0]     # wait out the stragglers
            else:
                break
        # late probe replies that already arrived grant probation credit
        while events and events[0][0] <= self.now:
            t_arr, _, j = heapq.heappop(events)
            if j not in replies:
                ctrl.observe(j, t_arr)
                ctrl.note_latency(j, t_arr - sent_at[j])

        got = len(replies)
        if got < self.cfg.floor:
            return None, got
        used = tuple(sorted(replies, key=lambda j: (done_t[j], j))[:want])
        streams = np.stack([replies[j] for j in used])
        tokens = majority_vote(streams).astype(np.int32)
        round_latency = max(done_t[j] for j in used) - t0
        n_byz_used = len(set(used) & set(c.byz_ids))
        return DispatchResult(
            tokens=tokens, round_latency=float(round_latency),
            used=tuple(sorted(used)), n_received=len(used),
            quorum_honest=honest_majority(len(used), n_byz_used)), got

    # ------------------------------------------------------------------
    def serve(self, requests: Sequence[np.ndarray],
              priorities: Optional[Sequence[int]] = None):
        """Dispatch a workload with elastic shedding: while the fleet is
        degraded below the full n−r quorum, requests with priority <
        ``shed_below`` are parked (SLA classes: higher = more
        important); parked requests retry after the pass, by which time
        the fleet may have recovered. Returns (results, latencies) with
        ``None`` / ``inf`` for requests lost to a total outage."""
        if priorities is None:
            priorities = [0] * len(requests)
        results: List[Optional[DispatchResult]] = [None] * len(requests)
        lats = np.full(len(requests), np.inf)
        parked: List[int] = []
        for i, req in enumerate(requests):
            if self.ctrl.degraded() and priorities[i] < self.cfg.shed_below:
                parked.append(i)
                self.shed += 1
                continue
            try:
                results[i] = self.dispatch(req)
                lats[i] = results[i].round_latency
            except NoQuorumError:
                pass
        for i in parked:
            try:
                results[i] = self.dispatch(requests[i])
                lats[i] = results[i].round_latency
            except NoQuorumError:
                pass
        return results, lats

    def reseed(self) -> None:
        self.rng = np.random.default_rng(self.cfg.seed)
        self._jrng = jitter_stream(self.cfg.seed, self._jitter_instance)
        self.now = 0.0
        self._rid = 0
        self.hedges = self.retries = self.outages = self.shed = 0
        self.ctrl.reset()
        self.transport.reset()
