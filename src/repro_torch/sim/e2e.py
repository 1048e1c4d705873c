"""Trace-driven end-to-end load harness: sim faults × real engines
(DESIGN.md §15).

``repro_torch.sim`` proves the fault semantics on a stand-in replica
(``honest_tokens``); ``benchmarks/serve_latency.py`` proves the real
engine fast but fault-free. This module closes the loop: an open-loop
Poisson request stream (the *same* ``request_loadgen`` byte stream the
stand-in replays) fans out to ``n`` **real replicated**
:class:`~repro_torch.serve.engine.ServeEngine` instances, and every
:class:`~repro_torch.sim.faults.FaultSchedule` primitive acts on real decode
supersteps through the existing ``Transport`` seam:

- **CrashWindow** — a window opening mid-superstep kills the step: the
  replica's in-flight requests are aborted (``ServeEngine.crash()``,
  tokens lost, queue dropped) and the replica rejoins empty at recovery.
- **StragglerRamp / LatencyModel stragglers** — every superstep is
  billed ``task_latency(j, t) × work/round`` virtual seconds through the
  transport, so a straggling replica's copies complete late and the
  first-(n−r) rule hides them.
- **MessageFaults** — a completed reply's ``delivery_fate`` can drop it
  (copy undeliverable → elastic quorum degrade); jitter reorders
  completion times inside ``task_latency``.
- **ByzantineSwitch** — a faulty replica's *real* token stream is pushed
  through ``core.byzantine.ATTACKS`` at vote time; the per-position
  majority vote must outvote it while the used set keeps an honest
  majority.

Replica timelines are simulated independently (virtual time; each
replica is one continuous-batching server draining its own queue), so
the first-(n−r) waiting rule is a *selection* over the measured
completion process — the harness runs each scenario once and derives the
whole goodput/p99-vs-r curve r ∈ {0..3} post hoc from the recorded
per-copy (t_first, t_done, tokens) outcomes. A request with zero
deliverable copies is a total outage: the dispatcher requeues it (full
re-fan-out) at the fleet's next recovery instant, bounded by
``max_retries``.

Per request the harness records TTFT (all used replicas produced their
first token), TPOT and latency, and runs the §10 conformance checks:
vote soundness against the honest engines' own stream, honest-replica
agreement (batch-composition invariance measured end to end),
request-level liveness, and ``quorum_honest``.

Torch port of ``repro.sim.e2e``: the same harness over the port's
``ServeEngine``, whose ``stats`` counters advance per ``step()`` as the
reference's do, so the virtual-time billing is the same. Every replica
decodes through the paged flash-decode kernel on a card (its plain form
on the CPU). Honest-replica agreement compares replicas that share that
kernel, so it cannot see a fault in it: hold the delivered streams
against the plain attention form separately.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.dispatch import (corrupt_stream, honest_majority,
                                        majority_vote)
from repro_torch.sim import conformance
from repro_torch.sim.clock import VirtualClock, poisson_arrivals
from repro_torch.sim.faults import FaultSchedule
from repro_torch.sim.scenario import (Scenario, arrival_rate,
                                      request_loadgen)

R_SWEEP = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class E2EConfig:
    """Real-engine knobs of the harness (scenario-independent)."""
    arch: str = "qwen2-0.5b"
    max_new_tokens: int = 8       # tokens per request (1 prefill + L-1 dec)
    num_slots: int = 2
    page_size: int = 8
    num_pages: int = 32
    max_pages_per_seq: int = 8
    superstep_k: int = 4
    # virtual-time billing: one transport latency sample covers
    # ``prefill_weight + (max_new_tokens - 1)`` token-equivalents of
    # work, so a full request costs ~one scenario round — fault windows
    # tuned for the stand-in keep their meaning on the real engines
    prefill_weight: float = 1.0
    max_retries: int = 4
    seed: int = 0

    @property
    def round_tokens(self) -> float:
        return self.prefill_weight + (self.max_new_tokens - 1)


class EngineFleet:
    """``n`` real replicated engines on one shared set of weights.

    Honest replicas must be deterministic copies of the same greedy
    model, so the fleet initializes params once and hands every engine
    the same tensors. The fleet is **reusable across runs** — every
    scenario replays on warm engines (engines drain fully or are
    ``crash()``-cleared, so no state leaks between scenarios; only
    monotone counters survive).

    ``cfg`` defaults to ``get_config(ecfg.arch).reduced()``, as in the
    reference; ``params`` (on ``device``) default to ``init_model`` with
    a generator on ``device`` seeded with ``ecfg.seed``.
    """

    def __init__(self, n: int, ecfg: Optional[E2EConfig] = None, *,
                 params=None, cfg=None, device="cuda"):
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.device import resolve
        from repro_torch.models.model import init_model
        from repro_torch.serve import PagedCacheConfig, ServeEngine

        self.ecfg = ecfg or E2EConfig()
        self.n = int(n)
        self.device = resolve(device)
        cfg = cfg or get_config(self.ecfg.arch).reduced()
        if params is None:
            max_pos = self.ecfg.page_size * self.ecfg.max_pages_per_seq
            gen = torch.Generator(device=self.device)
            params = init_model(gen.manual_seed(self.ecfg.seed), cfg,
                                device=self.device, max_pos=max_pos)
        ccfg = PagedCacheConfig(
            num_slots=self.ecfg.num_slots, page_size=self.ecfg.page_size,
            num_pages=self.ecfg.num_pages,
            max_pages_per_seq=self.ecfg.max_pages_per_seq)
        self.cfg = cfg
        self.engines = [ServeEngine(params, cfg, ccfg,
                                    superstep_k=self.ecfg.superstep_k,
                                    device=self.device)
                        for _ in range(self.n)]

    def drained(self) -> bool:
        return all(e.sched.idle for e in self.engines)


# ---------------------------------------------------------------------------
# per-copy / per-request records

PENDING, DELIVERED, LOST, DROPPED = "pending", "delivered", "lost", "dropped"


@dataclasses.dataclass
class CopyOutcome:
    """One replica's copy of one request."""
    replica: int
    status: str = PENDING
    t_first: float = np.inf       # replica produced its first token
    t_done: float = np.inf        # replica finished the stream
    t_lost: float = np.inf        # crash/drop instant (requeue anchor)
    tokens: Optional[np.ndarray] = None

    @property
    def deliverable(self) -> bool:
        return self.status == DELIVERED


@dataclasses.dataclass
class E2ERequest:
    idx: int
    prompt: np.ndarray
    arrival: float                # current attempt's fan-out time
    first_arrival: float          # original arrival (latency baseline)
    copies: Dict[int, CopyOutcome] = dataclasses.field(default_factory=dict)
    retries: int = 0
    max_new: int = 0              # tokens to generate (E2EConfig's L)

    def delivered(self) -> List[CopyOutcome]:
        return sorted((c for c in self.copies.values() if c.deliverable),
                      key=lambda c: (c.t_done, c.replica))


@dataclasses.dataclass
class QuorumRow:
    """One point of the goodput/p99-vs-r curve."""
    r: int
    n_requests: int
    n_ok: int                     # finite, vote==honest, quorum honest
    n_degraded: int               # answered from < n-r copies
    n_unanswered: int
    p50_ttft: float
    p99_ttft: float
    p50_tpot: float
    p99_tpot: float
    p50_latency: float
    p99_latency: float
    goodput: float                # ok requests per unit virtual time
    violations: List[str] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["violations"] = len(self.violations)
        return d


@dataclasses.dataclass
class E2EReport:
    scenario: Scenario
    n_replicas: int
    max_new_tokens: int
    requests: List[E2ERequest]
    native: QuorumRow             # scenario-native r (churn applied)
    sweep: Dict[int, QuorumRow]   # static r -> row
    violations: List[str]         # the native row's conformance gate


# ---------------------------------------------------------------------------
# control-plane timelines (post-hoc twins of run_serve's event loop)

def byz_at(sc: Scenario, t: float) -> Tuple[Tuple[int, ...], Optional[str]]:
    ids, attack = tuple(sc.byz_ids), sc.attack
    for sw in sorted(sc.faults.switches, key=lambda s: s.at):
        if sw.at <= t:
            ids, attack = tuple(sw.byz_ids), sw.attack
    return ids, attack


def r_at(sc: Scenario, t: float) -> int:
    r = sc.r
    for ev in sorted(sc.faults.churn, key=lambda e: e.at):
        if ev.at <= t and "r" in ev.as_dict():
            r = int(ev.as_dict()["r"])
    return r


# ---------------------------------------------------------------------------
# replica simulation

def _deliver_due(eng, arrivals, i, t, j, transport, rid2copy, rid2st):
    """Submit every arrival with time <= t to replica j's engine; a
    message to a dead replica is lost on arrival."""
    while i < len(arrivals) and arrivals[i][0] <= t:
        ta, req = arrivals[i]
        i += 1
        copy = CopyOutcome(replica=j)
        req.copies[j] = copy
        if not transport.alive(j, ta):
            copy.status, copy.t_lost = LOST, ta
            continue
        rid = eng.submit(req.prompt, req.max_new)
        if not (eng.sched.waiting and eng.sched.waiting[-1].req.rid == rid):
            # over-capacity reject (sched.rejected): undeliverable copy
            copy.status, copy.t_lost = LOST, ta
            continue
        rid2copy[rid] = copy
        rid2st[rid] = eng.sched.waiting[-1]
    return i


def _mark_crashed(eng, rid2copy, t: float) -> None:
    """Abort the replica's whole state; every still-pending copy loses
    its in-flight tokens (CrashWindow contract, engine-level)."""
    for rid in eng.crash():
        copy = rid2copy.get(rid)
        if copy is not None and copy.status == PENDING:
            copy.status, copy.t_lost = LOST, t


def step_and_bill(eng, j: int, t: float, transport,
                  ecfg: E2EConfig) -> float:
    """Run one superstep on replica j's engine and return its virtual-
    time cost: one ``task_latency`` sample scaled by the fraction of a
    round's token work the step actually did (DESIGN.md §15 billing).
    The reference shares it with its fleet-controlled harness
    (``repro.sim.fleet_e2e``), so 'a superstep's cost' means one thing
    in both."""
    pre_dec = eng.stats["decode_steps"]
    pre_pre = eng.stats["prefill_calls"]
    eng.step()
    work = (eng.stats["decode_steps"] - pre_dec
            + ecfg.prefill_weight
            * (eng.stats["prefill_calls"] - pre_pre))
    return transport.task_latency(j, t, None) * work / ecfg.round_tokens


def _run_replica(j: int, eng, arrivals, transport, faults: FaultSchedule,
                 ecfg: E2EConfig, t0: float = 0.0) -> float:
    """Drive replica j's engine through its arrival stream in virtual
    time; fills each request's ``copies[j]``. Returns the replica clock
    (monotone across retry rounds — the fleet is reused)."""
    rid2copy: Dict[int, CopyOutcome] = {}
    rid2st: Dict[int, object] = {}
    t = float(t0)
    i = 0
    while i < len(arrivals) or not eng.sched.idle:
        if eng.sched.idle:
            t = max(t, arrivals[i][0])
        i = _deliver_due(eng, arrivals, i, t, j, transport, rid2copy,
                         rid2st)
        if eng.sched.idle:
            continue
        if not transport.alive(j, t):          # dead at the step boundary
            _mark_crashed(eng, rid2copy, t)
            t = faults.next_recovery(j, t)
            continue
        dt = step_and_bill(eng, j, t, transport, ecfg)
        t_end = t + dt
        crash = faults.first_crash_start(j, t, t_end)
        if crash is not None:
            # the superstep never completed: tokens produced inside it —
            # including any retirement — are lost at the crash instant
            _mark_crashed(eng, rid2copy, crash)
            for rid, copy in rid2copy.items():
                if copy.status == PENDING and rid in eng.sched.finished:
                    copy.status, copy.t_lost = LOST, crash
            t = crash              # next turn jumps to recovery
            continue
        for rid, copy in rid2copy.items():
            if copy.status != PENDING:
                continue
            st = rid2st[rid]
            if np.isinf(copy.t_first) and st.generated:
                copy.t_first = t_end
            if rid in eng.sched.finished:
                fate = transport.delivery_fate(j, t_end, None)
                if fate == 0:      # reply eaten by the network
                    copy.status, copy.t_lost = DROPPED, t_end
                else:
                    copy.status, copy.t_done = DELIVERED, t_end
                    copy.tokens = np.asarray(st.generated, np.int32)
        t = t_end
    return t


# ---------------------------------------------------------------------------
# post-hoc quorum analysis (the first-(n-r) rule as a selection)

def _percentiles(xs: List[float]) -> Tuple[float, float]:
    finite = [x for x in xs if np.isfinite(x)]
    if not finite:
        return float("inf"), float("inf")
    return (float(np.percentile(finite, 50)),
            float(np.percentile(finite, 99)))


def analyze_quorum(sc: Scenario, requests: List[E2ERequest],
                   max_new_tokens: int, r: Optional[int] = None,
                   check: bool = True) -> QuorumRow:
    """Apply the first-(n-r) waiting rule + majority vote to the recorded
    per-copy outcomes. ``r=None`` follows the scenario's churn timeline
    (the native row); an int pins r for the sweep."""
    n = sc.n_agents
    ttfts: List[float] = []
    tpots: List[float] = []
    lats: List[float] = []
    violations: List[str] = []
    n_ok = n_degraded = n_unanswered = 0
    t_last = 0.0
    for req in requests:
        rr = r_at(sc, req.arrival) if r is None else int(r)
        byz_ids, attack = byz_at(sc, req.arrival)
        delivered = req.delivered()
        wait_full = n - rr
        wait = min(wait_full, len(delivered))
        if wait == 0:
            n_unanswered += 1
            ttfts.append(float("inf"))
            tpots.append(float("inf"))
            lats.append(float("inf"))
            violations.append(
                f"request {req.idx}: lost after {req.retries} retries "
                f"(total outage)")
            continue
        used = delivered[:wait]
        used_ids = tuple(sorted(c.replica for c in used))
        t_done = max(c.t_done for c in used)
        t_first = max(c.t_first for c in used)
        ttft = t_first - req.first_arrival
        lat = t_done - req.first_arrival
        tpot = ((t_done - t_first) / max(max_new_tokens - 1, 1))
        ttfts.append(ttft)
        tpots.append(tpot)
        lats.append(lat)
        t_last = max(t_last, t_done)
        if wait < wait_full:
            n_degraded += 1
        # the vote, over real engine streams (byz copies corrupted the
        # same way the dispatcher corrupts the stand-in)
        streams = []
        for c in used:
            toks = np.asarray(c.tokens, np.int64)
            if c.replica in byz_ids:
                toks = corrupt_stream(
                    toks, attack,
                    np.random.default_rng([sc.seed, req.idx, c.replica]))
            streams.append(toks)
        voted = majority_vote(np.stack(streams)).astype(np.int32)
        n_byz_used = len(set(used_ids) & set(byz_ids))
        quorum_ok = honest_majority(wait, n_byz_used)
        honest_streams = {c.replica: c.tokens for c in delivered
                          if c.replica not in byz_ids}
        ok = quorum_ok
        if check and honest_streams:
            v = conformance.check_replica_agreement(
                honest_streams, sorted(honest_streams), req.idx)
            if v:
                violations.append(v)
            honest_ref = honest_streams[min(honest_streams)]
            v = conformance.check_vote(voted, honest_ref, used_ids,
                                       byz_ids, req.idx)
            if v:
                violations.append(v)
                ok = False
        if check:
            v = conformance.check_request_liveness(
                req.idx, n, rr, len(delivered), wait, lat)
            if v:
                violations.append(v)
            if not quorum_ok:
                violations.append(
                    f"request {req.idx}: quorum lost its honest majority "
                    f"(used={used_ids}, byz={byz_ids}) — tokens "
                    f"untrustworthy")
        n_ok += int(ok)
    p50_t, p99_t = _percentiles(ttfts)
    p50_p, p99_p = _percentiles(tpots)
    p50_l, p99_l = _percentiles(lats)
    t0 = min((q.first_arrival for q in requests), default=0.0)
    span = max(t_last - t0, 1e-9)
    return QuorumRow(
        r=(-1 if r is None else int(r)), n_requests=len(requests),
        n_ok=n_ok, n_degraded=n_degraded, n_unanswered=n_unanswered,
        p50_ttft=p50_t, p99_ttft=p99_t, p50_tpot=p50_p, p99_tpot=p99_p,
        p50_latency=p50_l, p99_latency=p99_l,
        goodput=n_ok / span, violations=violations)


# ---------------------------------------------------------------------------
# the harness

def make_arrivals(sc: Scenario,
                  max_new_tokens: int) -> List[E2ERequest]:
    """The scenario's open-loop request stream — same clock, same seed,
    same payload bytes as ``run_serve``'s stand-in replay (the loadgen
    seam)."""
    clock = VirtualClock()
    evs = poisson_arrivals(clock, arrival_rate(sc), sc.n_requests,
                           seed=sc.seed + 1, tag="request",
                           make_payload=request_loadgen(sc))
    out = []
    for idx, ev in enumerate(evs):
        out.append(E2ERequest(idx=idx,
                              prompt=np.asarray(ev.payload, np.int32),
                              arrival=ev.time, first_arrival=ev.time,
                              max_new=max_new_tokens))
    return out


def run_e2e(sc: Scenario, fleet: Optional[EngineFleet] = None,
            ecfg: Optional[E2EConfig] = None, check: bool = True,
            r_values: Tuple[int, ...] = R_SWEEP,
            n_requests: Optional[int] = None) -> E2EReport:
    """Replay one scenario against real replicated engines and return
    per-request outcomes + the whole r-curve.

    Pass a shared :class:`EngineFleet` to reuse warm engines across
    scenarios; ``n_requests`` truncates the stream for smoke runs
    without changing its byte prefix. Without a fleet, one is built on
    the default device (a CUDA card).
    """
    if fleet is None:
        fleet = EngineFleet(sc.n_agents, ecfg)
    ecfg = fleet.ecfg
    if fleet.n != sc.n_agents:
        raise ValueError(f"fleet of {fleet.n} replicas cannot replay a "
                         f"{sc.n_agents}-agent scenario")
    if not fleet.drained():
        raise RuntimeError("fleet has in-flight requests from a previous "
                           "run — engines must be drained between replays")
    transport = sc.make_transport()
    L = ecfg.max_new_tokens
    requests = make_arrivals(sc, L)
    if n_requests is not None:
        requests = requests[:n_requests]
    clocks = [0.0] * fleet.n

    pending = list(requests)
    for attempt in range(ecfg.max_retries + 1):
        arrivals = sorted(((req.arrival, req) for req in pending),
                          key=lambda a: (a[0], a[1].idx))
        for j, eng in enumerate(fleet.engines):
            clocks[j] = _run_replica(j, eng, arrivals, transport,
                                     sc.faults, ecfg, t0=clocks[j])
        # total outage -> requeue: full re-fan-out at the instant the
        # dispatcher knows the last copy died AND some replica is back
        retry = []
        for _, req in arrivals:
            if req.delivered():
                continue
            t_lost = max(c.t_lost for c in req.copies.values())
            t_retry = min(sc.faults.next_recovery(j, t_lost)
                          for j in range(fleet.n))
            if attempt < ecfg.max_retries:
                req.copies.clear()
                req.arrival = max(t_retry, t_lost)
                req.retries += 1
                retry.append(req)
        pending = retry
        if not pending:
            break

    native = analyze_quorum(sc, requests, L, r=None, check=check)
    sweep = {rr: analyze_quorum(sc, requests, L, r=rr, check=False)
             for rr in r_values if rr < sc.n_agents}
    return E2EReport(scenario=sc, n_replicas=fleet.n, max_new_tokens=L,
                     requests=requests, native=native, sweep=sweep,
                     violations=native.violations)
