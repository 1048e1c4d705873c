"""Fleet-controlled e2e replay: detection, hedging, checkpoint rejoin
against real engines (DESIGN.md §16; counterpart of
``repro.sim.fleet_e2e`` over the port's ``sim.e2e`` fleet, whose
replicas decode through the paged flash-decode kernel on a card).

:mod:`repro_torch.sim.e2e` replays a scenario with *replica-serial* virtual
time and a post-hoc first-(n−r) selection — faithful to the paper's
waiting rule, but its retry loop is an oracle (it requeues a lost
request at ``faults.next_recovery``, a quantity no real dispatcher can
read). This module replays the same scenario — same arrivals, same
payload bytes, same ``SimTransport``, same per-superstep billing via
:func:`repro_torch.sim.e2e.step_and_bill` — through the *adaptive* control
plane of :mod:`repro_torch.serve.fleet` on a single global event heap:

- **Detection.** Replicas emit heartbeats while alive; every reply and
  heartbeat feeds the :class:`~repro_torch.serve.fleet.FleetController`'s
  phi-accrual detectors, and the controller is polled at every event
  pop. A crashed replica's silence (under the standing next-heartbeat
  expectation) walks it ``healthy → suspect → dead`` with no transport
  oracle consulted.
- **Hedged dispatch.** An arrival fans out to the ``n−r`` best
  *countable* replicas. A per-request deadline watchdog re-checks the
  quorum against the EWMA-derived timeout: failed copies (connection
  refused / reset — the one per-connection signal a real client does
  observe) are hedged to untried countable replicas, with exponential
  backoff + jitter between waves, bounded by ``max_retries``. While the
  countable fleet is degraded below n−r, requests below the
  ``shed_below`` SLA class are parked and re-dispatched on recovery.
- **Checkpoint rejoin.** A crashed replica's process restarts at its
  scripted recovery instant and restores the fleet's pristine engine
  image through :class:`repro_torch.checkpoint.checkpointer.Checkpointer` →
  :meth:`~repro_torch.serve.engine.ServeEngine.restart` (KV pool rebuilt,
  scheduler fresh; in-flight work was already requeued via
  ``ServeEngine.crash`` at the crash instant). The *controller* learns
  of the rejoin only from observed heartbeats: ``dead → recovering``,
  then ``probation_replies`` further arrivals before the replica is
  countable again — during probation it receives no quorum traffic.

Outcomes land in the same per-copy records as the oracle harness, so
:func:`repro_torch.sim.e2e.analyze_quorum` derives the identical goodput /
p99-vs-r analysis, extended here with recovery-time and goodput-under-
churn metrics plus the §16 conformance gates: no request permanently
lost while ≥ n−r replicas live (:func:`check_no_permanent_loss`), no
vote consumed below the 2f+1 floor (:func:`check_vote_floor`).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.serve.fleet import (DEAD, HEALTHY, RECOVERING, FleetConfig,
                                     FleetController)
from repro_torch.sim import conformance
from repro_torch.sim.e2e import (DELIVERED, DROPPED, LOST, PENDING, R_SWEEP,
                                 CopyOutcome, E2EConfig, E2ERequest,
                                 EngineFleet, QuorumRow, _mark_crashed,
                                 analyze_quorum, byz_at, make_arrivals, r_at,
                                 step_and_bill)
from repro_torch.sim.scenario import Scenario


@dataclasses.dataclass
class FleetMetrics:
    """Recovery / goodput-under-churn figures of one fleet replay."""
    deaths: int                   # detector: healthy/suspect -> dead
    rejoins: int                  # recovering -> healthy (probation done)
    transitions: int
    restarts: int                 # checkpoint restores performed
    hedges: int                   # copies sent to a fresh backup replica
    retries: int                  # copies re-sent to a failed replica
    shed: int                     # low-SLA parks while degraded
    permanently_lost: int         # requests with zero delivered copies
    recovery_time_mean: float     # detected dead -> counted again
    recovery_time_max: float
    rejoin_lag_mean: float        # process restart -> counted again
    sr_pre: float                 # answered fraction, pre-fault arrivals
    sr_post: float                # answered fraction, post-rejoin arrivals
    goodput_pre: float            # answered requests / virtual s, pre
    goodput_post: float
    recovered: float              # sr_post / sr_pre (nan if undefined)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetReport:
    scenario: Scenario
    n_replicas: int
    max_new_tokens: int
    requests: List[E2ERequest]
    native: QuorumRow
    sweep: Dict[int, QuorumRow]
    metrics: FleetMetrics
    violations: List[str]


class _FleetDriver:
    """One global event heap over n real engines + the fleet controller.

    Event kinds (``(t, seq, kind, payload)``; seq breaks ties in
    creation order): ``arrival`` — a request enters the fleet;
    ``step`` — one engine superstep on one replica (chains until its
    queue drains); ``hb`` — a replica's heartbeat; ``rejoin`` — a
    crashed replica's process restart; ``check`` — a request's deadline
    watchdog. The controller is polled at every pop, so suspicion
    accrues exactly as fast as events give it a chance to.
    """

    def __init__(self, sc: Scenario, fleet: EngineFleet, ecfg: E2EConfig,
                 fcfg: FleetConfig, requests: List[E2ERequest],
                 image: Dict[str, np.ndarray]):
        self.sc = sc
        self.fleet = fleet
        self.ecfg = ecfg
        self.fcfg = fcfg
        self.requests = requests
        self.image = image
        n = fleet.n
        self.tp = sc.make_transport()
        self.ctrl = FleetController(fcfg)
        self.rng = np.random.default_rng(sc.seed + 13)
        # SLA classes (0 = best-effort .. 2 = premium), a pure function
        # of the scenario so replays are deterministic
        self.priorities = np.random.default_rng(sc.seed + 7).integers(
            0, 3, len(requests))
        self.heap: List[Tuple[float, int, str, int]] = []
        self.seq = itertools.count()
        self.crashed = [False] * n
        self.step_scheduled = [False] * n
        self.rejoin_pending = [False] * n
        self.rid2copy: List[Dict[int, CopyOutcome]] = [dict()
                                                       for _ in range(n)]
        self.rid2st: List[Dict[int, object]] = [dict() for _ in range(n)]
        self.rid2sent: List[Dict[int, float]] = [dict() for _ in range(n)]
        self.attempts: Dict[int, int] = {}
        self.parked: List[int] = []
        self.restart_t: Dict[int, float] = {}
        self.rejoin_lags: List[float] = []
        self.t_last = 0.0
        # telemetry
        self.hedges = self.retries = self.shed = self.restarts = 0

        for req in requests:
            self._push(req.first_arrival, "arrival", req.idx)
        hb = fcfg.heartbeat_period
        for j in range(n):
            self._push(j * hb / max(n, 1), "hb", j)
        ends = [c.end for c in sc.faults.crashes]
        last_arr = max((r.first_arrival for r in requests), default=0.0)
        self.t_hb_stop = (max([last_arr] + ends)
                          + (fcfg.probation_replies + 6) * hb)

    # -- plumbing --------------------------------------------------------
    def _push(self, t: float, kind: str, payload: int) -> None:
        heapq.heappush(self.heap, (float(t), next(self.seq), kind, payload))

    def _want(self, req: E2ERequest) -> int:
        return self.fleet.n - r_at(self.sc, req.first_arrival)

    def _timeout(self) -> float:
        return self.fcfg.hedge_factor * max(self.ctrl.expected_latency(),
                                            1e-3)

    def _satisfied(self, req: E2ERequest) -> bool:
        return len(req.delivered()) >= self._want(req)

    # -- the loop --------------------------------------------------------
    def run(self) -> None:
        handlers = {"arrival": self._on_arrival, "step": self._on_step,
                    "hb": self._on_hb, "rejoin": self._on_rejoin,
                    "check": self._on_check}
        while True:
            if not self.heap:
                if self.parked:      # fleet never recovered: serve late
                    idxs, self.parked = self.parked, []
                    for idx in idxs:
                        self._fan_out(self.requests[idx], self.t_last)
                    continue
                break
            t, _, kind, payload = heapq.heappop(self.heap)
            self.t_last = max(self.t_last, t)
            self._on_transitions(self.ctrl.poll(t), t)
            handlers[kind](payload, t)

    def _on_transitions(self, fired, t: float) -> None:
        for tr in fired:
            if tr.new == DEAD:
                # every connection to the dead replica is broken: its
                # requests' watchdogs fire now instead of at deadline
                self._kick_requests(t, tr.replica)

    def _maybe_unpark(self, t: float) -> None:
        """Probation done somewhere: shed traffic gets another shot (it
        re-parks if the fleet is still degraded)."""
        if not self.parked or self.ctrl.degraded():
            return
        idxs, self.parked = self.parked, []
        for idx in idxs:
            self._fan_out(self.requests[idx], t)

    # -- arrivals / fan-out ----------------------------------------------
    def _on_arrival(self, idx: int, t: float) -> None:
        if (self.ctrl.degraded()
                and self.priorities[idx] < self.fcfg.shed_below):
            self.parked.append(idx)
            self.shed += 1
            return
        self._fan_out(self.requests[idx], t)

    def _fan_out(self, req: E2ERequest, t: float) -> None:
        want = self._want(req)
        targets = [j for j in self.ctrl.ranked()
                   if self.ctrl.countable(j) and j not in req.copies]
        for j in targets[:want]:
            self._submit_copy(req, j, t)
        self._push(t + self._timeout(), "check", req.idx)

    def _submit_copy(self, req: E2ERequest, j: int, t: float) -> None:
        copy = CopyOutcome(replica=j)
        req.copies[j] = copy
        self.ctrl.note_sent(j, t)
        if self.crashed[j] or not self.tp.alive(j, t):
            # connection refused — observable per-connection, and the
            # unanswered expectation above feeds the accrual detector
            copy.status, copy.t_lost = LOST, t
            if not self.crashed[j]:
                self._crash_replica(j, t)
            return
        eng = self.fleet.engines[j]
        rid = eng.submit(req.prompt, req.max_new,
                         priority=int(self.priorities[req.idx]))
        if not (eng.sched.waiting and eng.sched.waiting[-1].req.rid == rid):
            copy.status, copy.t_lost = LOST, t   # over-capacity reject
            return
        self.rid2copy[j][rid] = copy
        self.rid2st[j][rid] = eng.sched.waiting[-1]
        self.rid2sent[j][rid] = t
        if not self.step_scheduled[j]:
            self.step_scheduled[j] = True
            self._push(t, "step", j)

    # -- engine supersteps -----------------------------------------------
    def _on_step(self, j: int, t: float) -> None:
        self.step_scheduled[j] = False
        if self.crashed[j]:
            return
        eng = self.fleet.engines[j]
        if eng.sched.idle:
            return
        if not self.tp.alive(j, t):            # dead at the step boundary
            self._crash_replica(j, t)
            return
        dt = step_and_bill(eng, j, t, self.tp, self.ecfg)
        t_end = t + dt
        crash = self.sc.faults.first_crash_start(j, t, t_end)
        if crash is not None:
            # the superstep never completed: tokens produced inside it —
            # including any retirement — are lost at the crash instant
            self._crash_replica(j, crash, mid_step=True)
            return
        for rid, copy in list(self.rid2copy[j].items()):
            if copy.status != PENDING:
                continue
            st = self.rid2st[j][rid]
            if np.isinf(copy.t_first) and st.generated:
                copy.t_first = t_end
            if rid in eng.sched.finished:
                fate = self.tp.delivery_fate(j, t_end, None)
                if fate == 0:                  # reply eaten by the network
                    copy.status, copy.t_lost = DROPPED, t_end
                else:
                    copy.status, copy.t_done = DELIVERED, t_end
                    copy.tokens = np.asarray(st.generated, np.int32)
                    self.ctrl.observe(j, t_end)
                    self.ctrl.note_latency(
                        j, t_end - self.rid2sent[j][rid])
                del self.rid2copy[j][rid]
                del self.rid2st[j][rid]
                del self.rid2sent[j][rid]
        if not eng.sched.idle:
            self.step_scheduled[j] = True
            self._push(t_end, "step", j)

    def _crash_replica(self, j: int, t: float,
                       mid_step: bool = False) -> None:
        eng = self.fleet.engines[j]
        _mark_crashed(eng, self.rid2copy[j], t)
        if mid_step:
            for rid, copy in self.rid2copy[j].items():
                if copy.status == PENDING and rid in eng.sched.finished:
                    copy.status, copy.t_lost = LOST, t
        self.crashed[j] = True
        if not self.rejoin_pending[j]:
            self.rejoin_pending[j] = True
            self._push(self.sc.faults.next_recovery(j, t), "rejoin", j)
        # broken connections are observable: affected watchdogs fire now
        self._kick_requests(t, j)

    def _kick_requests(self, t: float, j: int) -> None:
        for req in self.requests:
            if j in req.copies and not req.copies[j].deliverable \
                    and not self._satisfied(req) \
                    and self.attempts.get(req.idx, 0) < self.fcfg.max_retries:
                self._push(t, "check", req.idx)

    # -- heartbeats / rejoin ---------------------------------------------
    def _on_hb(self, j: int, t: float) -> None:
        if self.crashed[j]:
            return                 # chain resumes at the process restart
        if not self.tp.alive(j, t):
            self._crash_replica(j, t)
            return
        self.ctrl.observe(j, t)
        # the monitor expects the next beat: silence past it accrues. At
        # the horizon the chain retires cleanly — no expectation is left
        # dangling, or the idle tail would slowly accuse the whole fleet
        nxt = t + self.fcfg.heartbeat_period
        if nxt <= self.t_hb_stop:
            self.ctrl.note_sent(j, nxt)
            self._push(nxt, "hb", j)
        self._maybe_unpark(t)      # probation may have just completed

    def _on_rejoin(self, j: int, t: float) -> None:
        self.rejoin_pending[j] = False
        if not self.tp.alive(j, t):            # chained/overlapping window
            self.rejoin_pending[j] = True
            self._push(self.sc.faults.next_recovery(j, t), "rejoin", j)
            return
        eng = self.fleet.engines[j]
        eng.restart(self.image)                # checkpoint-based rebuild
        self.rid2copy[j].clear()
        self.rid2st[j].clear()
        self.rid2sent[j].clear()
        self.crashed[j] = False
        self.restart_t[j] = t
        self.restarts += 1
        # first post-restart heartbeat: dead -> recovering (probation);
        # the hb chain it starts carries the probation credits and, once
        # the replica is countable again, un-parks shed traffic
        self.ctrl.observe(j, t)
        nxt = t + self.fcfg.heartbeat_period
        if nxt <= self.t_hb_stop:
            self.ctrl.note_sent(j, nxt)
            self._push(nxt, "hb", j)

    # -- deadline watchdog ------------------------------------------------
    def _on_check(self, idx: int, t: float) -> None:
        req = self.requests[idx]
        want = self._want(req)
        if len(req.delivered()) >= want:
            return
        in_flight = sum(1 for c in req.copies.values()
                        if c.status == PENDING
                        and not self.crashed[c.replica])
        need = want - len(req.delivered()) - in_flight
        if need > 0:
            cand = [j for j in self.ctrl.ranked()
                    if self.ctrl.countable(j)
                    and (j not in req.copies
                         or req.copies[j].status in (LOST, DROPPED))]
            for j in cand[:need]:
                if j in req.copies:
                    self.retries += 1
                    req.retries += 1
                else:
                    self.hedges += 1
                self._submit_copy(req, j, t)
        if len(req.delivered()) >= want:
            return
        attempt = self.attempts.get(idx, 0)
        if attempt >= self.fcfg.max_retries:
            return                 # give up; late copies may still land
        self.attempts[idx] = attempt + 1
        pause = min(self.fcfg.backoff_base * (2.0 ** attempt),
                    self.fcfg.backoff_cap)
        pause *= 1.0 + self.fcfg.backoff_jitter * float(self.rng.random())
        self._push(t + self._timeout() + pause, "check", idx)


def _recovery_metrics(drv: _FleetDriver) -> Tuple[List[float], List[float],
                                                  float]:
    """(recovery times, rejoin lags, last rejoin instant) from the
    controller's transition log: a recovery spans detected-dead to
    counted-again; the lag is restart to counted-again."""
    t_dead: Dict[int, float] = {}
    recoveries: List[float] = []
    lags: List[float] = []
    last_rejoin = float("-inf")
    for tr in drv.ctrl.transitions:
        if tr.new == DEAD:
            t_dead.setdefault(tr.replica, tr.t)
        elif tr.old == RECOVERING and tr.new == HEALTHY:
            last_rejoin = max(last_rejoin, tr.t)
            if tr.replica in t_dead:
                recoveries.append(tr.t - t_dead.pop(tr.replica))
            if tr.replica in drv.restart_t:
                lags.append(tr.t - drv.restart_t[tr.replica])
    return recoveries, lags, last_rejoin


def _window_rates(sc: Scenario, requests: List[E2ERequest],
                  last_rejoin: float) -> Tuple[float, float, float, float,
                                               float]:
    """Success-rate and goodput in the pre-fault vs post-rejoin arrival
    windows. Success rate (answered fraction of the window's arrivals)
    is the Poisson-count-robust recovery figure; goodput (answered per
    virtual second) is reported alongside for the benchmark table."""
    t_done_max = max((c.t_done for r in requests for c in r.delivered()),
                     default=0.0)
    t_end = max(t_done_max,
                max((r.first_arrival for r in requests), default=0.0))
    if not sc.faults.crashes:
        return 1.0, 1.0, float("nan"), float("nan"), 1.0
    t_fault0 = min(c.start for c in sc.faults.crashes)
    if not np.isfinite(last_rejoin):
        last_rejoin = max(c.end for c in sc.faults.crashes)

    def window(lo: float, hi: float) -> Tuple[float, float]:
        reqs = [r for r in requests if lo <= r.first_arrival < hi]
        if not reqs:
            return float("nan"), float("nan")
        answered = sum(1 for r in reqs if r.delivered())
        return answered / len(reqs), answered / max(hi - lo, 1e-9)

    sr_pre, gp_pre = window(0.0, t_fault0)
    sr_post, gp_post = window(last_rejoin, t_end + 1e-9)
    if np.isnan(sr_pre) or np.isnan(sr_post):
        recovered = float("nan")
    else:
        recovered = sr_post / max(sr_pre, 1e-9)
    return sr_pre, sr_post, gp_pre, gp_post, recovered


def run_fleet_e2e(sc: Scenario, fleet: Optional[EngineFleet] = None,
                  ecfg: Optional[E2EConfig] = None, check: bool = True,
                  r_values: Tuple[int, ...] = R_SWEEP,
                  n_requests: Optional[int] = None,
                  fcfg: Optional[FleetConfig] = None) -> FleetReport:
    """Replay one scenario through the fleet controller against real
    replicated engines; returns outcomes + recovery metrics + the §16
    conformance gates. Same engine-reuse contract as
    :func:`repro_torch.sim.e2e.run_e2e` (pass a shared fleet, engines must
    be drained). Without a fleet, one is built on the default device (a
    CUDA card)."""
    if fleet is None:
        fleet = EngineFleet(sc.n_agents, ecfg)
    ecfg = fleet.ecfg
    if fleet.n != sc.n_agents:
        raise ValueError(f"fleet of {fleet.n} replicas cannot replay a "
                         f"{sc.n_agents}-agent scenario")
    if not fleet.drained():
        raise RuntimeError("fleet has in-flight requests from a previous "
                           "run — engines must be drained between replays")
    if fcfg is None:
        fcfg = FleetConfig(n_replicas=sc.n_agents, r=sc.r,
                           byz_ids=sc.byz_ids, attack=sc.attack,
                           seed=sc.seed, shed_below=1)
    L = ecfg.max_new_tokens
    requests = make_arrivals(sc, L)
    if n_requests is not None:
        requests = requests[:n_requests]

    # the fleet's rejoin image: one pristine engine snapshot pushed
    # through the real Checkpointer (atomic write + npz round-trip), so
    # a rejoin restores exactly what a restarted process could read
    with tempfile.TemporaryDirectory(prefix="fleet_ckpt_") as d:
        ck = Checkpointer(d, keep=1)
        ck.save(fleet.engines[0].snapshot(), step=0, blocking=True)
        image, _ = ck.restore_flat()

    drv = _FleetDriver(sc, fleet, ecfg, fcfg, requests, image)
    drv.run()

    native = analyze_quorum(sc, requests, L, r=None, check=check)
    sweep = {rr: analyze_quorum(sc, requests, L, r=rr, check=False)
             for rr in r_values if rr < sc.n_agents}
    violations = list(native.violations)

    recoveries, lags, last_rejoin = _recovery_metrics(drv)
    sr_pre, sr_post, gp_pre, gp_post, recovered = _window_rates(
        sc, requests, last_rejoin)
    n_live_end = sum(sc.faults.alive(j, drv.t_last)
                     for j in range(fleet.n))
    lost = 0
    for req in requests:
        nd = len(req.delivered())
        lost += int(nd == 0)
        if check:
            v = conformance.check_no_permanent_loss(
                req.idx, nd, n_live_end, sc.n_agents,
                r_at(sc, req.first_arrival))
            if v:
                violations.append(v)
            if nd:
                byz_ids, _ = byz_at(sc, req.first_arrival)
                v = conformance.check_vote_floor(
                    req.idx, min(len(req.delivered()), drv._want(req)),
                    len(byz_ids))
                if v:
                    violations.append(v)

    metrics = FleetMetrics(
        deaths=drv.ctrl.deaths, rejoins=drv.ctrl.rejoins,
        transitions=len(drv.ctrl.transitions), restarts=drv.restarts,
        hedges=drv.hedges, retries=drv.retries, shed=drv.shed,
        permanently_lost=lost,
        recovery_time_mean=(float(np.mean(recoveries)) if recoveries
                            else 0.0),
        recovery_time_max=(float(np.max(recoveries)) if recoveries
                           else 0.0),
        rejoin_lag_mean=float(np.mean(lags)) if lags else 0.0,
        sr_pre=float(sr_pre), sr_post=float(sr_post),
        goodput_pre=float(gp_pre), goodput_post=float(gp_post),
        recovered=float(recovered))
    return FleetReport(scenario=sc, n_replicas=fleet.n, max_new_tokens=L,
                       requests=requests, native=native, sweep=sweep,
                       metrics=metrics, violations=violations)
