"""Wall-clock chaos harness: kill/pause/slow real worker threads
mid-decode and assert recovery (DESIGN.md §17; counterpart of
``repro.sim.realtime_chaos``, copied).

The §15/§16 harnesses bill faults in virtual time on one event heap;
this one injects them into a live :class:`repro_torch.serve.realtime.
RealtimeFleet` — a chaos thread sleeps (on the fleet's clock) to each
scheduled event and flips the actual worker threads, while a loadgen
thread submits a steady request stream through ``submit()``. Because
every wait goes through the Clock seam, the SAME harness runs

- deterministically under :class:`FakeClock` in CI (two runs produce
  identical transition logs — the fleet determinism acceptance gate),
- for real under :class:`RealClock` against ``ServeEngine`` replicas
  (the ``--wallclock`` benchmark rows).

The report reuses the §16 conformance gates verbatim: no request
permanently lost while ≥ n−r replicas live
(:func:`repro_torch.sim.conformance.check_no_permanent_loss`) and no vote
consumed below the 2f+1 floor (:func:`check_vote_floor`), plus
recovery-time / goodput-under-churn / hedge-fire-rate figures derived
from the controller's transition log and the per-request outcomes.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.dispatch import honest_tokens
from repro_torch.serve.fleet import DEAD, HEALTHY, RECOVERING, FleetConfig
from repro_torch.serve.realtime import (Clock, FakeClock, RealtimeFleet,
                                        StubReplica, Ticket)
from repro_torch.sim import conformance


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One fault: ``kind`` in {"kill", "pause", "slow"}. ``duration``
    is the pause/slow span; ``extra`` the slow-down per request."""
    t: float
    kind: str
    replica: int
    duration: float = 0.0
    extra: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kill", "pause", "slow"):
            raise ValueError(f"unknown chaos kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """A named schedule of faults plus the load around them."""
    name: str
    events: Tuple[ChaosEvent, ...]
    n_requests: int = 24
    arrival_period: float = 0.5    # loadgen spacing, clock seconds
    t_max: float = 120.0           # hard harness horizon, clock seconds

    def t_fault0(self) -> float:
        return min((e.t for e in self.events), default=float("inf"))


def kill_rejoin_plan(n: int, scale: float = 1.0) -> ChaosPlan:
    """Kill one replica mid-stream; the supervisor restarts it from the
    snapshot and probation re-admits it."""
    return ChaosPlan(
        name="kill_rejoin",
        events=(ChaosEvent(t=4.0 * scale, kind="kill", replica=1),),
        n_requests=40, arrival_period=0.5 * scale, t_max=160.0 * scale)


def pause_blip_plan(n: int, scale: float = 1.0) -> ChaosPlan:
    """Stall one replica long enough to be declared dead, then let it
    resume — recovery without any restart."""
    return ChaosPlan(
        name="pause_blip",
        events=(ChaosEvent(t=3.0 * scale, kind="pause", replica=2,
                           duration=12.0 * scale),),
        n_requests=40, arrival_period=0.5 * scale, t_max=160.0 * scale)


def straggler_plan(n: int, scale: float = 1.0) -> ChaosPlan:
    """Make one replica slow enough that deadline hedging must fire."""
    return ChaosPlan(
        name="straggler",
        events=(ChaosEvent(t=2.0 * scale, kind="slow", replica=0,
                           duration=8.0 * scale, extra=6.0 * scale),),
        n_requests=32, arrival_period=0.5 * scale, t_max=160.0 * scale)


def crash_cascade_plan(n: int, scale: float = 1.0) -> ChaosPlan:
    """Kill two replicas back-to-back (n must keep a quorum)."""
    return ChaosPlan(
        name="crash_cascade",
        events=(ChaosEvent(t=4.0 * scale, kind="kill", replica=1),
                ChaosEvent(t=6.0 * scale, kind="kill", replica=3 % n)),
        n_requests=48, arrival_period=0.5 * scale, t_max=200.0 * scale)


PLANS = {p.__name__.removesuffix("_plan"): p for p in
         (kill_rejoin_plan, pause_blip_plan, straggler_plan,
          crash_cascade_plan)}


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one chaos run. ``transition_log`` is the determinism
    fingerprint: (t, replica, old, new) tuples in controller order."""
    plan: str
    n_replicas: int
    r: int
    delivered: int
    lost: int
    shed: int
    dispatches: int
    hedges: int
    retries: int
    restarts: int
    deaths: int
    rejoins: int
    hedge_rate: float              # hedged sends / dispatches
    recovery_time_mean: float      # declared dead -> countable again
    recovery_time_max: float
    sr_pre: float                  # answered fraction before first fault
    sr_post: float                 # answered fraction after last rejoin
    goodput_pre: float             # answered / clock-second, pre-fault
    goodput_post: float
    recovered: float               # sr_post / sr_pre
    n_live_end: int
    violations: List[str]
    transition_log: List[Tuple[float, int, str, str]]
    latencies: List[float]
    drained: bool

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("transition_log")
        d.pop("latencies")
        return d


def _request(i: int, seed: int, length: int = 5) -> np.ndarray:
    rng = np.random.default_rng([seed, 0x717, i])
    return rng.integers(1, 255, length).astype(np.int32)


def _recovery_times(transitions) -> Tuple[List[float], float]:
    t_dead: Dict[int, float] = {}
    recs: List[float] = []
    last_rejoin = float("-inf")
    for tr in transitions:
        if tr.new == DEAD:
            t_dead.setdefault(tr.replica, tr.t)
        elif tr.old == RECOVERING and tr.new == HEALTHY:
            last_rejoin = max(last_rejoin, tr.t)
            if tr.replica in t_dead:
                recs.append(tr.t - t_dead.pop(tr.replica))
    return recs, last_rejoin


def run_realtime_chaos(plan: ChaosPlan, cfg: FleetConfig,
                       clock: Optional[Clock] = None,
                       replicas: Optional[Sequence] = None,
                       work_time: float = 0.3,
                       rejoin_delay: Optional[float] = None,
                       check: bool = True) -> ChaosReport:
    """Run one chaos plan against a live fleet and grade the outcome.

    Defaults to :class:`FakeClock` + :class:`StubReplica` (the CI
    configuration); pass a :class:`RealClock` and ``EngineReplica`` s
    for the wall-clock benchmark. All waits — loadgen spacing, chaos
    scheduling, the completion barrier — go through the clock, so the
    control flow is identical either way.
    """
    clock = clock or FakeClock()
    if replicas is None:
        replicas = [StubReplica(j, clock, work_time=work_time)
                    for j in range(cfg.n_replicas)]
    fleet = RealtimeFleet(replicas, cfg, clock=clock,
                          rejoin_delay=rejoin_delay, jitter_instance=0)
    fleet.start()

    halt = [False]
    tickets: List[Optional[Ticket]] = [None] * plan.n_requests
    # phase-shifted off the monitor-tick grid: two actors waking at the
    # SAME virtual instant run in OS order, which is the one scheduling
    # freedom the fake clock cannot pin — keeping arrivals off every
    # periodic deadline keeps the whole run (not just the transition
    # log) bit-deterministic
    t_arrive: List[float] = [(i + 0.26) * plan.arrival_period
                             for i in range(plan.n_requests)]

    def stopped() -> bool:
        return halt[0]

    def loadgen() -> None:
        clock.thread_started()
        try:
            for i in range(plan.n_requests):
                with clock:
                    clock.wait_for(
                        stopped,
                        timeout=t_arrive[i] - clock.monotonic())
                    if halt[0]:
                        return
                tickets[i] = fleet.submit(_request(i, cfg.seed))
        finally:
            clock.thread_finished()

    def chaos() -> None:
        clock.thread_started()
        try:
            for ev in sorted(plan.events, key=lambda e: (e.t, e.replica)):
                with clock:
                    clock.wait_for(stopped,
                                   timeout=ev.t - clock.monotonic())
                    if halt[0]:
                        return
                if ev.kind == "kill":
                    fleet.kill(ev.replica)
                elif ev.kind == "pause":
                    fleet.pause(ev.replica, ev.duration)
                else:
                    fleet.slow(ev.replica, ev.extra, ev.duration)
        finally:
            clock.thread_finished()

    clock.thread_starting()
    t_load = threading.Thread(target=loadgen, name="chaos-loadgen",
                              daemon=True)
    clock.thread_starting()
    t_chaos = threading.Thread(target=chaos, name="chaos-injector",
                               daemon=True)
    t_load.start()
    t_chaos.start()

    def all_done() -> bool:
        return all(t is not None and t.done for t in tickets)

    # run until every request settled AND the fleet is whole again (so
    # rejoin/recovery figures cover the full arc, not just the load)
    clock.run_until(lambda: all_done() and fleet.settled(), plan.t_max)
    with clock:
        halt[0] = True
        clock.notify_all()
    drained = fleet.shutdown(drain=True, t_max=plan.t_max)
    t_load.join(timeout=30.0)
    t_chaos.join(timeout=30.0)

    # -- grade ---------------------------------------------------------
    results = [t.result if (t is not None and t.done) else None
               for t in tickets]
    delivered = sum(1 for r in results if r is not None)
    lost = len(results) - delivered
    latencies = [float(r.round_latency) for r in results if r is not None]
    n_live_end = fleet.n_threads_alive()
    n_byz = len(cfg.byz_ids)

    violations: List[str] = []
    if check:
        for i, res in enumerate(results):
            v = conformance.check_no_permanent_loss(
                i, int(res is not None), n_live_end, cfg.n_replicas, cfg.r)
            if v:
                violations.append(v)
            if res is not None:
                v = conformance.check_vote_floor(i, res.n_received, n_byz)
                if v:
                    violations.append(v)
                if not n_byz and isinstance(replicas[0], StubReplica):
                    # token parity against the analytic honest stream is
                    # only defined for stubs; engine replicas vote on
                    # real model output
                    want = honest_tokens(_request(i, cfg.seed))
                    if not np.array_equal(res.tokens[:len(want)], want):
                        violations.append(
                            f"request {i}: vote diverged from the honest "
                            f"stream")

    recs, last_rejoin = _recovery_times(fleet.ctrl.transitions)
    t_end = max([clock.monotonic()] + t_arrive)
    t_f0 = plan.t_fault0()

    def window(lo: float, hi: float) -> Tuple[float, float]:
        idx = [i for i, t in enumerate(t_arrive) if lo <= t < hi]
        if not idx:
            return float("nan"), float("nan")
        ans = sum(1 for i in idx if results[i] is not None)
        return ans / len(idx), ans / max(hi - lo, 1e-9)

    if not plan.events:
        sr_pre = sr_post = recovered = 1.0
        gp_pre = gp_post = float("nan")
    else:
        if not np.isfinite(last_rejoin):
            last_rejoin = max(e.t + e.duration for e in plan.events)
        sr_pre, gp_pre = window(0.0, t_f0)
        sr_post, gp_post = window(last_rejoin, t_end + 1e-9)
        recovered = (float("nan")
                     if np.isnan(sr_pre) or np.isnan(sr_post)
                     else sr_post / max(sr_pre, 1e-9))

    return ChaosReport(
        plan=plan.name, n_replicas=cfg.n_replicas, r=cfg.r,
        delivered=delivered, lost=lost, shed=fleet.shed,
        dispatches=fleet.dispatches, hedges=fleet.hedges,
        retries=fleet.retries, restarts=fleet.restarts,
        deaths=fleet.ctrl.deaths, rejoins=fleet.ctrl.rejoins,
        hedge_rate=fleet.hedges / max(fleet.dispatches, 1),
        recovery_time_mean=float(np.mean(recs)) if recs else float("nan"),
        recovery_time_max=float(np.max(recs)) if recs else float("nan"),
        sr_pre=sr_pre, sr_post=sr_post,
        goodput_pre=gp_pre, goodput_post=gp_post, recovered=recovered,
        n_live_end=n_live_end, violations=violations,
        transition_log=[(tr.t, tr.replica, tr.old, tr.new)
                        for tr in fleet.ctrl.transitions],
        latencies=latencies, drained=drained)
