"""Declarative scenarios + the train/serve runners (DESIGN.md §10).

One :class:`Scenario` is a complete, seeded description of a cluster
under adversity — agent count, redundancy r, engine mode, fault schedule,
latency statistics, workload — and drives **both** stacks through the
same :class:`repro_torch.sim.faults.SimTransport`:

- :func:`run_train` — ``AsyncDGDServer`` over certified quadratic costs
  (``core.redundancy``), stepping one iteration at a time so the §3.2
  T-set invariants, the rule-(15) aggregation-age bound and liveness are
  checked at every step; the Theorem-2 envelope is checked on the final
  iterate (it bounds the plateau, not the transient). Control-plane
  events (Byzantine switches, elastic churn) fire off the virtual clock
  between iterations.
- :func:`run_serve` — ``serve.dispatch.RedundantDispatcher`` over a
  seeded Poisson request stream, with the per-request majority-vote
  soundness check.

The registry holds named scenarios (``flash_crowd``, ``rolling_restart``,
``partition_heal``, ``byzantine_flip_midrun``, …); golden traces for each
are committed under ``tests/golden/`` (see :mod:`repro_torch.sim.golden`).

Torch port of ``repro.sim.scenario``: the same registry, names, fields
and seeds. ``run_train`` also takes the engine's ``device`` (a CUDA card
unless the caller asks for the CPU) and ``agg_backend`` (``"host"``, the
reference's rule op by op, or ``"device"``, the resident ledger and the
aggregation kernels); ``run_serve`` is numpy and runs anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.async_engine import EngineConfig, History, LatencyModel
from repro_torch.core.redundancy import (QuadraticCosts,
                                         make_redundant_quadratics)
from repro_torch.core.server import AsyncDGDServer
from repro_torch.optim.schedules import paper_eta_bar
from repro_torch.serve.dispatch import (DispatchConfig, NoQuorumError,
                                        RedundantDispatcher, honest_tokens)
from repro_torch.sim import conformance
from repro_torch.sim.clock import VirtualClock, poisson_arrivals
from repro_torch.sim.faults import (ByzantineSwitch, ChurnEvent, CrashWindow,
                                    FaultSchedule, MessageFaults,
                                    SimTransport, StragglerRamp)


@dataclasses.dataclass(frozen=True)
class Expectations:
    """What the scenario promises; the runners turn these into checks."""
    check_envelope: bool = True       # Theorem-2 error-vs-(r, eps) ball
    envelope_slack: float = 1.5
    max_dist: Optional[float] = None  # absolute ||x-x*|| cap (Byzantine)
    liveness: bool = True
    vote_exact: bool = True           # serve: vote == honest stream


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    # cluster + algorithm
    n_agents: int = 8
    r: int = 2
    mode: str = "fresh"               # fresh | stale (training engine)
    tau: int = 0
    rule: str = "sum"
    f: int = 0
    byz_ids: Tuple[int, ...] = ()
    attack: Optional[str] = None
    # costs (certified quadratics)
    dim: int = 4
    spread: float = 0.02
    cond: float = 1.5
    proj_gamma: float = 50.0
    # run
    iters: int = 400
    seed: int = 0
    # latency statistics (paper §5 heavy tail)
    mean_lat: float = 1.0
    sigma: float = 0.25
    stragglers: Tuple[int, ...] = ()
    straggler_factor: float = 10.0
    comm: float = 0.05
    # adversity
    faults: FaultSchedule = FaultSchedule()
    # serving workload
    n_requests: int = 40
    # shared-prefix request mix (DESIGN.md §13). prefix_share=0 keeps the
    # original unique-payload stream byte-identical (golden traces);
    # anything >0 switches to prefix_mix_requests-style payloads
    prefix_share: float = 0.0
    prefix_len: int = 24
    suffix_len: int = 8
    expect: Expectations = Expectations()

    # -- factories -------------------------------------------------------
    def make_costs(self) -> QuadraticCosts:
        return make_redundant_quadratics(self.n_agents, self.dim,
                                         spread=self.spread, cond=self.cond,
                                         seed=self.seed)

    def make_latency(self) -> LatencyModel:
        return LatencyModel(n_agents=self.n_agents, mean=self.mean_lat,
                            sigma=self.sigma, straggler_ids=self.stragglers,
                            straggler_factor=self.straggler_factor,
                            comm=self.comm)

    def make_transport(self) -> SimTransport:
        return SimTransport(self.n_agents, self.faults, self.make_latency(),
                            seed=self.seed)

    @property
    def r_max(self) -> int:
        """Largest r the run ever uses (churn included) — the envelope is
        certified at this value (monotone in r, so conservative)."""
        r = self.r
        for ev in self.faults.churn:
            r = max(r, int(ev.as_dict().get("r", r)))
        return r

    @property
    def horizon(self) -> float:
        """Rough virtual-time extent of the run (for workload pacing)."""
        return float(self.iters) * (self.mean_lat + 2 * self.comm)


# ---------------------------------------------------------------------------
# registry

SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None


register(Scenario(
    name="steady_state",
    description="No faults: the baseline both stacks must reproduce "
                "byte-for-byte; envelope + liveness at r=2.",
    r=2, iters=400, seed=11))

register(Scenario(
    name="flash_crowd",
    description="5 of 8 agents ramp to 10x latency mid-run (load surge); "
                "first-(n-r) keeps rounds on the fast minority.",
    r=3, iters=400, seed=12,
    faults=FaultSchedule(ramps=(
        StragglerRamp(agents=(0, 1, 2, 3, 4), start=120.0, end=300.0,
                      factor=10.0),))))

register(Scenario(
    name="flash_crowd_prefix",
    description="flash_crowd's straggler surge with a 90% shared-prefix "
                "request mix: the redundancy lives in the request stream "
                "itself. Dispatch-level replay stays vote-exact (replicas "
                "are stateless here); the engine-level TTFT win of "
                "serve.prefix on this mix is measured in "
                "benchmarks/serve_latency.py --prefix-share.",
    r=3, iters=200, seed=21, prefix_share=0.9, prefix_len=24, suffix_len=8,
    faults=FaultSchedule(ramps=(
        StragglerRamp(agents=(0, 1, 2, 3, 4), start=60.0, end=150.0,
                      factor=10.0),))))

register(Scenario(
    name="rolling_restart",
    description="Each agent crash/recovers in turn (staggered maintenance "
                "windows) under the stale rule (15).",
    r=2, mode="stale", tau=3, iters=420, seed=13,
    faults=FaultSchedule(crashes=tuple(
        CrashWindow(agent=k, start=40.0 + 45.0 * k, end=65.0 + 45.0 * k)
        for k in range(8)))))

register(Scenario(
    name="partition_heal",
    description="Half the fleet partitions away for a long window, then "
                "heals; the server degrades elastically (S^t < n-r) and "
                "re-converges inside the envelope after the heal.",
    r=2, iters=460, seed=14,
    faults=FaultSchedule(crashes=tuple(
        CrashWindow(agent=k, start=130.0, end=270.0) for k in (4, 5, 6, 7)))))

register(Scenario(
    name="byzantine_flip_midrun",
    description="2 Byzantine agents switch attacks mid-run (sign_flip -> "
                "little_is_enough -> large_norm); CGE keeps the iterate "
                "inside a Theta(eps) ball through every switch.",
    r=1, rule="cge", f=2, byz_ids=(0, 5), attack="sign_flip",
    iters=450, seed=15,
    faults=FaultSchedule(switches=(
        ByzantineSwitch(at=160.0, byz_ids=(0, 5), attack="little_is_enough"),
        ByzantineSwitch(at=320.0, byz_ids=(0, 5), attack="large_norm"))),
    expect=Expectations(check_envelope=False, max_dist=0.2)))

register(Scenario(
    name="churn_elastic",
    description="Elastic policy churn: r 0 -> 3 -> 1 via reconfigure() "
                "with a crash window in between; history and the wall "
                "clock stay monotone across every switch.",
    r=0, iters=450, seed=16,
    faults=FaultSchedule(
        crashes=(CrashWindow(agent=2, start=220.0, end=290.0),),
        churn=(ChurnEvent(at=160.0, changes=(("r", 3),)),
               ChurnEvent(at=330.0, changes=(("r", 1),))))))

register(Scenario(
    name="message_chaos",
    description="Lossy, duplicating, reordering network under the stale "
                "rule: 12% drops, 8% duplicates, lognormal delivery "
                "jitter; T-set invariants hold at every step.",
    r=2, mode="stale", tau=4, iters=400, seed=17,
    faults=FaultSchedule(messages=MessageFaults(
        drop_p=0.12, dup_p=0.08, reorder_jitter=0.25)),
    expect=Expectations(envelope_slack=2.0)))

register(Scenario(
    name="stale_storm",
    description="3 permanent 20x stragglers under tau=4: their uploads "
                "age out of T^t and the fast majority carries the run.",
    r=3, mode="stale", tau=4, iters=400, seed=18,
    stragglers=(1, 4, 6), straggler_factor=20.0))

register(Scenario(
    name="e2e_steady",
    description="Steady-state anchor of the e2e load harness "
                "(repro.sim.e2e): no faults, r=2, a denser Poisson "
                "request stream sized for real replicated ServeEngines. "
                "The stand-in replay committed as its golden trace is "
                "the reference the real-engine run is diffed against "
                "(same arrivals, same vote rule).",
    r=2, iters=200, seed=23, n_requests=32))

register(Scenario(
    name="diurnal_availability",
    description="FLGo-style diurnal availability profile: the fleet "
                "splits into two 'timezones' of 4 agents whose members "
                "drop out in staggered night windows, two day/night "
                "cycles per run — availability is periodic and "
                "predictable, never adversarial. The server rides each "
                "trough elastically (S^t from the awake half) and "
                "re-enters the envelope after the last dawn.",
    r=2, iters=440, seed=24,
    faults=FaultSchedule(crashes=tuple(
        [CrashWindow(agent=j, start=50.0 + 5.0 * j, end=110.0 + 5.0 * j)
         for j in range(4)]
        + [CrashWindow(agent=4 + k, start=130.0 + 5.0 * k,
                       end=190.0 + 5.0 * k) for k in range(4)]
        + [CrashWindow(agent=j, start=210.0 + 5.0 * j, end=260.0 + 5.0 * j)
           for j in range(4)]
        + [CrashWindow(agent=4 + k, start=270.0 + 5.0 * k,
                       end=320.0 + 5.0 * k) for k in range(4)])),
    expect=Expectations(envelope_slack=2.0)))

register(Scenario(
    name="lognormal_churn",
    description="FLGo-style lognormal responsiveness under churn: "
                "heavy-tailed per-agent compute (sigma=0.8 lognormal), "
                "5%/3% message drop/duplication, and one short staggered "
                "maintenance window per agent under the stale rule — "
                "the system-simulator profile of client heterogeneity, "
                "as latency statistics rather than scripted stragglers.",
    r=2, mode="stale", tau=4, sigma=0.8, iters=420, seed=25,
    faults=FaultSchedule(
        crashes=tuple(CrashWindow(agent=k, start=50.0 + 35.0 * k,
                                  end=68.0 + 35.0 * k) for k in range(8)),
        messages=MessageFaults(drop_p=0.05, dup_p=0.03)),
    expect=Expectations(envelope_slack=2.0)))

register(Scenario(
    name="crash_cascade",
    description="Nested cascade of up to r=3 simultaneous crashes with "
                "staggered recovery; convergence never leaves the "
                "envelope.",
    r=3, iters=450, seed=19,
    faults=FaultSchedule(crashes=(
        CrashWindow(agent=0, start=100.0, end=340.0),
        CrashWindow(agent=1, start=140.0, end=300.0),
        CrashWindow(agent=2, start=180.0, end=260.0)))))


# ---------------------------------------------------------------------------
# runners

@dataclasses.dataclass
class TrainReport:
    scenario: Scenario
    hist: History
    trace: List[dict]
    violations: List[str]
    envelope: Optional[conformance.Envelope]
    transport: SimTransport
    server: AsyncDGDServer


@dataclasses.dataclass
class ServeReport:
    scenario: Scenario
    trace: List[dict]
    violations: List[str]
    latencies: np.ndarray
    transport: SimTransport
    dispatcher: RedundantDispatcher


def run_train(sc: Scenario, check: bool = True, *, device="cuda",
              agg_backend: str = "host") -> TrainReport:
    """Drive ``AsyncDGDServer`` through the scenario, one iteration per
    loop turn, with conformance checked at every step. ``device`` and
    ``agg_backend`` go to ``EngineConfig``: where the rule runs, and
    whether it is the reference's op by op or the resident ledger's
    kernel step."""
    costs = sc.make_costs()
    env = conformance.certify_envelope(costs, sc.r_max)
    mu = costs.mu()
    if env.alpha > 0:             # Theorem-2 constant step eta_bar / 2
        eta = paper_eta_bar(mu, env.gamma, env.alpha, sc.n_agents) / 2
    else:
        eta = 0.5 / (mu * sc.n_agents)
    transport = sc.make_transport()
    cfg = EngineConfig(n_agents=sc.n_agents, r=sc.r, mode=sc.mode,
                       tau=sc.tau, f=sc.f, byz_ids=sc.byz_ids,
                       attack=sc.attack, rule=sc.rule,
                       step_size=lambda t: eta, proj_gamma=sc.proj_gamma,
                       seed=sc.seed, agg_backend=agg_backend, device=device)
    srv = AsyncDGDServer(lambda j, x, rng: costs.grad(j, x),
                         np.zeros(sc.dim), cfg, latency=sc.make_latency(),
                         loss_fn=costs.loss, x_star=costs.global_min(),
                         transport=transport)
    clock = VirtualClock()
    for (at, kind, ev) in sc.faults.control_events():
        clock.schedule_at(at, kind, ev)

    trace: List[dict] = []
    violations: List[str] = []
    for _ in range(sc.iters):
        e = srv.engine
        for cev in clock.advance_to(e.clock):
            ev = cev.payload
            if cev.tag == "switch":
                srv.reconfigure(byz_ids=ev.byz_ids, attack=ev.attack)
            else:
                srv.reconfigure(**ev.as_dict())
        e = srv.engine
        c = e.cfg
        clock_pre = e.clock
        srv.run(1)
        e = srv.engine
        h = e.hist
        t = e.t - 1               # the iteration just executed
        # liveness witness over the whole step interval: an agent whose
        # crash window lies entirely inside one long step counts as down
        alive_min = sum(sc.faults.alive_throughout(j, clock_pre, e.clock)
                        for j in range(sc.n_agents))
        # fresh mode: a drop excuses the liveness promise only if it hit
        # an agent that would otherwise have been usable — Byzantine
        # uploads never drop (the engine re-keys them to 0) and crashed
        # agents were already excluded. stale mode: dropped uploads are
        # re-tried within the step, so drops never excuse missing n-r
        drops_step = 0
        if sc.mode == "fresh" and transport.last_round_drops is not None:
            mask = transport.last_round_drops
            drops_step = sum(
                1 for j in range(sc.n_agents)
                if mask[j] and j not in c.byz_ids
                and sc.faults.alive(j, clock_pre))
        if check:
            if sc.mode == "stale":
                v = conformance.check_t_sets(e._ledger_ts, t, c.tau,
                                             sc.n_agents)
                if v:
                    violations.append(v)
                v = conformance.check_aggregation_ages(h.max_age[-1],
                                                       c.tau, t)
                if v:
                    violations.append(v)
                v = conformance.check_staleness_bound(h.staleness[-1],
                                                      c.tau, t)
                if v:
                    violations.append(v)
            if sc.expect.liveness:
                v = conformance.check_liveness(t, sc.n_agents, c.r,
                                               alive_min, h.n_rx[-1],
                                               h.comm_time[-1],
                                               dropped=drops_step)
                if v:
                    violations.append(v)
        trace.append({"t": t, "comm": float(h.comm_time[-1]),
                      "loss": float(h.loss[-1]), "dist": float(h.dist[-1]),
                      "n_rx": int(h.n_rx[-1]),
                      "stale": float(h.staleness[-1]),
                      "amax": float(h.max_age[-1]), "r": int(c.r)})

    h = srv.engine.hist
    if check and sc.expect.check_envelope:
        v = conformance.check_envelope(h.dist[-1], env,
                                       sc.expect.envelope_slack)
        if v:
            violations.append(v)
    if check and sc.expect.max_dist is not None \
            and h.dist[-1] > sc.expect.max_dist:
        violations.append(f"final ||x-x*||={h.dist[-1]:.4g} > "
                          f"max_dist={sc.expect.max_dist}")
    return TrainReport(scenario=sc, hist=h, trace=trace,
                       violations=violations, envelope=env,
                       transport=transport, server=srv)


def request_loadgen(sc: Scenario):
    """The scenario's request-payload factory — the *loadgen seam*
    (DESIGN.md §15): ``run_serve`` and the e2e harness
    (:mod:`repro_torch.sim.e2e`) both draw their open-loop Poisson request
    streams through this one function, so 'the workload' of a scenario
    is a single pure function of (scenario, seed) no matter which stack
    replays it. Payload token ids live in [0, 256) — valid prompts for
    every ``reduced()`` registry arch (vocab 256), which is what lets the
    identical byte stream drive the honest stand-in AND real engines."""
    if sc.prefix_share > 0.0:
        # shared-prefix mix: one common prompt prefix drawn up front,
        # then per-arrival coin flips — same rng discipline as
        # dispatch.prefix_mix_requests but driven by the arrival rng so
        # the stream stays a pure function of (scenario, seed)
        shared = np.random.default_rng(sc.seed + 2).integers(
            0, 256, sc.prefix_len).astype(np.int32)

        def make_payload(i, rng):
            if rng.random() < sc.prefix_share:
                suffix = rng.integers(0, 256, sc.suffix_len).astype(np.int32)
                return np.concatenate([shared, suffix])
            return rng.integers(0, 256,
                                sc.prefix_len + sc.suffix_len).astype(np.int32)
        return make_payload
    # original unique-payload stream, byte-identical
    return lambda i, rng: rng.integers(0, 256, 8).astype(np.int32)


def arrival_rate(sc: Scenario) -> float:
    """Open-loop Poisson rate shared by both serve replays."""
    return max(sc.n_requests / max(sc.horizon, 1.0), 1e-6)


def run_serve(sc: Scenario, check: bool = True,
              replica_fn=None, honest_ref=None) -> ServeReport:
    """Drive ``serve.dispatch`` through the *same* scenario: identical
    transport (fresh instance, same seed), Byzantine switches and r-churn
    applied to the dispatcher, over a seeded Poisson request stream.

    ``replica_fn(j, request) -> (L,) int32`` is the injectable replica
    payload factory; the default is the :func:`honest_tokens` stand-in,
    byte-identical to the pre-seam runner (golden traces replay
    unchanged). ``honest_ref(request)`` is the clean stream the vote
    check compares against — it must be what an *honest* replica
    returns; the default mirrors the default ``replica_fn``."""
    if replica_fn is None:
        replica_fn = lambda j, req: honest_tokens(req)
        if honest_ref is None:
            honest_ref = honest_tokens
    elif honest_ref is None:
        # honest replicas are id-independent by contract; corruption is
        # applied by the dispatcher *after* replica_fn, so any replica id
        # yields the honest stream
        honest_ref = lambda req: replica_fn(0, req)
    transport = sc.make_transport()
    cfg = DispatchConfig(n_replicas=sc.n_agents, r=sc.r,
                         byz_ids=sc.byz_ids, attack=sc.attack, seed=sc.seed)
    disp = RedundantDispatcher(replica_fn, cfg, transport=transport)
    clock = VirtualClock()
    poisson_arrivals(
        clock, arrival_rate(sc), sc.n_requests, seed=sc.seed + 1,
        tag="request", make_payload=request_loadgen(sc))
    for (at, kind, ev) in sc.faults.control_events():
        clock.schedule_at(at, kind, ev)

    trace: List[dict] = []
    violations: List[str] = []
    lats: List[float] = []
    req_idx = 0
    while True:
        cev = clock.next_event()
        if cev is None:
            break
        ev = cev.payload
        if cev.tag == "switch":
            disp.cfg = dataclasses.replace(disp.cfg, byz_ids=ev.byz_ids,
                                           attack=ev.attack)
            continue
        if cev.tag == "churn":
            changes = ev.as_dict()
            if "r" in changes:    # rule/tau are train-only knobs
                disp.cfg = dataclasses.replace(disp.cfg,
                                               r=int(changes["r"]))
            continue
        disp.now = max(disp.now, cev.time)
        try:
            res = disp.dispatch(ev)
        except NoQuorumError as exc:
            # total outage: a conformance violation, not a harness crash
            violations.append(f"request {req_idx}: {exc}")
            lats.append(float("inf"))
            trace.append({"i": req_idx, "lat": float("inf"), "used": [],
                          "n_received": 0, "crc": 0})
            req_idx += 1
            continue
        lats.append(res.round_latency)
        if check and sc.expect.vote_exact:
            v = conformance.check_vote(res.tokens, honest_ref(ev),
                                       res.used, disp.cfg.byz_ids, req_idx)
            if v:
                violations.append(v)
        if check and not np.isfinite(res.round_latency):
            violations.append(f"request {req_idx}: infinite round latency")
        if check and not res.quorum_honest:
            violations.append(
                f"request {req_idx}: quorum lost its honest majority "
                f"(used={res.used}, byz={disp.cfg.byz_ids}) — tokens "
                f"untrustworthy")
        trace.append({"i": req_idx, "lat": float(res.round_latency),
                      "used": list(res.used),
                      "n_received": int(res.n_received),
                      "crc": int(np.uint32(np.sum(res.tokens.astype(
                          np.int64) * (np.arange(res.tokens.size) + 1))))})
        req_idx += 1
    return ServeReport(scenario=sc, trace=trace, violations=violations,
                       latencies=np.asarray(lats), transport=transport,
                       dispatcher=disp)
