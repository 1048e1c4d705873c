"""Composable fault schedules + the simulated transport (DESIGN.md §10).

A :class:`FaultSchedule` is a declarative bundle of adversity, all keyed
to the *virtual* wall clock of :mod:`repro_torch.sim.clock`:

- :class:`CrashWindow` — agent j is dead (unreachable, loses in-flight
  work) for ``start <= now < end``; it recovers afterwards and is picked
  back up by the engine/dispatcher.
- :class:`StragglerRamp` — a latency multiplier ramping linearly from 1
  to ``factor`` across the window (flash crowds, thermal throttling);
  back to 1 when the window closes.
- :class:`MessageFaults` — per-upload drop/duplicate probabilities and a
  lognormal reorder jitter on delivery times (arbitrary-but-bounded
  reordering, the delay model of Wu et al., arXiv:2303.18034).
- :class:`ByzantineSwitch` / :class:`ChurnEvent` — *control-plane*
  events applied by the scenario runner between iterations (the paper's
  per-iteration theory makes online changes of r / byz sets sound);
  churn goes through ``AsyncDGDServer.reconfigure``.

:class:`SimTransport` injects the data-plane faults through the
``core.async_engine.Transport`` seam shared by the training engine and
``serve.dispatch``. It draws from its *own* Philox stream (never the
caller's), so event ordering is byte-for-byte reproducible regardless of
how much gradient noise the driven stack consumes — the property the
golden traces pin.

Torch port of ``repro.sim.faults``: numpy, over the port's
``core.async_engine`` seam, so the same seed gives the same fault stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.async_engine import LatencyModel, Transport
from repro_torch.core.byzantine import ATTACKS


@dataclasses.dataclass(frozen=True)
class CrashWindow:
    agent: int
    start: float
    end: float

    def dead(self, j: int, now: float) -> bool:
        return j == self.agent and self.start <= now < self.end


@dataclasses.dataclass(frozen=True)
class StragglerRamp:
    agents: Tuple[int, ...]
    start: float
    end: float
    factor: float = 8.0

    def multiplier(self, j: int, now: float) -> float:
        if j not in self.agents or not self.start <= now < self.end:
            return 1.0
        frac = (now - self.start) / max(self.end - self.start, 1e-12)
        return 1.0 + (self.factor - 1.0) * frac


@dataclasses.dataclass(frozen=True)
class MessageFaults:
    drop_p: float = 0.0           # upload lost; agent redoes the work
    dup_p: float = 0.0            # upload delivered twice (billed twice)
    reorder_jitter: float = 0.0   # sigma of lognormal delivery-time jitter


@dataclasses.dataclass(frozen=True)
class ByzantineSwitch:
    """At virtual time ``at``: the set of faulty agents / the attack they
    mount changes (covers 'attacker adapts mid-run')."""
    at: float
    byz_ids: Tuple[int, ...]
    attack: Optional[str]

    def __post_init__(self):
        if self.attack is not None and self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}; "
                             f"have {sorted(ATTACKS)}")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """At virtual time ``at``: elastic reconfiguration (r / rule / tau
    change) applied through ``AsyncDGDServer.reconfigure``."""
    at: float
    changes: Tuple[Tuple[str, object], ...]   # (field, value) pairs

    def as_dict(self) -> Dict[str, object]:
        return dict(self.changes)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    crashes: Tuple[CrashWindow, ...] = ()
    ramps: Tuple[StragglerRamp, ...] = ()
    messages: MessageFaults = MessageFaults()
    switches: Tuple[ByzantineSwitch, ...] = ()
    churn: Tuple[ChurnEvent, ...] = ()

    # -- data-plane queries (used by SimTransport) -----------------------
    def alive(self, j: int, now: float) -> bool:
        return not any(c.dead(j, now) for c in self.crashes)

    def alive_throughout(self, j: int, t0: float, t1: float) -> bool:
        """No crash window touches agent j anywhere in [t0, t1] — the
        honest per-step liveness witness (endpoint sampling would miss a
        window contained inside one long step)."""
        return not any(c.agent == j and c.start <= t1 and c.end > t0
                       for c in self.crashes)

    def first_crash_start(self, j: int, t0: float,
                          t1: float) -> Optional[float]:
        """Earliest crash-window start for agent j inside ``(t0, t1]`` —
        the mid-superstep query of the e2e harness: a window opening
        while a decode superstep is in flight kills the step's tokens at
        that instant. A window already open at ``t0`` is the *step-start*
        case (``alive`` is false there), not a mid-step crash."""
        starts = [c.start for c in self.crashes
                  if c.agent == j and t0 < c.start <= t1 and c.end > c.start]
        return min(starts) if starts else None

    def next_recovery(self, j: int, now: float) -> float:
        """Earliest time >= now at which agent j is outside every crash
        window — where a crashed replica comes back empty. Chained /
        overlapping windows are walked to a genuinely-alive instant."""
        t = float(now)
        while not self.alive(j, t):
            t = min(c.end for c in self.crashes if c.dead(j, t))
        return t

    def lat_multiplier(self, j: int, now: float) -> float:
        m = 1.0
        for ramp in self.ramps:
            m *= ramp.multiplier(j, now)
        return m

    # -- control-plane events (applied by the scenario runner) -----------
    def control_events(self) -> List[Tuple[float, str, object]]:
        """(time, kind, event) sorted by time; ties keep (switch, churn)
        declaration order."""
        evs = [(s.at, "switch", s) for s in self.switches]
        evs += [(c.at, "churn", c) for c in self.churn]
        return sorted(evs, key=lambda e: (e[0], 0 if e[1] == "switch" else 1))


class SimTransport(Transport):
    """Fault-injecting transport over a base :class:`LatencyModel`.

    Owns a seeded generator (ignores the caller's): two runs of the same
    scenario produce identical event orderings even if the driven stack
    consumes a different number of rng draws in between. ``drops`` /
    ``dups`` count injected message faults for telemetry assertions.
    """

    def __init__(self, n: int, schedule: FaultSchedule,
                 latency: Optional[LatencyModel] = None, seed: int = 0):
        self.n = n
        self.sched = schedule
        self.lat = latency or LatencyModel(n_agents=n)
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        self.drops = 0
        self.dups = 0
        # per-agent drop mask of the most recent fresh round, for checks
        # that need to know WHO was dropped, not just how many
        self.last_round_drops: Optional[np.ndarray] = None

    # -- Transport interface --------------------------------------------
    def alive(self, j: int, now: float) -> bool:
        return self.sched.alive(j, now)

    def round_latencies(self, now: float, rng) -> np.ndarray:
        out = self.lat.sample(self.rng)
        out *= np.array([self.sched.lat_multiplier(j, now)
                         for j in range(self.n)])
        m = self.sched.messages
        if m.reorder_jitter:
            out *= np.exp(m.reorder_jitter * self.rng.standard_normal(self.n))
        if m.drop_p:
            # fresh-mode drops: the whole round-trip fails -> the agent
            # never makes S^t this round (inf = undeliverable)
            drop = self.rng.random(self.n) < m.drop_p
            self.drops += int(drop.sum())
            self.last_round_drops = drop
            out[drop] = np.inf
        else:
            self.last_round_drops = None
        return out

    def task_latency(self, j: int, now: float, rng) -> float:
        out = self.lat.sample_one(j, self.rng) \
            * self.sched.lat_multiplier(j, now)
        m = self.sched.messages
        if m.reorder_jitter:
            # jittered completion times = reordered deliveries in the
            # event-driven stale loop (it pops deliveries time-ordered)
            out *= float(np.exp(m.reorder_jitter * self.rng.standard_normal()))
        return out

    def delivery_fate(self, j: int, now: float, rng) -> int:
        m = self.sched.messages
        if m.drop_p or m.dup_p:
            u = float(self.rng.random())
            if u < m.drop_p:
                self.drops += 1
                return 0
            if u < m.drop_p + m.dup_p:
                self.dups += 1
                return 2
        return 1

    # -- snapshot/restore ------------------------------------------------
    def state_dict(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "drops": self.drops, "dups": self.dups}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.drops = state["drops"]
        self.dups = state["dups"]
