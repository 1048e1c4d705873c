"""Virtual time + seeded event heap (DESIGN.md §10).

Nothing in the simulator reads a wall clock: time is a float that only
moves when events are popped or ``advance_to`` is called, so every run of
the same scenario visits the same states in the same order. Ties on the
event time are broken by insertion sequence number — a deterministic
total order even when schedules collide.

Torch port of ``repro.sim.clock``, verbatim: numpy and ``heapq`` only.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int                      # insertion order: deterministic tie-break
    tag: str
    payload: Any = None


class EventHeap:
    """Min-heap of :class:`Event` ordered by (time, seq)."""

    def __init__(self):
        self._heap: List = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, tag: str, payload: Any = None) -> Event:
        ev = Event(float(time), self._seq, tag, payload)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def peek(self) -> Optional[Event]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def pop_due(self, t: float) -> List[Event]:
        """Pop every event with time <= t, in (time, seq) order."""
        out: List[Event] = []
        while self._heap and self._heap[0][0] <= t:
            out.append(self.pop())
        return out


class VirtualClock:
    """now + an event heap. ``advance_to`` never moves time backwards."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.events = EventHeap()

    def schedule_at(self, t: float, tag: str, payload: Any = None) -> Event:
        return self.events.push(t, tag, payload)

    def schedule_in(self, dt: float, tag: str, payload: Any = None) -> Event:
        return self.events.push(self.now + dt, tag, payload)

    def advance_to(self, t: float) -> List[Event]:
        """Advance to max(now, t); return due events in order."""
        self.now = max(self.now, float(t))
        return self.events.pop_due(self.now)

    def next_event(self) -> Optional[Event]:
        """Pop the earliest event and advance ``now`` to its time."""
        if not len(self.events):
            return None
        ev = self.events.pop()
        self.now = max(self.now, ev.time)
        return ev


def poisson_arrivals(clock: VirtualClock, rate: float, count: int,
                     seed: int, tag: str = "arrival",
                     make_payload=None, start: Optional[float] = None,
                     ) -> List[Event]:
    """Schedule ``count`` seeded Poisson arrivals (exponential gaps at
    ``rate`` per unit virtual time) starting from ``start`` (default:
    ``clock.now``).

    ``start`` is the open-loop segment origin the e2e harness uses for
    requeued bursts: a retry stream begins at the recovery time, not at
    whatever ``now`` the previous drain left behind. The draw sequence is
    a pure function of (seed, count) — ``start`` only translates it, so
    two segments with the same seed emit identical gap sequences.
    """
    if not rate > 0.0:
        raise ValueError(f"need arrival rate > 0, got {rate}")
    if count < 0:
        raise ValueError(f"need count >= 0, got {count}")
    rng = np.random.default_rng(seed)
    t = clock.now if start is None else float(start)
    out = []
    for i in range(count):
        t += float(rng.exponential(1.0 / rate))
        payload = make_payload(i, rng) if make_payload is not None else i
        out.append(clock.schedule_at(t, tag, payload))
    return out
