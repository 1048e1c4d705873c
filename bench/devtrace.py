"""Device traces of a run's traced window (``--trace 1``).

``torch.profiler`` records the host's operations and the card's kernels,
copies and sets over whole steps of the window. ``device_spans`` and
``busy_us`` are frozen copies of ``chip_smoke.py``'s: a span is
(start us, end us, name), and busy time is the union of the device spans,
since a dependent launch (the decode's combine kernel) overlaps the one
before it. An idle gap of the device is named by the innermost host
operation in flight at its middle.
"""
from __future__ import annotations

import bisect
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

Span = Tuple[float, float, str]

# a traced run profiles whole steps for at least this long
TRACE_SECONDS = 5.0

_T = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's progress on standard error."""
    print(f"[bench {time.monotonic() - _T:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def device_spans(events) -> List[Span]:
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def host_spans(events) -> List[Span]:
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU)


def busy_us(spans: List[Span]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def top_ops(spans: List[Span], n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time, in seconds."""
    by: Dict[str, float] = {}
    for a, b, name in spans:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k, v * 1e-6] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: List[Span], host: List[Span], t0: float, t1: float,
              n: int = 10) -> List[List]:
    """Device idle time between ``t0`` and ``t1`` (profiler us), summed by
    the innermost host operation in flight at each gap's middle; the
    ``n`` largest sums, in seconds."""
    starts = [s[0] for s in host]
    gaps, end = [], t0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host idle (no operation)"
        for j in range(i, max(i - 400, -1), -1):   # innermost: latest start
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k, v * 1e-6] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Profiles whole steps: ``start()`` at a step boundary, ``stop()`` at
    a later one (both synchronise the card). ``window_s`` is the host
    clock's length of the traced window."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self.overhead_s = 0.0       # inside start() and stop()
        self.dev: List[Span] = []
        self.host: List[Span] = []
        self.t_range = (0.0, 0.0)
        self.active = False
        self.done = False

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start the profiler's tracing once in set-up (its first start
        takes seconds), around one small device operation."""
        with self._profile():
            torch.ones(8, device="cuda").sum().item()

    def start(self) -> None:
        t = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self._t = time.perf_counter()
        self.overhead_s += self._t - t
        self.active = True

    def stop(self) -> None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.window_s = t - self._t
        self.prof.__exit__(None, None, None)
        self.overhead_s += time.perf_counter() - t
        self.active, self.done = False, True

    def reduce(self) -> None:
        """Read the trace into spans (after the measured window)."""
        events = self.prof.events()
        self.dev = device_spans(events)
        self.host = host_spans(events)
        lo = min([s[0] for s in self.host] + [s[0] for s in self.dev])
        hi = max([s[1] for s in self.host] + [s[1] for s in self.dev])
        self.t_range = (lo, hi)
        self.prof = None

    def busy_s(self, name: Optional[str] = None) -> float:
        spans = self.dev if name is None else [s for s in self.dev
                                               if name in s[2]]
        return busy_us(spans) * 1e-6

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": top_ops(self.dev),
                "idle_gaps": idle_gaps(self.dev, self.host, *self.t_range)}
