"""Spans: named intervals of the program's host phases.

A span is a name, a start and an end on ``time.perf_counter_ns``'s clock
(:data:`now_ns`), the id of the span it ran inside (a stack per thread:
the wall-clock fleet drives engines on threads), a request id and counts
taken at its boundary::

    with spans.span("serve.prefill", tokens=n) as sp:
        ...
        sp.set(late=m)      # a count known only inside

Spans are recorded only while a ``torch.profiler`` is active or between
:func:`start` and :func:`stop`. Otherwise :func:`span` tests that one
flag and returns a shared object that does nothing: no allocation, no
profiler range, no CUDA event. Under the profiler a span is also a
profiler range of its name, so the trace's host events carry it on the
profiler's clock. The range is of a function's scope, not a
``record_function``'s user scope: the profiler mirrors a user-scope range
on the device as a ``gpu_user_annotation`` event spanning the kernels
launched inside it, which a reader of device events would count as busy
time. With ``device=True``, where CUDA is initialised, a span records a
CUDA event on the current stream at entry and at exit; their elapsed
time (``device_ms``) is resolved by :func:`recorded`, never while the
span runs. Elsewhere ``device_ms`` is None.

:func:`span_under` names a span after the innermost one open on its
thread, for a layer (a model's periods) that runs inside other layers'
phases and should not name them.

Recorded spans wait in a bounded buffer in memory, appended under one
lock; spans past its ``CAPACITY`` are counted (:func:`dropped`), not
kept. Lifetime counters stay where they are (``ServeEngine.stats``, the
kernels' ``LAUNCHES``); a span carries only the counts of its boundary.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch

CAPACITY = 1 << 18

now_ns = time.perf_counter_ns                # the clock of every span
_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()
_buf: List["Span"] = []
_dropped = 0
_on = False
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(s: "Span") -> None:
    global _dropped
    with _lock:
        if len(_buf) < CAPACITY:
            _buf.append(s)
        else:
            _dropped += 1


class Span:
    """One interval: ``name``, ``id``, ``parent`` (the enclosing span's
    id or None), ``rid``, ``t0_ns``/``t1_ns`` (:data:`now_ns`),
    ``counts`` and ``device_ms``."""

    __slots__ = ("name", "id", "parent", "rid", "t0_ns", "t1_ns", "counts",
                 "device_ms", "_range", "_events")

    def __init__(self, name: str, rid: Optional[int], counts: dict):
        self.name, self.rid, self.counts = name, rid, counts
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.t0_ns = self.t1_ns = 0
        self.device_ms: Optional[float] = None
        self._range = self._events = None

    def set(self, **counts) -> None:
        """Counts known only inside the span."""
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if _profiling():
            self._range = _range(self.name)
            self._range.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.t0_ns = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = now_ns()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _stack().pop()
        _keep(self)
        return False


class _Off:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, rid: Optional[int] = None, device: bool = False,
         **counts):
    """A context manager timing its body as the span ``name`` (see the
    module's docstring); ``device=True`` on a CUDA path also times it on
    the current stream."""
    if not (_on or _profiling()):
        return _OFF
    s = Span(name, rid, counts)
    if device and torch.cuda.is_initialized():
        s._events = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
    return s


def span_under(suffix: str):
    """A span named after the innermost span open on this thread,
    ``<its name>.<suffix>`` (``suffix`` alone where none is open): for a
    layer that runs inside other layers' phases and should not name
    them."""
    if not (_on or _profiling()):
        return _OFF
    stack = _stack()
    return span(f"{stack[-1].name}.{suffix}" if stack else suffix)


def emit(name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None,
         **counts) -> None:
    """Record an interval already timed on :data:`now_ns`'s clock, inside
    the span open on this thread."""
    if not (_on or _profiling()):
        return
    s = Span(name, rid, counts)
    stack = _stack()
    s.parent = stack[-1].id if stack else None
    s.t0_ns, s.t1_ns = int(t0_ns), int(t1_ns)
    _keep(s)


def start() -> None:
    """Record spans until :func:`stop`, with or without a profiler."""
    global _on
    _on = True


def stop() -> None:
    global _on
    _on = False


def recorded() -> List[Span]:
    """The spans kept so far, in the order they ended, each device time
    resolved (waiting for its end event)."""
    with _lock:
        out = list(_buf)
    for s in out:
        ev = s._events
        if ev is not None:
            ev[1].synchronize()
            s.device_ms = ev[0].elapsed_time(ev[1])
            s._events = None
    return out


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: the buffer was full."""
    return _dropped


def clear() -> None:
    """Forget every kept span and the count of dropped ones."""
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0
