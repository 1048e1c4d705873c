"""Wall-clock fleet frontend: thread-per-replica serving over real timers
(DESIGN.md §17; counterpart of ``repro.serve.realtime``, copied: only the
fleet's own threads register with the clock, and an ``EngineReplica``'s
torch calls never wait on it, so ``FakeClock`` runs stay bit-identical to
the reference's).

The §16 control plane (``PhiAccrualDetector`` / ``FleetController`` /
the hedged-dispatch policy) is pure — time is fed in by the caller. The
e2e harness feeds it virtual time from one event heap; this module feeds
it **real monotonic timestamps** from n worker threads, one per
``ServeEngine`` replica, turning the chaos harness into a deployable
serving frontend:

- every replica runs on its own worker thread behind a bounded inbound
  queue; replies and heartbeats land in an **evidence inbox**;
- a single monitor thread drains the inbox in ``(t, replica, kind)``
  order, is the *only* writer to the ``FleetController`` (observe /
  note_latency / poll), fails in-flight copies on a death, and restarts
  killed workers from the pristine ``ServeEngine.snapshot()`` image
  after ``rejoin_delay`` (checkpoint-based rejoin);
- ``dispatch()`` runs on the caller's thread: fan out to the n−r best
  countable replicas, probe the rest, wait on a condition variable
  against the EWMA-derived deadline, hedge to untried replicas on a
  stall, accept an elastic quorum down to the 2f+1 vote floor, retry
  with jittered exponential backoff and raise the typed
  ``NoQuorumError`` after ``max_retries``; low-SLA traffic is shed
  (parked until the fleet recovers) while degraded.

The robustness lynchpin is the **clock seam**: every read of time and
every blocking wait goes through a :class:`Clock`. :class:`RealClock`
is a thin veneer over ``time.monotonic`` + one ``threading.Condition``;
:class:`FakeClock` shares the same condition-variable contract but owns
virtual time — it advances **only when every registered thread is
parked in a clock wait** (quiescence stepping), deadline by deadline,
so the same fleet code runs deterministically in CI (two runs produce
identical transition logs; no ``time.sleep`` assertions anywhere) and
for real under ``sim.realtime_chaos``. Determinism under the fake clock
additionally relies on the monitor being tick-batched: evidence is
applied only at monitor deadlines, strictly ordered by arrival time, so
the controller's transition log is a pure function of virtual time.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.dispatch import (DispatchResult, NoQuorumError,
                                        corrupt_stream, honest_majority,
                                        honest_tokens, majority_vote)
from repro_torch.serve.fleet import (FleetConfig, FleetController,
                                     jitter_stream, next_frontend_instance)

PENDING, REPLIED, FAILED = 0, 1, 2
_BYZ_SALT = 0x5a1c                 # rng key lane for Byzantine corruption
_TIE_EPS = 1e-6                    # intake settling delay: same-instant
                                   # enqueues all land before the worker
                                   # arbitrates by (t_enq, rid)


class ReplicaKilled(RuntimeError):
    """A worker observed its kill flag mid-request (superstep boundary)."""


# ---------------------------------------------------------------------------
# the clock seam
# ---------------------------------------------------------------------------
class Clock:
    """Time + blocking for the realtime fleet. One shared condition
    variable guards *all* fleet state: mutators hold the clock
    (``with clock:``) and call :meth:`notify_all`; waiters hold it and
    call :meth:`wait_for`. The contract both implementations honour:

    - ``monotonic()``     current time (seconds, starts near 0)
    - ``wait_for(p, t)``  block until ``p()`` or ``t`` elapsed
                          (caller holds the clock; returns ``p()``)
    - ``sleep(dt)``       block for ``dt`` (caller does NOT hold it)
    - ``run_until(p, T)`` drive the world until ``p()`` or time T
                          (the harness/main thread's wait primitive)
    - ``thread_starting/started/finished`` worker registration, no-ops
                          in real time, quiescence accounting in fake
    """

    def __init__(self):
        self._cv = threading.Condition()

    def __enter__(self):
        self._cv.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cv.__exit__(*exc)

    def notify_all(self) -> None:
        self._cv.notify_all()

    def thread_starting(self) -> None:   # before Thread.start()
        pass

    def thread_started(self) -> None:    # first statement in the thread
        pass

    def thread_finished(self) -> None:   # last statement in the thread
        pass


class RealClock(Clock):
    """Production clock: ``time.monotonic`` re-zeroed at construction,
    waits are real condition-variable waits."""

    def __init__(self):
        super().__init__()
        self._t0 = time.monotonic()

    def monotonic(self) -> float:
        return time.monotonic() - self._t0

    def sleep(self, dt: float) -> None:
        time.sleep(max(float(dt), 0.0))

    def wait_for(self, pred: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        return self._cv.wait_for(pred, timeout)

    def run_until(self, pred: Callable[[], bool], t_max: float) -> bool:
        with self._cv:
            return self._cv.wait_for(
                pred, timeout=max(t_max - self.monotonic(), 0.0))


class FakeClock(Clock):
    """Deterministic step-controlled clock for threaded tests.

    Virtual time advances only inside :meth:`run_until` / :meth:`advance`
    (called by the test's main thread), and only once every registered
    thread is **parked** in ``wait_for``/``sleep`` — so between steps the
    world is quiescent and each step jumps to the earliest parked
    deadline. Threads register via ``thread_starting`` (before spawn,
    so a freshly spawned worker can never be missed) and
    ``thread_started``/``thread_finished``. A thread that fails to park
    within ``stall_timeout`` *real* seconds trips a RuntimeError instead
    of hanging CI.

    The stepper waits on a condition of its own over the same lock, and a
    thread that parks wakes only the stepper. (The reference wakes every
    parked thread there; each re-parks and wakes the others in turn, a
    storm that starves replicas doing real work, such as engine decodes,
    while virtual time stands still. Which thread runs when is not
    observable either way, so runs stay the reference's, bit for bit.)
    """

    def __init__(self, start: float = 0.0, stall_timeout: float = 60.0):
        super().__init__()
        lock = threading.RLock()
        self._cv = threading.Condition(lock)
        self._step_cv = threading.Condition(lock)
        self._now = float(start)
        self._spawning = 0
        self._live: set = set()
        # ident -> (deadline, pred): the stepper evaluates the pred
        # itself (it holds the lock; preds are pure reads), so it can
        # tell "parked and idle" from "wakeup pending" — notify alone
        # cannot, because a notified thread still needs the lock to
        # unregister itself
        self._parked: Dict[int, tuple] = {}
        self.stall_timeout = float(stall_timeout)

    def notify_all(self) -> None:
        self._cv.notify_all()
        self._step_cv.notify_all()

    # -- time ----------------------------------------------------------
    def monotonic(self) -> float:
        with self._cv:
            return self._now

    def sleep(self, dt: float) -> None:
        with self._cv:
            self.wait_for(lambda: False, timeout=max(float(dt), 0.0))

    def wait_for(self, pred: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        """Caller holds the clock. Parks until ``pred()`` or the virtual
        deadline; the stepper treats the registered deadline as the next
        time anything can happen."""
        deadline = (math.inf if timeout is None
                    else self._now + max(float(timeout), 0.0))
        me = threading.get_ident()
        while not pred():
            if self._now >= deadline - 1e-12:
                return pred()
            self._parked[me] = (deadline, pred)
            self._step_cv.notify_all()       # wake the stepper
            ok = self._cv.wait(self.stall_timeout)
            self._parked.pop(me, None)
            if not ok:
                raise RuntimeError(
                    "FakeClock: no step within "
                    f"{self.stall_timeout:.0f}s real time — stepper gone?")
        return True

    # -- thread registration ------------------------------------------
    def thread_starting(self) -> None:
        with self._cv:
            self._spawning += 1

    def thread_started(self) -> None:
        with self._cv:
            self._spawning -= 1
            self._live.add(threading.get_ident())
            self.notify_all()

    def thread_finished(self) -> None:
        with self._cv:
            self._live.discard(threading.get_ident())
            self._parked.pop(threading.get_ident(), None)
            self.notify_all()

    # -- stepping (main/test thread only) ------------------------------
    def _quiesced(self) -> bool:
        """True iff the world cannot move without time moving: every
        live thread is parked AND no parked thread has a wakeup pending
        (expired deadline or now-true pred)."""
        if self._spawning or any(i not in self._parked
                                 for i in self._live):
            return False
        return all(d > self._now + 1e-12 and not p()
                   for d, p in self._parked.values())

    def _quiesce(self) -> None:
        """Wait until :meth:`_quiesced`. A parked thread whose wakeup
        came due without a notify (its pred turned true, or its deadline
        passed) is woken here, once per park: in the reference the next
        thread to park would wake it."""
        end = time.monotonic() + self.stall_timeout
        woken: List[tuple] = []          # park entries already notified
        while not self._quiesced():
            due = [e for e in self._parked.values()
                   if (e[0] <= self._now + 1e-12 or e[1]())
                   and not any(e is w for w in woken)]
            if due:
                woken += due
                self._cv.notify_all()
            left = end - time.monotonic()
            if left <= 0:
                busy = [i for i in self._live if i not in self._parked]
                raise RuntimeError(
                    f"FakeClock stalled: {len(busy)} busy / "
                    f"{len(self._live)} live thread(s) never quiesced "
                    f"within {self.stall_timeout:.0f}s real time")
            self._step_cv.wait(left)

    def run_until(self, pred: Callable[[], bool], t_max: float) -> bool:
        """Step deadline-by-deadline until ``pred()`` (evaluated only at
        quiescence) or virtual ``t_max``."""
        with self._cv:
            while True:
                self._quiesce()
                if pred():
                    return True
                if self._now >= t_max - 1e-12:
                    return bool(pred())
                dls = [d for d, _ in self._parked.values()
                       if d < math.inf]
                nxt = min(dls) if dls else t_max
                self._now = min(max(nxt, self._now), float(t_max))
                self._cv.notify_all()

    def advance(self, dt: float) -> float:
        """Step through every deadline in the next ``dt`` virtual
        seconds; returns the new now."""
        self.run_until(lambda: False, self.monotonic() + float(dt))
        return self.monotonic()


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------
class StubReplica:
    """The ``honest_tokens`` stand-in replica on the clock: one request
    costs ``work_time`` seconds (slightly replica-skewed so EWMA ranking
    is exercised), abortable at the work boundary — the fast fuel for
    fake-clock tests."""

    def __init__(self, j: int, clock: Clock, work_time: float = 0.3,
                 length: int = 12):
        self.j = int(j)
        self.clock = clock
        self.work_time = float(work_time) * (1.0 + 0.01 * j)
        self.length = int(length)

    def process(self, request: np.ndarray,
                should_abort: Callable[[], bool]) -> np.ndarray:
        with self.clock:
            self.clock.wait_for(should_abort, timeout=self.work_time)
        if should_abort():
            raise ReplicaKilled()
        return honest_tokens(request, self.length)

    def crash(self) -> List[int]:
        return []

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {}

    def restart(self, image) -> None:
        pass


class EngineReplica:
    """A real ``ServeEngine`` behind the Replica contract. The kill flag
    is checked at every superstep boundary — the only place a real
    engine can be interrupted — so a wall-clock kill lands mid-decode,
    and ``crash()``/``restart()`` are the §16 engine primitives."""

    def __init__(self, engine, max_new_tokens: int):
        self.eng = engine
        self.max_new_tokens = int(max_new_tokens)

    def process(self, request: np.ndarray,
                should_abort: Callable[[], bool]) -> np.ndarray:
        rid = self.eng.submit(np.asarray(request, np.int32),
                              self.max_new_tokens)
        while not self.eng.sched.idle:
            if should_abort():
                raise ReplicaKilled()
            self.eng.step()
        st = self.eng.sched.finished.pop(rid)
        return np.asarray(st.generated, np.int32)

    def crash(self) -> List[int]:
        return self.eng.crash()

    def snapshot(self) -> Dict[str, np.ndarray]:
        return self.eng.snapshot()

    def restart(self, image) -> None:
        self.eng.restart(image or None)


# ---------------------------------------------------------------------------
# flight bookkeeping
# ---------------------------------------------------------------------------
class _Copy:
    __slots__ = ("j", "t_sent", "t_done", "status", "toks", "counted")

    def __init__(self, j: int, t_sent: float):
        self.j = j
        self.t_sent = t_sent
        self.t_done = math.inf
        self.status = PENDING
        self.toks: Optional[np.ndarray] = None
        self.counted = False


class _Flight:
    __slots__ = ("rid", "request", "copies", "t0")

    def __init__(self, rid: int, request: np.ndarray, t0: float):
        self.rid = rid
        self.request = request
        self.copies: Dict[int, _Copy] = {}
        self.t0 = t0

    def counted(self) -> List[_Copy]:
        return [c for c in self.copies.values()
                if c.status == REPLIED and c.counted]

    def unresolved(self) -> bool:
        return any(c.status == PENDING for c in self.copies.values())


class Ticket:
    """Handle for an async :meth:`RealtimeFleet.submit`: poll ``done``
    under the clock (e.g. ``clock.run_until(lambda: t.done, T)``), then
    read ``result`` or ``error``."""

    __slots__ = ("rid", "done", "result", "error")

    def __init__(self, rid: int):
        self.rid = rid
        self.done = False
        self.result: Optional[DispatchResult] = None
        self.error: Optional[BaseException] = None


# ---------------------------------------------------------------------------
# the fleet frontend
# ---------------------------------------------------------------------------
class RealtimeFleet:
    """n replicas on worker threads + 1 monitor, §16 policy on a clock.

    ``replicas`` honour the Replica contract (``process(request,
    should_abort)``, ``crash``, ``snapshot``, ``restart``). All timing
    knobs come from ``cfg`` (the same :class:`FleetConfig` the virtual
    harness uses); extra realtime knobs: ``queue_depth`` (bounded inbound
    queue — overflow fails the copy so the dispatcher hedges),
    ``rejoin_delay`` (supervisor restart lag after a kill),
    ``monitor_period`` (evidence-batch cadence; default a quarter
    heartbeat). Fault injection — :meth:`kill`, :meth:`pause`,
    :meth:`slow` — acts on the *threads*, not the policy.
    """

    def __init__(self, replicas: Sequence, cfg: FleetConfig,
                 clock: Optional[Clock] = None, queue_depth: int = 8,
                 rejoin_delay: Optional[float] = None,
                 monitor_period: Optional[float] = None,
                 jitter_instance: Optional[int] = None):
        if len(replicas) != cfg.n_replicas:
            raise ValueError(f"{len(replicas)} replicas for "
                             f"n_replicas={cfg.n_replicas}")
        self.replicas = list(replicas)
        self.cfg = cfg
        self.clock = clock or RealClock()
        self.ctrl = FleetController(cfg)
        self.queue_depth = int(queue_depth)
        self.rejoin_delay = (cfg.heartbeat_period * 4.0
                             if rejoin_delay is None else float(rejoin_delay))
        self.monitor_period = (cfg.heartbeat_period / 4.0
                               if monitor_period is None
                               else float(monitor_period))
        self._instance = (next_frontend_instance()
                          if jitter_instance is None else int(jitter_instance))
        n = cfg.n_replicas
        self._inq: List[List[tuple]] = [[] for _ in range(n)]
        self._threads: List[Optional[threading.Thread]] = [None] * n
        self._alive = [False] * n
        self._kill = [False] * n
        self._pause_until = [0.0] * n
        self._slow_until = [0.0] * n
        self._slow_extra = [0.0] * n
        self._restart_at: Dict[int, float] = {}
        self.restart_t: Dict[int, float] = {}
        self._inbox: List[tuple] = []
        self._flights: Dict[int, _Flight] = {}
        self._rid = 0
        self._active_dispatches = 0
        self._stop = False
        self._draining = False
        self._monitor: Optional[threading.Thread] = None
        self._image = self.replicas[0].snapshot()
        # telemetry
        self.dispatches = 0
        self.hedges = 0
        self.retries = 0
        self.outages = 0
        self.shed = 0
        self.restarts = 0
        self.worker_errors = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "RealtimeFleet":
        ck = self.clock
        with ck:
            now = ck.monotonic()
            for j in range(self.cfg.n_replicas):
                # expectation for the first beat: a worker dead at birth
                # is detectable, exactly like the virtual harness
                self.ctrl.note_sent(j, now + self._hb_offset(j))
                self._spawn_worker(j)
            ck.thread_starting()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True)
            self._monitor.start()
        return self

    def _hb_offset(self, j: int) -> float:
        n = self.cfg.n_replicas
        return self.cfg.heartbeat_period * (j + 1) / (n + 1)

    def _spawn_worker(self, j: int) -> None:
        """Caller holds the clock."""
        self._alive[j] = True
        self._kill[j] = False
        self.clock.thread_starting()
        t = threading.Thread(target=self._worker_loop, args=(j,),
                             name=f"fleet-worker-{j}", daemon=True)
        self._threads[j] = t
        t.start()

    def shutdown(self, drain: bool = True, t_max: float = 120.0) -> bool:
        """Graceful stop: optionally drain in-flight dispatches (bounded
        by ``t_max`` clock seconds), then stop and join every thread.
        Returns True if the drain completed."""
        with self.clock:
            self._draining = True
            self.clock.notify_all()
        drained = True
        if drain:
            drained = self.clock.run_until(
                lambda: self._active_dispatches == 0, t_max)
        with self.clock:
            self._stop = True
            self.clock.notify_all()
        for t in self._threads + [self._monitor]:
            if t is not None:
                t.join(timeout=30.0)
        return drained

    # -- fault injection (the chaos surface) ---------------------------
    def kill(self, j: int) -> None:
        """Kill worker j's thread at its next abort point; the engine
        crashes (in-flight work lost) and the supervisor restarts it
        from the pristine snapshot after ``rejoin_delay``."""
        with self.clock:
            self._kill[j] = True
            self.clock.notify_all()

    def pause(self, j: int, duration: float) -> None:
        """Stall worker j (no beats, no work) for ``duration``; the
        process survives, so recovery needs no restart."""
        with self.clock:
            self._pause_until[j] = max(self._pause_until[j],
                                       self.clock.monotonic()
                                       + float(duration))
            self.clock.notify_all()

    def slow(self, j: int, extra: float, duration: float) -> None:
        """Add ``extra`` seconds to every request j serves for the next
        ``duration`` — the straggler that trips deadline hedging."""
        with self.clock:
            self._slow_until[j] = self.clock.monotonic() + float(duration)
            self._slow_extra[j] = float(extra)
            self.clock.notify_all()

    def n_threads_alive(self) -> int:
        return sum(1 for t in self._threads if t is not None and t.is_alive())

    def settled(self) -> bool:
        """Every replica countable again and no supervisor restart
        pending — the chaos harness's 'fleet is whole' predicate.
        Read-only; call while holding the clock (run_until does)."""
        return (not self._restart_at
                and all(self.ctrl.countable(j)
                        for j in range(self.cfg.n_replicas)))

    # -- client API ----------------------------------------------------
    def submit(self, request: np.ndarray, priority: int = 0) -> Ticket:
        """Async dispatch on a fresh (clock-registered) client thread."""
        with self.clock:
            if self._draining or self._stop:
                raise RuntimeError("fleet is draining — submit refused")
            tk = Ticket(self._rid)
            self.clock.thread_starting()

        def client():
            self.clock.thread_started()
            try:
                res = self.dispatch(request, priority)
                with self.clock:
                    tk.result = res
                    tk.done = True
                    self.clock.notify_all()
            except BaseException as e:          # noqa: BLE001 — surfaced
                with self.clock:
                    tk.error = e
                    tk.done = True
                    self.clock.notify_all()
            finally:
                self.clock.thread_finished()

        threading.Thread(target=client, name=f"fleet-client-{tk.rid}",
                         daemon=True).start()
        return tk

    def dispatch(self, request: np.ndarray,
                 priority: int = 0) -> DispatchResult:
        """Blocking hedged dispatch (§16 policy on the clock)."""
        c = self.cfg
        request = np.asarray(request, np.int32)
        want = c.n_replicas - c.r
        ck = self.clock
        with ck:
            rid = self._rid
            self._rid += 1
            self._active_dispatches += 1
            if priority < c.shed_below and self.ctrl.degraded():
                self.shed += 1
                ck.wait_for(lambda: self._stop or not self.ctrl.degraded())
            self.dispatches += 1
        jrng = jitter_stream(c.seed, self._instance, rid)
        deliverable = 0
        try:
            for attempt in range(c.max_retries + 1):
                res, deliverable = self._attempt(rid, request, want)
                if res is not None:
                    return res
                with ck:
                    if self._stop:
                        break
                if attempt < c.max_retries:
                    with ck:
                        self.retries += 1
                        pause = min(c.backoff_base * (2.0 ** attempt),
                                    c.backoff_cap)
                        pause *= 1.0 + c.backoff_jitter * float(jrng.random())
                        ck.wait_for(lambda: self._stop, timeout=pause)
            with ck:
                self.outages += 1
            raise NoQuorumError(rid, deliverable, want)
        finally:
            with ck:
                self._active_dispatches -= 1
                ck.notify_all()

    # -- dispatch internals --------------------------------------------
    def _timeout(self) -> float:
        return self.cfg.hedge_factor * max(self.ctrl.expected_latency(),
                                           1e-3)

    def _send(self, fl: _Flight, j: int, now: float) -> None:
        """Caller holds the clock."""
        cp = _Copy(j, now)
        fl.copies[j] = cp
        self.ctrl.note_sent(j, now)
        if not self._alive[j] or len(self._inq[j]) >= self.queue_depth:
            cp.status = FAILED      # refused at the door: hedge elsewhere
            return
        self._inq[j].append((now, fl.rid, fl, cp))
        self.clock.notify_all()

    def _attempt(self, rid: int, request: np.ndarray, want: int):
        """One fan-out + hedge round; mirrors HedgedDispatcher._attempt
        with condition-variable waits instead of event-heap pops."""
        c, ctrl, ck = self.cfg, self.ctrl, self.clock
        with ck:
            t0 = ck.monotonic()
            fl = _Flight(rid, request, t0)
            self._flights[rid] = fl
            ranked = ctrl.ranked()
            for j in [j for j in ranked if ctrl.countable(j)][:want]:
                self._send(fl, j, t0)
            # probe every live non-countable replica: probation credit
            # and recovery discovery piggyback on the dispatch
            for j in ranked:
                if (not ctrl.countable(j) and j not in fl.copies
                        and self._alive[j]):
                    self._send(fl, j, t0)
            deadline = t0 + self._timeout()
            try:
                while True:
                    def settled():
                        return (self._stop or len(fl.counted()) >= want
                                or not fl.unresolved())
                    ck.wait_for(settled,
                                timeout=deadline - ck.monotonic())
                    now = ck.monotonic()
                    counted = fl.counted()
                    if self._stop or len(counted) >= want:
                        break
                    if fl.unresolved() and now < deadline - 1e-9:
                        continue            # woken early; keep waiting
                    # stalled: hedge to the best untried countable
                    untried = [j for j in ctrl.ranked()
                               if ctrl.countable(j) and j not in fl.copies]
                    if untried:
                        need = max(want - len(counted), 1)
                        for j in untried[:need]:
                            self._send(fl, j, now)
                            self.hedges += 1
                        deadline = now + self._timeout()
                    elif fl.unresolved():
                        deadline = now + self._timeout()   # stragglers
                    else:
                        break               # nobody left to ask
            finally:
                del self._flights[rid]
            got = fl.counted()
            if len(got) < c.floor:
                return None, len(got)
            used = sorted(got, key=lambda cp: (cp.t_done, cp.j))[:want]
            streams = np.stack([cp.toks for cp in used])
            tokens = majority_vote(streams).astype(np.int32)
            used_ids = tuple(sorted(cp.j for cp in used))
            n_byz_used = len(set(used_ids) & set(c.byz_ids))
            return DispatchResult(
                tokens=tokens,
                round_latency=float(max(cp.t_done for cp in used) - t0),
                used=used_ids, n_received=len(used),
                quorum_honest=honest_majority(len(used), n_byz_used)
            ), len(got)

    # -- worker thread -------------------------------------------------
    def _worker_loop(self, j: int) -> None:
        ck = self.clock
        ck.thread_started()
        period = self.cfg.heartbeat_period
        try:
            with ck:
                next_hb = ck.monotonic() + self._hb_offset(j)
            while True:
                item = None
                with ck:
                    now = ck.monotonic()
                    if self._stop:
                        return
                    if self._kill[j]:
                        self._die(j)
                        return
                    pu = self._pause_until[j]
                    if now < pu:
                        ck.wait_for(lambda: self._stop or self._kill[j],
                                    timeout=pu - now)
                        continue
                    if now >= next_hb - 1e-9:
                        while next_hb <= now + 1e-9:
                            next_hb += period
                        self._inbox.append((now, j, 0, -1, "hb", next_hb))
                        ck.notify_all()
                        continue
                    # Pop only items enqueued strictly before now (the
                    # worker-side twin of the monitor's strict t < now
                    # evidence drain): two dispatchers hedging at the
                    # same virtual instant both land in the queue before
                    # the worker arbitrates by (t_enq, rid), instead of
                    # racing the worker's pop in OS scheduling order.
                    item = None
                    if self._inq[j]:
                        cand = min(self._inq[j])   # (t_enq, rid) order
                        if cand[0] < now - 1e-12:
                            item = cand
                            self._inq[j].remove(item)
                    if item is None:
                        if self._inq[j]:
                            # settle wait: park until just past the
                            # earliest enqueue instant so every
                            # same-instant send (and chaos action) has
                            # landed before the pop arbitrates.
                            t_wake = min(next_hb,
                                         min(self._inq[j])[0] + _TIE_EPS)
                            ck.wait_for(
                                lambda: (self._stop or self._kill[j]
                                         or (self._inq[j]
                                             and min(self._inq[j])[0]
                                             < ck.monotonic() - 1e-12)
                                         or self._pause_until[j]
                                         > ck.monotonic()),
                                timeout=t_wake - now)
                        else:
                            # idle wait: wake promptly on any enqueue,
                            # then fall into the settle wait above.
                            ck.wait_for(
                                lambda: (self._stop or self._kill[j]
                                         or self._inq[j]
                                         or self._pause_until[j]
                                         > ck.monotonic()),
                                timeout=next_hb - now)
                        continue
                try:
                    self._process(j, item)
                except Exception:
                    # replica code blew up mid-request: treat it as a
                    # crash (fail the copy, free the queue, schedule a
                    # supervisor restart) instead of dying silently with
                    # the copy stuck PENDING forever; ``worker_errors``
                    # is the telemetry trail for the swallowed traceback
                    with ck:
                        self.worker_errors += 1
                        cp = item[3]
                        if cp.status == PENDING:
                            cp.status = FAILED
                        self._die(j)
                    return
        finally:
            ck.thread_finished()

    def _process(self, j: int, item: tuple) -> None:
        ck = self.clock
        _, rid, fl, cp = item

        def should_abort() -> bool:
            return self._kill[j] or self._stop

        with ck:
            now = ck.monotonic()
            extra = self._slow_extra[j] if now < self._slow_until[j] else 0.0
            if extra > 0.0:
                ck.wait_for(should_abort, timeout=extra)
        try:
            if should_abort():
                raise ReplicaKilled()
            toks = self.replicas[j].process(fl.request, should_abort)
            c = self.cfg
            if j in c.byz_ids and c.attack:
                toks = corrupt_stream(
                    np.asarray(toks, np.int64), c.attack,
                    np.random.default_rng([c.seed, _BYZ_SALT, rid, j]))
            with ck:
                t = ck.monotonic()
                self._inbox.append((t, j, 1, rid, "reply",
                                    (cp, np.asarray(toks, np.int64))))
                ck.notify_all()
        except ReplicaKilled:
            with ck:
                if cp.status == PENDING:
                    cp.status = FAILED
                ck.notify_all()

    def _die(self, j: int) -> None:
        """Caller holds the clock; the worker thread is exiting."""
        self._alive[j] = False
        self.replicas[j].crash()
        for (_, _, _, cp) in self._inq[j]:
            cp.status = FAILED
        self._inq[j].clear()
        self._restart_at[j] = self.clock.monotonic() + self.rejoin_delay
        self.clock.notify_all()

    # -- monitor thread ------------------------------------------------
    def _monitor_loop(self) -> None:
        ck = self.clock
        ck.thread_started()
        try:
            with ck:
                next_tick = ck.monotonic() + self.monitor_period
                while True:
                    ck.wait_for(lambda: self._stop,
                                timeout=next_tick - ck.monotonic())
                    if self._stop:
                        return
                    now = ck.monotonic()
                    self._drain_evidence(now)
                    for tr in self.ctrl.poll(now):
                        if tr.new == "dead":
                            self._fail_pending(tr.replica)
                    self._do_restarts(now)
                    while next_tick <= now + 1e-9:
                        next_tick += self.monitor_period
                    ck.notify_all()
        finally:
            ck.thread_finished()

    def _drain_evidence(self, now: float) -> None:
        """Apply every evidence record with t strictly before now, in
        (t, replica, kind, rid) order — the single writer to the
        controller, so the transition log is deterministic under the
        fake clock no matter how the OS scheduled the posts."""
        take = [e for e in self._inbox if e[0] < now - 1e-12]
        if not take:
            return
        self._inbox = [e for e in self._inbox if e[0] >= now - 1e-12]
        ctrl = self.ctrl
        for t, j, _, _, kind, payload in sorted(take, key=lambda e: e[:4]):
            if kind == "hb":
                ctrl.observe(j, t)
                ctrl.note_sent(j, payload)     # expect the NEXT beat
            else:                              # reply
                cp, toks = payload
                pre = ctrl.countable(j)
                ctrl.observe(j, t)
                ctrl.note_latency(j, t - cp.t_sent)
                if cp.status == PENDING:
                    cp.status = REPLIED
                    cp.t_done = t
                    cp.toks = toks
                    cp.counted = pre

    def _fail_pending(self, j: int) -> None:
        """A replica was declared dead: every pending copy aimed at it
        is failed now (watchdog kick) so dispatchers hedge immediately
        instead of waiting out their deadlines."""
        for fl in self._flights.values():
            cp = fl.copies.get(j)
            if cp is not None and cp.status == PENDING:
                cp.status = FAILED
        for (_, _, _, cp) in self._inq[j]:
            cp.status = FAILED
        self._inq[j].clear()

    def _do_restarts(self, now: float) -> None:
        for j in [j for j, t_r in self._restart_at.items() if now >= t_r]:
            del self._restart_at[j]
            th = self._threads[j]
            if th is not None and th.is_alive():
                continue                       # pragma: no cover - safety
            self.replicas[j].restart(self._image)
            self.restarts += 1
            self.restart_t[j] = now
            self.ctrl.note_sent(j, now + self._hb_offset(j))
            self._spawn_worker(j)
