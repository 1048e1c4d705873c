"""Port parity for the wall-clock fleet: ``repro_torch.serve.realtime``
and ``repro_torch.sim.realtime_chaos`` against ``repro``'s under the
fake clock, where a run is a pure function of virtual time.

Every ``FakeClock`` + ``StubReplica`` case of ``tests/test_realtime.py``
runs on both packages: the reference test's outcome checks hold on the
port, and the transition logs, votes, latencies and telemetry must be
identical to the reference's. All four chaos plans: ``as_dict()``,
``transition_log`` and ``latencies`` identical to ``repro``'s and across
two runs of the port. Then ``EngineReplica`` over the port's
``ServeEngine`` (reduced qwen2-0.5b, f32, on the CPU) under a kill and a
checkpoint rejoin, beside the reference's over JAX's engine on the same
weights."""
import dataclasses
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.models.model import init_model as jax_init
from repro.serve import PagedCacheConfig as JaxCacheConfig
from repro.serve import ServeEngine as JaxEngine
from repro.serve import dispatch as jdispatch
from repro.serve import engine as jengine
from repro.serve import fleet as jfleet
from repro.serve import realtime as jrt
from repro.sim import realtime_chaos as jchaos
from repro_torch.configs.registry import get_config
from repro_torch.models.model import params_from_jax
from repro_torch.serve import PagedCacheConfig, ServeEngine
from repro_torch.serve import dispatch as tdispatch
from repro_torch.serve import engine as tengine
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import realtime as trt
from repro_torch.sim import realtime_chaos as tchaos

REF = SimpleNamespace(rt=jrt, fleet=jfleet, dispatch=jdispatch,
                      chaos=jchaos, engine=jengine)
PORT = SimpleNamespace(rt=trt, fleet=tfleet, dispatch=tdispatch,
                       chaos=tchaos, engine=tengine)
HB = 2.0
N = 4


def _cfg(pkg, n=N, r=1, **kw):
    kw.setdefault("heartbeat_period", HB)
    return pkg.fleet.FleetConfig(n_replicas=n, r=r, seed=0, **kw)


def _fleet(pkg, cfg, clock, work_time=0.3, replica=None, **kw):
    kw.setdefault("jitter_instance", 0)
    replica = replica or pkg.rt.StubReplica
    reps = [replica(j, clock, work_time=work_time)
            for j in range(cfg.n_replicas)]
    return pkg.rt.RealtimeFleet(reps, cfg, clock=clock, **kw)


def _req(i, length=6):
    return np.random.default_rng([9, i]).integers(1, 255, length)


def _await(clock, tickets, t_max=120.0):
    ok = clock.run_until(lambda: all(t.done for t in tickets), t_max)
    assert ok, "tickets did not complete within t_max virtual seconds"


def _record(fleet, tickets=()):
    """Everything a run shows: the transition log, each ticket's vote or
    error, the rounds (latency, replicas used, replies, honest quorum)
    and the fleet's telemetry. Requests submitted at one virtual instant
    race for their dispatch order (and their tickets' rids), in the
    reference as here, so rounds compare as a sorted list."""
    votes, rounds = [], []
    for tk in tickets:
        if tk.result is not None:
            r = tk.result
            votes.append(r.tokens.tolist())
            rounds.append((r.round_latency, r.used, r.n_received,
                           r.quorum_honest))
        else:
            votes.append((type(tk.error).__name__,
                          getattr(tk.error, "deliverable", None)))
    return ([(tr.t, tr.replica, tr.old, tr.new)
             for tr in fleet.ctrl.transitions], votes, sorted(rounds),
            (fleet.dispatches, fleet.hedges, fleet.retries, fleet.outages,
             fleet.shed, fleet.restarts, fleet.worker_errors,
             fleet.ctrl.deaths, fleet.ctrl.rejoins),
            sorted(fleet.restart_t.items()))


def _honest(pkg, tk, i):
    assert tk.error is None
    np.testing.assert_array_equal(tk.result.tokens,
                                  pkg.dispatch.honest_tokens(_req(i)))


# ---------------------------------------------------------------------------
# the cases of tests/test_realtime.py, as functions of a package


def case_exact_tokens(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    tks = [fleet.submit(_req(i)) for i in range(6)]
    _await(ck, tks)
    for i, tk in enumerate(tks):
        _honest(pkg, tk, i)
        assert tk.result.quorum_honest
    assert fleet.hedges == 0 and fleet.outages == 0
    assert fleet.shutdown()
    return _record(fleet, tks)


def case_idle_heartbeats(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    ck.advance(20 * HB)
    with ck:
        assert all(fleet.ctrl.countable(j) for j in range(N))
        assert fleet.ctrl.transitions == []
        ewma = list(fleet.ctrl.ewma)
    assert fleet.shutdown()
    return _record(fleet), ewma, ck.monotonic()


def case_kill_rejoin(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    ck.advance(3 * HB)
    fleet.kill(1)
    ck.run_until(lambda: fleet.n_threads_alive() >= 5 and fleet.settled(),
                 40 * HB)
    kinds = [(tr.replica, tr.old, tr.new) for tr in fleet.ctrl.transitions]
    assert (1, "suspect", "dead") in kinds
    assert (1, "recovering", "healthy") in kinds
    assert fleet.restarts == 1
    tk = fleet.submit(_req(0))
    _await(ck, [tk])
    _honest(pkg, tk, 0)
    assert fleet.shutdown()
    return _record(fleet, [tk])


def case_pause(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    ck.advance(2 * HB)
    fleet.pause(2, 4 * HB)
    tks = []
    for i in range(14):
        tks.append(fleet.submit(_req(i)))
        ck.advance(1.0)
    _await(ck, tks, t_max=300.0)
    assert ck.run_until(lambda: fleet.settled(), 300.0)
    kinds = [(tr.replica, tr.new) for tr in fleet.ctrl.transitions]
    assert (2, "suspect") in kinds or (2, "dead") in kinds
    assert fleet.restarts == 0 and fleet.ctrl.countable(2)
    for i, tk in enumerate(tks):
        _honest(pkg, tk, i)
    assert fleet.shutdown()
    return _record(fleet, tks)


def case_straggler(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    tks = [fleet.submit(_req(i)) for i in range(3)]
    _await(ck, tks)
    fleet.slow(0, extra=50.0, duration=100.0)
    tk = fleet.submit(_req(7))
    _await(ck, [tk], t_max=200.0)
    assert fleet.hedges >= 1
    _honest(pkg, tk, 7)
    assert fleet.shutdown()
    return _record(fleet, tks + [tk])


def case_total_outage(pkg):
    ck = pkg.rt.FakeClock()
    cfg = _cfg(pkg, max_retries=1, backoff_base=0.5, backoff_cap=1.0)
    fleet = _fleet(pkg, cfg, ck, rejoin_delay=500.0).start()
    ck.advance(2 * HB)
    for j in range(N):
        fleet.kill(j)
    ck.run_until(lambda: fleet.n_threads_alive() <= 1, 10 * HB)
    tk = fleet.submit(_req(0))
    ck.run_until(lambda: tk.done, 400.0)
    assert isinstance(tk.error, pkg.dispatch.NoQuorumError)
    assert tk.error.deliverable < cfg.n_replicas - cfg.r
    assert fleet.outages == 1
    assert fleet.shutdown(drain=False)
    return _record(fleet, [tk])


def case_shed(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg, shed_below=1), ck).start()
    ck.advance(2 * HB)
    fleet.kill(2)
    fleet.kill(3)
    ck.run_until(lambda: fleet.ctrl.n_countable() < 3, 20 * HB)
    with ck:
        assert fleet.ctrl.degraded()
    tk = fleet.submit(_req(0), priority=0)
    ck.run_until(lambda: fleet.shed == 1, 5.0)
    with ck:
        assert fleet.shed == 1 and not tk.done
    ck.run_until(lambda: tk.done, 60 * HB)
    _honest(pkg, tk, 0)
    assert fleet.shutdown()
    return _record(fleet, [tk])


def case_byzantine(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg, byz_ids=(2,), attack="sign_flip"),
                   ck).start()
    tks = [fleet.submit(_req(i)) for i in range(4)]
    _await(ck, tks)
    for i, tk in enumerate(tks):
        _honest(pkg, tk, i)
    assert fleet.shutdown()
    return _record(fleet, tks)


def case_worker_exception(pkg):
    class PoisonOnceReplica(pkg.rt.StubReplica):
        def __init__(self, j, clock, **kw):
            super().__init__(j, clock, **kw)
            self.poisoned = j == 1

        def process(self, request, should_abort):
            if self.poisoned:
                self.poisoned = False
                raise ValueError("poison pill")
            return super().process(request, should_abort)

    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck, replica=PoisonOnceReplica).start()
    tk = fleet.submit(_req(0))
    _await(ck, [tk])
    _honest(pkg, tk, 0)
    ck.run_until(lambda: fleet.restarts == 1 and fleet.settled(), 40 * HB)
    assert fleet.worker_errors == 1 and fleet.restarts == 1
    assert fleet.shutdown()
    return _record(fleet, [tk])


def case_snapshot_guard(pkg):
    class BusySnapshotReplica(pkg.rt.StubReplica):
        busy = 0

        def snapshot(self):
            if self.busy:
                raise pkg.engine.SnapshotInFlightError(self.busy, 0)
            return super().snapshot()

    rep = BusySnapshotReplica(0, pkg.rt.FakeClock())
    rep.busy = 2
    with pytest.raises(pkg.engine.SnapshotInFlightError) as ei:
        rep.snapshot()
    assert ei.value.n_active == 2 and isinstance(ei.value, RuntimeError)
    rep.busy = 0
    assert rep.snapshot() == {}
    return str(ei.value)


def case_drain(pkg):
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    tk = fleet.submit(_req(0))
    assert fleet.shutdown(drain=True)
    assert tk.done and tk.error is None
    with pytest.raises(RuntimeError, match="draining"):
        fleet.submit(_req(1))
    assert fleet.n_threads_alive() == 0
    return _record(fleet, [tk])


def case_scripted(pkg):
    """One kill and a stream of requests, scripted on virtual time (the
    reference's bit-determinism fixture)."""
    ck = pkg.rt.FakeClock()
    fleet = _fleet(pkg, _cfg(pkg), ck).start()
    tickets = []
    for i in range(8):
        ck.run_until(lambda: False, (i + 0.26) * 1.0)
        tickets.append(fleet.submit(_req(i)))
        if i == 3:
            fleet.kill(0)
    _await(ck, tickets, t_max=200.0)
    ck.run_until(lambda: fleet.settled(), 200.0)
    fleet.shutdown()
    rec = _record(fleet, tickets)
    assert any(new == "dead" for _, _, _, new in rec[0])
    assert fleet.restarts == 1 and len(rec[2]) == 8
    # arrivals off the monitor grid: the rids, hence the latencies in
    # submission order, are pinned too
    return rec, [tk.result.round_latency for tk in tickets]


def case_silent_wakeup(pkg):
    """A parked thread whose pred turns true with no notify: the next
    thread to park wakes it, and time moves on."""
    ck = pkg.rt.FakeClock(stall_timeout=5.0)
    flag, log = [False], []

    def waiter():
        ck.thread_started()
        with ck:
            ck.wait_for(lambda: flag[0])
            log.append(("waiter", ck.monotonic()))
        ck.thread_finished()

    def setter():
        ck.thread_started()
        with ck:
            ck.sleep(1.0)
        # busy off the clock while the step's notify wakes the waiter
        # and it parks again, unnotified
        time.sleep(0.2)
        with ck:
            flag[0] = True                  # no notify
            log.append(("setter", ck.monotonic()))
            ck.sleep(1.0)
        ck.thread_finished()

    threads = [threading.Thread(target=f) for f in (waiter, setter)]
    for t in threads:
        ck.thread_starting()
        t.start()
    assert ck.run_until(lambda: len(log) == 2 and ck.monotonic() >= 2.0,
                        10.0)
    for t in threads:
        t.join(timeout=10.0)
    return log, ck.monotonic()


CASES = {f.__name__[5:]: f for f in (
    case_exact_tokens, case_idle_heartbeats, case_kill_rejoin, case_pause,
    case_straggler, case_total_outage, case_shed, case_byzantine,
    case_worker_exception, case_snapshot_guard, case_drain, case_scripted,
    case_silent_wakeup)}


@pytest.mark.parametrize("case", list(CASES))
def test_fake_clock_case_equals_reference(case):
    ours = CASES[case](PORT)
    assert ours == CASES[case](REF)
    if case == "scripted":
        assert CASES[case](PORT) == ours         # and run to run


# ---------------------------------------------------------------------------
# the chaos plans


def test_plans_equal_reference():
    assert sorted(tchaos.PLANS) == sorted(jchaos.PLANS)
    for name in tchaos.PLANS:
        for scale in (1.0, 0.025):
            a = tchaos.PLANS[name](N, scale=scale)
            b = jchaos.PLANS[name](N, scale=scale)
            assert (a.name, a.n_requests, a.arrival_period, a.t_max) == \
                (b.name, b.n_requests, b.arrival_period, b.t_max)
            assert [(e.t, e.kind, e.replica, e.duration, e.extra)
                    for e in a.events] == \
                [(e.t, e.kind, e.replica, e.duration, e.extra)
                 for e in b.events]


def _chaos(pkg, name, **kw):
    rep = pkg.chaos.run_realtime_chaos(pkg.chaos.PLANS[name](N),
                                       _cfg(pkg), **kw)
    return rep.as_dict(), rep.transition_log, rep.latencies


def _same_report(a, b):
    """Identical reports; nan fields (an empty window) compare as equal."""
    da, db = a[0], b[0]
    assert sorted(da) == sorted(db)
    for k in db:
        if isinstance(db[k], float) and np.isnan(db[k]):
            assert np.isnan(da[k]), k
        else:
            assert da[k] == db[k], k
    assert a[1:] == b[1:]


@pytest.mark.parametrize("name", sorted(jchaos.PLANS))
def test_chaos_plan_equals_reference_and_repeats(name):
    ours, again, ref = (_chaos(PORT, name), _chaos(PORT, name),
                        _chaos(REF, name))
    _same_report(ours, ref)
    _same_report(again, ours)
    d = ours[0]
    assert d["lost"] == 0 and d["violations"] == [] and d["drained"]
    assert d["delivered"] == tchaos.PLANS[name](N).n_requests
    assert d["recovered"] >= 0.9
    if name in ("kill_rejoin", "crash_cascade"):
        assert d["deaths"] >= 1 and d["rejoins"] >= 1 and d["restarts"] >= 1
    if name == "straggler":
        assert d["hedges"] >= 1


# ---------------------------------------------------------------------------
# EngineReplica over the port's ServeEngine


@pytest.fixture(scope="module")
def engines():
    """Four replicas of each package's engine on one set of weights."""
    jcfg = jax_config("qwen2-0.5b").reduced()
    jp = jax_init(jax.random.PRNGKey(0), jcfg, max_pos=64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    cfg = get_config("qwen2-0.5b").reduced()
    ccfg = dict(num_slots=2, page_size=8, num_pages=17, max_pages_per_seq=8)
    ours = [ServeEngine(tp, cfg, PagedCacheConfig(**ccfg), superstep_k=4,
                        device="cpu") for _ in range(N)]
    ref = [JaxEngine(jp, jcfg, JaxCacheConfig(**ccfg), superstep_k=4)
           for _ in range(N)]
    return ours, ref


def test_engine_replicas_under_kill_and_rejoin(engines):
    """kill_rejoin cut to 12 requests on engine replicas: nothing lost,
    no violation, the kill detected, restarted from the snapshot image
    and rejoined; every engine drained. Under the fake clock the engines'
    work takes no virtual time, so the run equals the reference's over
    JAX's engines, and the replicas answer with equal streams."""
    import dataclasses
    out = []
    for pkg, engs in zip((PORT, REF), engines):
        reps = [pkg.rt.EngineReplica(e, 8) for e in engs]
        plan = dataclasses.replace(pkg.chaos.PLANS["kill_rejoin"](N),
                                   n_requests=12)
        rep = pkg.chaos.run_realtime_chaos(plan, _cfg(pkg),
                                           clock=pkg.rt.FakeClock(),
                                           replicas=reps)
        assert all(e.sched.idle for e in engs)
        streams = [reps[j].process(_req(i, 8).astype(np.int32),
                                   lambda: False).tolist()
                   for i, j in ((0, 0), (1, 1), (2, 3))]
        out.append((rep.as_dict(), rep.transition_log, rep.latencies,
                    streams, [e.stats.get("restarts", 0) for e in engs]))
    ours, ref = out
    d = ours[0]
    assert d["lost"] == 0 and d["violations"] == [] and d["drained"]
    assert d["deaths"] >= 1 and d["rejoins"] >= 1 and d["restarts"] >= 1
    assert ours[4][1] >= 1                       # replica 1 restarted
    _same_report(ours[:3], ref[:3])
    assert ours[3:] == ref[3:]
