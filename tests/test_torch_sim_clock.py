"""Port parity for the simulator's clock and fault model:
``repro_torch.sim.clock`` and ``repro_torch.sim.faults`` against
``repro.sim.clock`` and ``repro.sim.faults`` on the same inputs. Event
order, due sets, seeded Poisson arrivals, every ``FaultSchedule`` query
over a grid of times, and ``SimTransport``'s latency and delivery-fate
streams over 200 calls (drops, duplicates and reorder jitter included)
must be identical, and the transport's ``state_dict`` must round-trip to
the same continuation."""
import numpy as np
import pytest

from repro.sim import clock as jclock
from repro.sim import faults as jfaults
from repro_torch.sim import clock as tclock
from repro_torch.sim import faults as tfaults


def _events(evs):
    return [(e.time, e.seq, e.tag, e.payload) for e in evs]


def test_event_heap_order_and_ties():
    times = [3.0, 1.0, 2.0, 1.0, 3.0, 0.5, 2.0, 1.0]
    heaps = [jclock.EventHeap(), tclock.EventHeap()]
    for h in heaps:
        for i, t in enumerate(times):
            h.push(t, f"e{i}", i)
        assert len(h) == len(times)
        assert h.peek().time == 0.5
    due = [_events(h.pop_due(1.0)) for h in heaps]
    assert due[1] == due[0] and len(due[1]) == 4
    out = [_events([h.pop() for _ in range(len(h))]) for h in heaps]
    assert out[1] == out[0]
    out = [due[i] + out[i] for i in range(2)]
    # ties broken by insertion order
    assert [p for t, _, _, p in out[1] if t == 1.0] == [1, 3, 7]


def test_virtual_clock_advance_and_pop_due():
    clocks = [jclock.VirtualClock(), tclock.VirtualClock(start=0.0)]
    log = []
    for c in clocks:
        steps = []
        c.schedule_at(2.0, "a")
        c.schedule_in(0.5, "b")
        c.schedule_at(2.0, "c", {"k": 1})
        steps.append(_events(c.advance_to(1.0)))
        steps.append(c.now)
        steps.append(_events(c.advance_to(0.2)))     # never moves back
        steps.append(c.now)
        c.schedule_in(3.0, "d")
        steps.append(_events(c.advance_to(2.0)))
        steps.append(_events([c.next_event()]))
        steps.append(c.now)
        steps.append(c.next_event())
        log.append(steps)
    assert log[1] == log[0]
    assert log[1][1] == log[1][3] == 1.0 and log[1][-1] is None


@pytest.mark.parametrize("seed,rate,count,start", [
    (0, 0.5, 40, None), (7, 3.0, 17, 12.5), (123, 0.01, 5, 0.0)])
def test_poisson_arrivals_match(seed, rate, count, start):
    def payload(i, rng):
        return (i, int(rng.integers(0, 256)))

    out = []
    for mod in (jclock, tclock):
        c = mod.VirtualClock(start=1.25)
        evs = mod.poisson_arrivals(c, rate, count, seed, tag="request",
                                   make_payload=payload, start=start)
        out.append((_events(evs), _events(c.advance_to(1e12))))
    assert out[1] == out[0]
    assert len(out[1][0]) == count


def test_poisson_arrivals_validates_like_reference():
    for mod in (jclock, tclock):
        with pytest.raises(ValueError, match="rate"):
            mod.poisson_arrivals(mod.VirtualClock(), 0.0, 3, 0)
        with pytest.raises(ValueError, match="count"):
            mod.poisson_arrivals(mod.VirtualClock(), 1.0, -1, 0)


def _schedule(f, msgs):
    return f.FaultSchedule(
        crashes=(f.CrashWindow(agent=1, start=10.0, end=20.0),
                 f.CrashWindow(agent=1, start=18.0, end=30.0),
                 f.CrashWindow(agent=3, start=5.0, end=5.0),
                 f.CrashWindow(agent=4, start=40.0, end=41.5)),
        ramps=(f.StragglerRamp(agents=(0, 2), start=0.0, end=50.0,
                               factor=8.0),
               f.StragglerRamp(agents=(2,), start=25.0, end=35.0,
                               factor=3.0)),
        messages=f.MessageFaults(**msgs),
        switches=(f.ByzantineSwitch(at=30.0, byz_ids=(1,),
                                    attack="sign_flip"),
                  f.ByzantineSwitch(at=12.0, byz_ids=(0, 5),
                                    attack=None)),
        churn=(f.ChurnEvent(at=30.0, changes=(("r", 2),)),
               f.ChurnEvent(at=5.0, changes=(("r", 1), ("tau", 3)))))


def test_fault_schedule_queries_match():
    sj, st = _schedule(jfaults, {}), _schedule(tfaults, {})
    grid = np.linspace(-1.0, 55.0, 113)
    for j in range(6):
        for t in grid:
            assert st.alive(j, t) == sj.alive(j, t)
            assert st.lat_multiplier(j, t) == sj.lat_multiplier(j, t)
            assert st.next_recovery(j, t) == sj.next_recovery(j, t)
            for dt in (0.0, 0.7, 9.0):
                assert st.alive_throughout(j, t, t + dt) == \
                    sj.alive_throughout(j, t, t + dt)
                assert st.first_crash_start(j, t, t + dt) == \
                    sj.first_crash_start(j, t, t + dt)
    assert st.next_recovery(1, 11.0) == 30.0      # chained windows walked
    ev_j, ev_t = sj.control_events(), st.control_events()
    assert [(t, k) for t, k, _ in ev_t] == [(t, k) for t, k, _ in ev_j]
    assert [e.at for _, _, e in ev_t] == [5.0, 12.0, 30.0, 30.0]
    assert ev_t[1][2].byz_ids == (0, 5)
    assert ev_t[0][2].as_dict() == ev_j[0][2].as_dict() == {"r": 1,
                                                            "tau": 3}
    with pytest.raises(ValueError, match="unknown attack"):
        tfaults.ByzantineSwitch(at=1.0, byz_ids=(0,), attack="nope")


MSGS = [dict(), dict(drop_p=0.12, dup_p=0.08, reorder_jitter=0.25),
        dict(drop_p=0.3), dict(dup_p=0.2), dict(reorder_jitter=0.5)]


def _latency(mod_engine):
    return mod_engine.LatencyModel(n_agents=6, mean=1.0, sigma=0.4,
                                   straggler_ids=(2,), straggler_factor=5.0,
                                   comm=0.05)


def _drive(tr, calls=200):
    """200 mixed transport calls; the caller's rng is never read."""
    out = []
    for i in range(calls):
        now = 0.3 * i
        kind = i % 3
        if kind == 0:
            lat = tr.round_latencies(now, None)
            out.append(("round", lat.tolist(),
                        None if tr.last_round_drops is None
                        else tr.last_round_drops.tolist()))
        elif kind == 1:
            out.append(("task", tr.task_latency(i % 6, now, None)))
        else:
            out.append(("fate", tr.delivery_fate(i % 6, now, None)))
        out.append((tr.alive(i % 6, now), tr.drops, tr.dups))
    return out


@pytest.mark.parametrize("msgs", MSGS, ids=str)
def test_sim_transport_streams_match(msgs):
    from repro.core import async_engine as jeng
    from repro_torch.core import async_engine as teng
    tj = jfaults.SimTransport(6, _schedule(jfaults, msgs), _latency(jeng),
                              seed=5)
    tt = tfaults.SimTransport(6, _schedule(tfaults, msgs), _latency(teng),
                              seed=5)
    a, b = _drive(tj), _drive(tt)
    assert b == a
    if msgs.get("drop_p"):
        assert tt.drops > 0
    if msgs.get("dup_p"):
        assert tt.dups > 0
    tt.reset()
    assert (tt.drops, tt.dups, tt.last_round_drops) == (0, 0, None)
    assert _drive(tt, 30) == a[:60]


def test_sim_transport_state_dict_round_trips():
    msgs = MSGS[1]
    tt = tfaults.SimTransport(6, _schedule(tfaults, msgs), seed=9)
    _drive(tt, 50)
    state = tt.state_dict()
    tail = _drive(tt, 80)
    other = tfaults.SimTransport(6, _schedule(tfaults, msgs), seed=1234)
    other.load_state(state)
    assert _drive(other, 80) == tail
    tj = jfaults.SimTransport(6, _schedule(jfaults, msgs), seed=9)
    _drive(tj, 50)
    assert tj.state_dict() == state
