"""Port parity for the e2e load harness: ``repro_torch.sim.e2e`` over a
4-replica fleet of the port's ``ServeEngine`` (reduced qwen2-0.5b, f32,
on the CPU) against ``repro.sim.e2e`` over the reference's, the port's
fleet carrying the reference fleet's JAX weights. The fault fixtures are
those of ``tests/test_e2e_faults.py``: a crash window, a straggler ramp,
a Byzantine replica, message drops, a mid-superstep crash and a total
outage. Every request's copies (status, ``t_first``, ``t_done``,
``t_lost``, tokens), the native ``QuorumRow`` and every row of the
r-sweep must be identical, and both fleets drained after each case."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.sim import e2e as je2e
from repro.sim import faults as jfaults
from repro.sim import scenario as jscen
from repro_torch.models.model import params_from_jax
from repro_torch.sim import e2e as te2e
from repro_torch.sim import faults as tfaults
from repro_torch.sim import scenario as tscen


@pytest.fixture(scope="module")
def fleets():
    """The reference's fleet and the port's on the same weights; every
    test must leave both drained."""
    jfleet = je2e.EngineFleet(4)
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jfleet.engines[0].params))
    tfleet = te2e.EngineFleet(4, params=params, device="cpu")
    return jfleet, tfleet


@pytest.fixture(autouse=True)
def _drained(fleets):
    yield
    assert all(f.drained() for f in fleets), \
        "test leaked in-flight requests into a fleet"


def _tiny(pkg, name, **kw):
    kw.setdefault("n_agents", 4)
    kw.setdefault("r", 1)
    kw.setdefault("iters", 30)
    kw.setdefault("seed", 7)
    kw.setdefault("n_requests", 6)
    return pkg.Scenario(name=name, description="e2e fault-semantics fixture",
                        **kw)


# each case: fixture name -> (scenario fields built with a package's
# fault classes, n_requests); mirrors tests/test_e2e_faults.py
CASES = {
    "crash": lambda f: dict(faults=f.FaultSchedule(crashes=(
        f.CrashWindow(agent=0, start=0.0, end=1e9),))),
    "midstep_crash": lambda f: dict(faults=f.FaultSchedule(crashes=(
        f.CrashWindow(agent=2, start=1.3, end=6.0),
        f.CrashWindow(agent=0, start=4.05, end=9.0)))),
    "outage": lambda f: dict(faults=f.FaultSchedule(crashes=tuple(
        f.CrashWindow(agent=j, start=0.0, end=12.0) for j in range(4)))),
    "straggler": lambda f: dict(n_requests=8, faults=f.FaultSchedule(ramps=(
        f.StragglerRamp(agents=(1,), start=0.0, end=1e9, factor=30.0),))),
    "byzantine": lambda f: dict(byz_ids=(0,), attack="sign_flip"),
    "drops": lambda f: dict(n_requests=8, faults=f.FaultSchedule(
        messages=f.MessageFaults(drop_p=0.3, reorder_jitter=0.2))),
}


def _copy_fields(c):
    return (c.replica, c.status, c.t_first, c.t_done, c.t_lost,
            None if c.tokens is None else np.asarray(c.tokens).tolist())


def _assert_same_report(rj, rt):
    assert len(rt.requests) == len(rj.requests)
    for qj, qt in zip(rj.requests, rt.requests):
        assert (qt.idx, qt.arrival, qt.first_arrival, qt.retries) == \
            (qj.idx, qj.arrival, qj.first_arrival, qj.retries)
        np.testing.assert_array_equal(qt.prompt, qj.prompt)
        assert sorted(qt.copies) == sorted(qj.copies)
        for j in qj.copies:
            assert _copy_fields(qt.copies[j]) == _copy_fields(qj.copies[j]), \
                (qj.idx, j)
    assert rt.native.as_dict() == rj.native.as_dict()
    assert rt.native.violations == rj.native.violations
    assert sorted(rt.sweep) == sorted(rj.sweep)
    for r in rj.sweep:
        assert rt.sweep[r].as_dict() == rj.sweep[r].as_dict(), r
    assert rt.violations == rj.violations


@pytest.mark.parametrize("case", list(CASES))
def test_run_e2e_matches_reference(fleets, case):
    jfleet, tfleet = fleets
    rj = je2e.run_e2e(_tiny(jscen, f"t_{case}", **CASES[case](jfaults)),
                      fleet=jfleet)
    rt = te2e.run_e2e(_tiny(tscen, f"t_{case}", **CASES[case](tfaults)),
                      fleet=tfleet)
    _assert_same_report(rj, rt)
    assert rt.violations == []
    if case == "outage":
        assert any(q.retries for q in rt.requests)
    if case == "drops":
        assert any(c.status == te2e.DROPPED for q in rt.requests
                   for c in q.copies.values())
    if case == "byzantine":
        assert rt.native.n_ok == len(rt.requests)


def test_run_e2e_total_byzantine_flags_every_request(fleets):
    """Every replica Byzantine: both harnesses flag every request, with
    the same words."""
    jfleet, tfleet = fleets
    kw = dict(byz_ids=(0, 1, 2, 3), attack="sign_flip")
    rj = je2e.run_e2e(_tiny(jscen, "t_allbyz", **kw), fleet=jfleet)
    rt = te2e.run_e2e(_tiny(tscen, "t_allbyz", **kw), fleet=tfleet)
    _assert_same_report(rj, rt)
    assert rt.native.n_ok == 0
    assert len(rt.violations) == len(rt.requests)


def test_mid_superstep_crash_loses_the_steps_tokens(fleets):
    """One replica, driven directly: a window opening inside a superstep
    loses the copy at the crash instant in both harnesses, and the
    replica's clock and the post-recovery copy agree."""
    out = []
    for pkg, fpkg, scen, fleet in zip((je2e, te2e), (jfaults, tfaults),
                                      (jscen, tscen), fleets):
        sched = fpkg.FaultSchedule(crashes=(fpkg.CrashWindow(
            agent=0, start=0.05, end=5.0),))
        sc = _tiny(scen, "t_midstep", faults=sched)
        rng = np.random.default_rng(30)
        reqs = []
        for idx, t in enumerate((0.0, 9.0)):
            rq = pkg.E2ERequest(idx=idx, prompt=rng.integers(
                0, 256, 8).astype(np.int32), arrival=t, first_arrival=t)
            rq.max_new = 8
            reqs.append(rq)
        t_end = pkg._run_replica(0, fleet.engines[3],
                                 [(rq.arrival, rq) for rq in reqs],
                                 sc.make_transport(), sched, fleet.ecfg)
        out.append((t_end, [_copy_fields(rq.copies[0]) for rq in reqs]))
    assert out[1] == out[0]
    (t_end, (c0, c1)) = out[1]
    assert c0[1] == te2e.LOST and c0[4] == pytest.approx(0.05)
    assert c1[1] == te2e.DELIVERED and t_end >= c1[3] > 9.0


def test_engine_counters_bill_like_the_reference(fleets):
    """``step_and_bill`` reads the engines' counters: the port's advance
    exactly as the reference's over the same superstep sequence."""
    costs = []
    for mod, scen, fleet in zip((je2e, te2e), (jscen, tscen), fleets):
        eng = fleet.engines[1]
        transport = _tiny(scen, "t_bill").make_transport()
        rng = np.random.default_rng(11)
        for _ in range(3):
            eng.submit(rng.integers(0, 256, 8).astype(np.int32), 8)
        seq = []
        while not eng.sched.idle:
            seq.append((mod.step_and_bill(eng, 1, float(len(seq)),
                                          transport, fleet.ecfg),
                        eng.stats["decode_steps"], eng.stats["prefill_calls"],
                        eng.stats["supersteps"]))
        costs.append(seq)
    assert costs[1] == costs[0]
    assert len(costs[1]) > 2


def test_make_arrivals_matches_reference():
    sc_j = _tiny(jscen, "t_stream", n_requests=5)
    sc_t = _tiny(tscen, "t_stream", n_requests=5)
    for qj, qt in zip(je2e.make_arrivals(sc_j, 8),
                      te2e.make_arrivals(sc_t, 8)):
        assert (qt.idx, qt.arrival, qt.max_new) == (qj.idx, qj.arrival, 8)
        np.testing.assert_array_equal(qt.prompt, qj.prompt)


def test_fleet_refuses_a_mismatched_or_busy_replay(fleets):
    _, tfleet = fleets
    with pytest.raises(ValueError, match="cannot replay"):
        te2e.run_e2e(_tiny(tscen, "t_n8", n_agents=8), fleet=tfleet)
    eng = tfleet.engines[0]
    eng.submit(np.arange(8, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="drained"):
        te2e.run_e2e(_tiny(tscen, "t_busy"), fleet=tfleet)
    eng.run()


def test_e2e_config_and_sweep_match_reference():
    assert dataclasses.asdict(te2e.E2EConfig()) == \
        dataclasses.asdict(je2e.E2EConfig())
    assert te2e.R_SWEEP == je2e.R_SWEEP
