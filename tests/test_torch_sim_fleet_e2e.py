"""Port parity for the fleet-controlled e2e replay:
``repro_torch.sim.fleet_e2e`` over a 4-replica fleet of the port's
``ServeEngine`` (reduced qwen2-0.5b, f32, on the CPU) against
``repro.sim.fleet_e2e`` over the reference's, the port's fleet carrying
the reference fleet's JAX weights. The fixtures are those of
``tests/test_fleet_e2e.py``: crash windows with checkpoint rejoin, a
clean run, Byzantine churn and a replay on the reused fleet. Every
request's copies, the native quorum row, the r-sweep, the
``FleetMetrics`` and the violations must be identical (virtual-time
floats included: both harnesses bill the same counters). Then the
engine level: the snapshot guard, restart from an image through the
``Checkpointer`` and a cold restart, streams equal to JAX's."""
import tempfile

import jax
import numpy as np
import pytest

from repro.serve import engine as jengine
from repro.sim import e2e as je2e
from repro.sim import faults as jfaults
from repro.sim import fleet_e2e as jfe
from repro.sim import scenario as jscen
from repro_torch.checkpoint import Checkpointer
from repro_torch.models.model import params_from_jax
from repro_torch.serve import SnapshotInFlightError
from repro_torch.sim import e2e as te2e
from repro_torch.sim import faults as tfaults
from repro_torch.sim import fleet_e2e as tfe
from repro_torch.sim import scenario as tscen


@pytest.fixture(scope="module")
def fleets():
    jfleet = je2e.EngineFleet(4)
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jfleet.engines[0].params))
    return jfleet, te2e.EngineFleet(4, params=params, device="cpu")


@pytest.fixture(autouse=True)
def _drained(fleets):
    yield
    assert all(f.drained() for f in fleets), \
        "test leaked in-flight requests into a fleet"


def _tiny(pkg, fpkg, name, crashes=(), **kw):
    kw.setdefault("n_agents", 4)
    kw.setdefault("r", 1)
    kw.setdefault("iters", 30)
    kw.setdefault("seed", 7)
    kw.setdefault("n_requests", 6)
    return pkg.Scenario(name=name, description="fleet recovery fixture",
                        faults=fpkg.FaultSchedule(crashes=tuple(
                            fpkg.CrashWindow(*c) for c in crashes)), **kw)


def _copy_fields(c):
    return (c.replica, c.status, c.t_first, c.t_done, c.t_lost,
            None if c.tokens is None else np.asarray(c.tokens).tolist())


def _same_float(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


def _assert_same_report(rt, rj):
    assert (rt.n_replicas, rt.max_new_tokens) == (rj.n_replicas,
                                                  rj.max_new_tokens)
    assert len(rt.requests) == len(rj.requests)
    for qt, qj in zip(rt.requests, rj.requests):
        assert (qt.idx, qt.arrival, qt.first_arrival, qt.retries) == \
            (qj.idx, qj.arrival, qj.first_arrival, qj.retries)
        assert sorted(qt.copies) == sorted(qj.copies)
        for j in qj.copies:
            assert _copy_fields(qt.copies[j]) == _copy_fields(qj.copies[j]), \
                (qj.idx, j)
    assert rt.native.as_dict() == rj.native.as_dict()
    assert sorted(rt.sweep) == sorted(rj.sweep)
    for r in rj.sweep:
        assert rt.sweep[r].as_dict() == rj.sweep[r].as_dict(), r
    mt, mj = rt.metrics.as_dict(), rj.metrics.as_dict()
    assert sorted(mt) == sorted(mj)
    for k in mj:
        assert _same_float(mt[k], mj[k]), (k, mt[k], mj[k])
    assert rt.violations == rj.violations


CASES = {
    "crash_rejoin": dict(crashes=((0, 6.0, 18.0), (1, 10.0, 24.0))),
    "clean": dict(),
    "byzantine_churn": dict(byz_ids=(0,), attack="sign_flip",
                            crashes=((1, 5.0, 16.0),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_e2e_equals_reference(fleets, case):
    jfleet, tfleet = fleets
    rj = jfe.run_fleet_e2e(_tiny(jscen, jfaults, f"f_{case}",
                                 **CASES[case]), fleet=jfleet)
    rt = tfe.run_fleet_e2e(_tiny(tscen, tfaults, f"f_{case}",
                                 **CASES[case]), fleet=tfleet)
    _assert_same_report(rt, rj)
    m = rt.metrics
    assert rt.violations == [] and m.permanently_lost == 0
    if case == "crash_rejoin":
        assert (m.deaths, m.rejoins, m.restarts) == (2, 2, 2)
        assert m.recovery_time_max >= m.recovery_time_mean > 0
        assert rt.native.n_unanswered == 0
    if case == "clean":
        assert (m.deaths, m.rejoins, m.restarts) == (0, 0, 0)
        assert m.recovered == 1.0 and rt.native.n_ok == 6
    if case == "byzantine_churn":
        assert (m.deaths, m.rejoins) == (1, 1)


def test_replay_on_the_reused_fleet_equals_reference(fleets):
    jfleet, tfleet = fleets
    kw = dict(crashes=((2, 5.0, 15.0),))
    reps = []
    for _ in range(2):
        reps.append((
            tfe.run_fleet_e2e(_tiny(tscen, tfaults, "f_replay", **kw),
                              fleet=tfleet),
            jfe.run_fleet_e2e(_tiny(jscen, jfaults, "f_replay", **kw),
                              fleet=jfleet)))
    for rt, rj in reps:
        _assert_same_report(rt, rj)
    _assert_same_report(reps[1][0], reps[0][0])
    assert reps[0][0].metrics.restarts == 1


def test_fleet_e2e_refuses_a_mismatched_or_busy_fleet(fleets):
    _, tfleet = fleets
    with pytest.raises(ValueError, match="cannot replay"):
        tfe.run_fleet_e2e(_tiny(tscen, tfaults, "f_n8", n_agents=8),
                          fleet=tfleet)
    eng = tfleet.engines[3]
    eng.submit(np.arange(8, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="drained"):
        tfe.run_fleet_e2e(_tiny(tscen, tfaults, "f_busy"), fleet=tfleet)
    eng.run()


# ---------------------------------------------------------------------------
# engine level: snapshot guard, checkpoint image, restart


def _prompt(seed, n=8):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def test_snapshot_guard(fleets):
    for eng, err in ((fleets[1].engines[0], SnapshotInFlightError),
                     (fleets[0].engines[0], jengine.SnapshotInFlightError)):
        rid = eng.submit(_prompt(50), 8)
        with pytest.raises(err, match="drained") as ei:
            eng.snapshot()
        assert isinstance(ei.value, RuntimeError)
        assert (ei.value.n_active, ei.value.n_waiting) == (0, 1)
        eng.run()
        assert rid in eng.sched.finished
        assert int(eng.snapshot()["next_rid"]) == eng._next_rid


def test_restart_from_checkpointed_image_and_cold(fleets):
    """Image through the port's Checkpointer, restart, the rid counter
    monotone, the same stream after as before and as JAX's engine; then
    a cold restart. The port's image has the reference's keys, shapes
    and dtypes."""
    jfleet, tfleet = fleets
    out = []
    for eng in (tfleet.engines[1], jfleet.engines[1]):
        rid0 = eng.submit(_prompt(51), 8)
        s0 = eng.run()[rid0]
        image = eng.snapshot()
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, keep=1)
            ck.save(image, step=0, blocking=True)
            loaded, _ = ck.restore_flat()
        eng.submit(_prompt(52), 8)
        eng.step()
        eng.crash()
        restarts = eng.stats.get("restarts", 0)
        eng.restart(loaded)
        assert eng.stats["restarts"] == restarts + 1 and eng.sched.idle
        rid1 = eng.submit(_prompt(51), 8)
        assert rid1 > rid0
        s1 = eng.run()[rid1]
        np.testing.assert_array_equal(s0, s1)
        eng.restart()
        rid2 = eng.submit(_prompt(51), 8)
        np.testing.assert_array_equal(eng.run()[rid2], s0)
        out.append((np.asarray(s0).tolist(), {k: (v.shape, v.dtype)
                                              for k, v in loaded.items()}))
    assert out[0] == out[1]


def test_run_fleet_e2e_builds_its_fleet_on_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfe.run_fleet_e2e(_tiny(tscen, tfaults, "f_default"))
