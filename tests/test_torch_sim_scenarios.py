"""Port parity for the scenario registry and both runners: for every
named scenario, ``repro_torch.sim.scenario.run_train(sc, device="cpu")``
against a live run of ``repro.sim.scenario.run_train``, and ``run_serve``
against ``run_serve``.

Train: the discrete trace fields (``t``, ``n_rx``, ``r``, ``comm``,
``stale``, ``amax``) come from numpy event logic and the transport's own
seeded stream, so they must be identical, across ``reconfigure()`` churn
and Byzantine switches too, as must ``bytes_tx``, the transport's
``drops``/``dups`` and the (empty) violation lists. ``loss``, ``dist``
and the final iterate come from an f32 rule in another reduction order
than XLA's: ``loss`` within rtol 1e-4 / atol 1e-5, ``dist`` and x within
rtol 1e-3 / atol 1e-5 (``tests/test_torch_engine.py``). Serve: numpy end
to end, every trace field identical. Then the port's own counterparts of
the reference's falsifiability cases, and the device backend (plain
forms on the CPU) against the host backend on the two scenarios that
``chip_smoke.py`` runs on the card with it."""
import dataclasses

import numpy as np
import pytest

from repro.sim import conformance as jconf
from repro.sim import faults as jfaults
from repro.sim import scenario as jscen
from repro_torch.sim import conformance as tconf
from repro_torch.sim import faults as tfaults
from repro_torch.sim import scenario as tscen

ALL = sorted(jscen.SCENARIOS)
EXACT = ("t", "n_rx", "r", "comm", "stale", "amax")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
DIST_TOL = dict(rtol=1e-3, atol=1e-5)


def _field(trace, key):
    return [s[key] for s in trace]


def assert_train_parity(rj, rt):
    """Trace of the reference run ``rj`` against the port's ``rt``."""
    assert len(rt.trace) == len(rj.trace)
    assert [sorted(s) for s in rt.trace] == [sorted(s) for s in rj.trace]
    for key in EXACT:
        assert _field(rt.trace, key) == _field(rj.trace, key), key
    np.testing.assert_allclose(_field(rt.trace, "loss"),
                               _field(rj.trace, "loss"), **LOSS_TOL)
    np.testing.assert_allclose(_field(rt.trace, "dist"),
                               _field(rj.trace, "dist"), **DIST_TOL)
    np.testing.assert_allclose(np.asarray(rt.server.x, np.float64),
                               np.asarray(rj.server.x, np.float64),
                               **DIST_TOL)
    assert rt.hist.bytes_tx == rj.hist.bytes_tx
    assert rt.hist.wall == rj.hist.wall
    assert (rt.transport.drops, rt.transport.dups) == \
        (rj.transport.drops, rj.transport.dups)
    assert rt.violations == rj.violations
    assert dataclasses.asdict(rt.envelope) == dataclasses.asdict(rj.envelope)


def test_registry_matches_reference():
    """Same 13 names, and every field of every scenario (fault schedule
    included) equal to the reference's."""
    assert sorted(tscen.SCENARIOS) == ALL and len(ALL) == 13
    for name in ALL:
        assert dataclasses.asdict(tscen.get_scenario(name)) == \
            dataclasses.asdict(jscen.get_scenario(name)), name
    with pytest.raises(KeyError, match="unknown scenario"):
        tscen.get_scenario("definitely_not_registered")
    with pytest.raises(ValueError, match="duplicate"):
        tscen.register(tscen.get_scenario("steady_state"))


@pytest.mark.parametrize("name", ALL)
def test_run_train_matches_reference(name):
    rj = jscen.run_train(jscen.get_scenario(name))
    rt = tscen.run_train(tscen.get_scenario(name), device="cpu")
    assert_train_parity(rj, rt)
    assert rt.violations == []
    assert rt.server.engine.cfg.r == rj.server.engine.cfg.r
    assert rt.server.engine.cfg.attack == rj.server.engine.cfg.attack


@pytest.mark.parametrize("name", ALL)
def test_run_serve_matches_reference(name):
    rj = jscen.run_serve(jscen.get_scenario(name))
    rt = tscen.run_serve(tscen.get_scenario(name))
    assert rt.trace == rj.trace
    assert rt.violations == rj.violations == []
    np.testing.assert_array_equal(rt.latencies, rj.latencies)
    assert (rt.transport.drops, rt.transport.dups) == \
        (rj.transport.drops, rj.transport.dups)
    assert rt.dispatcher.cfg.r == rj.dispatcher.cfg.r
    assert rt.dispatcher.now == rj.dispatcher.now


@pytest.mark.parametrize("name", ["byzantine_flip_midrun",
                                  "rolling_restart"])
def test_device_backend_tracks_host_backend(name):
    """The resident ledger and the aggregation step (plain forms on the
    CPU) through reconfigure() switches and crash waves: same events as
    the host backend, floats within the engine suite's tolerance."""
    sc = tscen.get_scenario(name)
    rh = tscen.run_train(sc, device="cpu")
    rd = tscen.run_train(sc, device="cpu", agg_backend="device")
    assert rd.server.engine._dev is not None
    assert_train_parity(rh, rd)
    assert rd.violations == []


# ---------------------------------------------------------------------------
# the port's falsifiability cases (tests/test_sim_scenarios.py:113-155)


def test_aggregation_age_check_is_falsifiable():
    for conf in (jconf, tconf):
        assert conf.check_aggregation_ages(0.0, 3, t=5) is None
        assert conf.check_aggregation_ages(3.0, 3, t=5) is None
    v = tconf.check_aggregation_ages(4.0, 3, t=5)
    assert v == jconf.check_aggregation_ages(4.0, 3, t=5)
    assert v is not None and "rule (15)" in v
    rep = tscen.run_train(tscen.get_scenario("stale_storm"), device="cpu")
    assert len(rep.hist.max_age) == rep.scenario.iters
    assert max(rep.hist.max_age) <= rep.scenario.tau
    assert max(rep.hist.max_age) > 0


def test_fresh_mode_drops_do_not_false_positive_liveness():
    reps = []
    for scen, fpkg, kw in ((jscen, jfaults, {}), (tscen, tfaults,
                                                  {"device": "cpu"})):
        sc = dataclasses.replace(
            scen.get_scenario("steady_state"), name="fresh_drops",
            faults=fpkg.FaultSchedule(messages=fpkg.MessageFaults(
                drop_p=0.12)))
        reps.append(scen.run_train(sc, **kw))
    assert_train_parity(*reps)
    assert reps[1].transport.drops > 0
    assert reps[1].violations == []


def test_liveness_check_fires_when_uploads_go_missing():
    """The liveness gate is live: a step that used fewer than n-r uploads
    with every agent alive and nothing dropped is a violation, and an
    infinite round is one too."""
    for conf in (jconf, tconf):
        assert conf.check_liveness(3, 8, 2, 8, 6, 1.0) is None
        assert conf.check_liveness(3, 8, 2, 5, 5, 1.0) is None
    v = tconf.check_liveness(3, 8, 2, 8, 5, 1.0)
    assert v == jconf.check_liveness(3, 8, 2, 8, 5, 1.0) and "only 5" in v
    assert "blocked" in tconf.check_liveness(3, 8, 2, 8, 6, float("inf"))
    assert tconf.check_liveness(3, 8, 2, 8, 5, 1.0, dropped=3) is None


def test_total_outage_is_a_violation_not_a_crash():
    reps = []
    for scen, fpkg in ((jscen, jfaults), (tscen, tfaults)):
        sc = dataclasses.replace(
            scen.get_scenario("steady_state"), name="total_outage",
            faults=fpkg.FaultSchedule(crashes=tuple(
                fpkg.CrashWindow(agent=k, start=0.0, end=1e12)
                for k in range(8))))
        reps.append(scen.run_serve(sc))
    rj, rt = reps
    assert rt.trace == rj.trace and rt.violations == rj.violations
    assert len(rt.violations) >= 40
    assert all("no live replica" in v for v in rt.violations[:3])


def test_envelope_and_vote_checks_fire():
    env = tconf.Envelope(r=2, eps=0.01, alpha=0.5, gamma=1.0, bound=0.02)
    assert tconf.check_envelope(0.01, env) is None
    assert "envelope violated" in tconf.check_envelope(1.0, env)
    assert "vacuous" in tconf.check_envelope(
        0.0, dataclasses.replace(env, alpha=-0.1))
    honest = np.arange(6, dtype=np.int32)
    assert tconf.check_vote(honest, honest, (0, 1, 2), (0,), 0) is None
    assert "diverged" in tconf.check_vote(honest + 1, honest, (0, 1, 2),
                                          (0,), 0)
    assert tconf.check_vote(honest + 1, honest, (0, 1), (0,), 0) is None
    assert "disagree" in tconf.check_replica_agreement(
        {0: honest, 1: honest + 1}, [0, 1], 4)
    assert tconf.summarize([f"v{i}" for i in range(7)], 2) == \
        jconf.summarize([f"v{i}" for i in range(7)], 2)
    assert tconf.PLATEAU_C == jconf.PLATEAU_C


def test_churn_and_switches_land_like_the_reference():
    rt = tscen.run_train(tscen.get_scenario("churn_elastic"), device="cpu")
    assert rt.server.engine.cfg.r == 1
    assert set(_field(rt.trace, "r")) == {0, 3, 1}
    assert (np.diff(rt.hist.wall) >= 0).all()
    rb = tscen.run_train(tscen.get_scenario("byzantine_flip_midrun"),
                         device="cpu")
    assert rb.server.engine.cfg.attack == "large_norm"
    assert rb.server.engine.cfg.byz_ids == (0, 5)
