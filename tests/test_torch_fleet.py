"""Port parity for the fleet control plane: ``repro_torch.serve.fleet``
against ``repro.serve.fleet`` on the same inputs (numpy, so every number
must be identical, floats included): the phi-accrual detector's
suspicion sequences, the controller's transitions, ``state_dict`` and
``load_state`` (through the elastic resize), and ``HedgedDispatcher``
results, logs and telemetry over seeded fault-injecting transports of
each package's simulator, with the jitter streams they draw."""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.checkpoint import elastic as jelastic
from repro.serve import dispatch as jdispatch
from repro.serve import fleet as jfleet
from repro.sim import faults as jfaults
from repro.sim import scenario as jscen
from repro_torch.checkpoint import elastic as telastic
from repro_torch.serve import dispatch as tdispatch
from repro_torch.serve import fleet as tfleet
from repro_torch.sim import faults as tfaults
from repro_torch.sim import scenario as tscen

REF = SimpleNamespace(fleet=jfleet, dispatch=jdispatch, faults=jfaults,
                      scen=jscen, elastic=jelastic)
PORT = SimpleNamespace(fleet=tfleet, dispatch=tdispatch, faults=tfaults,
                       scen=tscen, elastic=telastic)


def _both(fn, *args, **kw):
    """``fn`` on the port and on the reference; returns both results."""
    return fn(PORT, *args, **kw), fn(REF, *args, **kw)


def _transport(pkg, n, crashes=(), seed=3, **faults):
    sc = pkg.scen.Scenario(
        name="fleet_fixture", description="hedged dispatch", n_agents=n,
        seed=seed, faults=pkg.faults.FaultSchedule(
            crashes=tuple(pkg.faults.CrashWindow(*c) for c in crashes),
            **faults))
    return sc.make_transport()


def _requests(k, seed=0, length=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length).astype(np.int32) for _ in range(k)]


def _result(res):
    return (None if res is None else
            (res.tokens.tolist(), res.round_latency, res.used,
             res.n_received, res.quorum_honest))


def _ctrl_record(ctrl):
    return ([(tr.t, tr.replica, tr.old, tr.new) for tr in ctrl.transitions],
            list(ctrl.state), list(ctrl.ewma), list(ctrl.probation),
            list(ctrl.last_sent), ctrl.deaths, ctrl.rejoins,
            [(d.gaps, d.last) for d in ctrl.det])


def _disp_record(disp, results):
    return ([_result(r) for r in results], _ctrl_record(disp.ctrl),
            disp.now, disp._rid, disp.hedges, disp.retries, disp.outages,
            disp.shed)


# ---------------------------------------------------------------------------
# detector and controller


def test_module_constants_equal_reference():
    assert tfleet.STATE_CODES == jfleet.STATE_CODES
    assert tfleet._JITTER_SALT == jfleet._JITTER_SALT
    assert [tfleet.vote_floor(f) for f in range(5)] == \
        [jfleet.vote_floor(f) for f in range(5)] == [1, 3, 5, 7, 9]
    for seed, inst, rid in ((0, 0, None), (7, 3, None), (5, 1, 12)):
        a = tfleet.jitter_stream(seed, inst, rid).random(16)
        b = jfleet.jitter_stream(seed, inst, rid).random(16)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_phi_sequences_equal_reference(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, 60)
    probes = rng.uniform(0.0, 8.0, 60)

    def run(pkg):
        det = pkg.fleet.PhiAccrualDetector(window=8, min_samples=3,
                                           init_interval=2.0)
        t, out = 0.0, [det.phi(1.0)]
        for g, p in zip(gaps, probes):
            t += float(g)
            det.observe(t)
            out += [det.phi(t), det.phi(t + float(p)),
                    det.phi(t + 0.1 * float(p))]
        return out, list(det.gaps), det.last

    ours, ref = _both(run)
    assert ours == ref
    assert max(ours[0]) > 3.0            # the sequence reaches "dead"


def test_controller_lifecycle_equal_reference():
    """The reference test's scripted lifecycle, then a seeded stream of
    observations, sends and polls over four replicas."""
    def run(pkg):
        f = pkg.fleet
        ctrl = f.FleetController(f.FleetConfig(n_replicas=2,
                                               probation_replies=2))
        for t in range(4):
            ctrl.observe(0, float(t))
            ctrl.note_sent(0, float(t) + 0.5)
        ctrl.note_sent(0, 4.0)
        fired = [ctrl.poll(4.2), ctrl.poll(4.5), ctrl.poll(8.0)]
        for t in (41.0, 42.0, 43.0):
            ctrl.observe(0, t)
        log = [[(tr.t, tr.replica, tr.old, tr.new) for tr in fs]
               for fs in fired]
        big = f.FleetController(f.FleetConfig(n_replicas=4, r=1))
        rng = np.random.default_rng(11)
        t = 0.0
        for _ in range(400):
            t += float(rng.exponential(0.5))
            j = int(rng.integers(0, 4))
            op = rng.integers(0, 4)
            if op == 0:
                big.note_sent(j, t)
            elif op == 1 and rng.random() < 0.7:
                big.observe(j, t)
                big.note_latency(j, float(rng.exponential(1.0)))
            else:
                log.append([(tr.t, tr.replica, tr.old, tr.new)
                            for tr in big.poll(t)])
            log.append((big.ranked(), big.n_countable(), big.degraded(),
                        big.expected_latency()))
        return log, _ctrl_record(ctrl), _ctrl_record(big)

    ours, ref = _both(run)
    assert ours == ref
    (_, (trs, *_), (big_trs, *_)) = ours
    assert [tr[3] for tr in trs] == ["suspect", "dead", "recovering",
                                     "healthy"]
    assert {tr[3] for tr in big_trs} >= {"suspect", "dead"}


def test_state_dict_and_elastic_resize_equal_reference():
    def run(pkg):
        f = pkg.fleet
        cfg = f.FleetConfig(n_replicas=3, window=4)
        ctrl = f.FleetController(cfg)
        for t in (1.0, 2.5, 3.0, 4.75, 6.0, 6.5):
            ctrl.observe(1, t)
        ctrl.note_sent(1, 7.0)
        ctrl.note_latency(1, 0.7)
        ctrl.observe(0, 2.0)
        ctrl.state[2] = f.DEAD
        flat = ctrl.state_dict()
        out = [flat]
        for n in (5, 2, 3):
            twin = f.FleetController(f.FleetConfig(n_replicas=n, window=4))
            twin.load_state(pkg.elastic.reshard_agent_state(flat, n))
            out.append(_ctrl_record(twin) + (twin.phi(n - 1, 100.0),))
        return out

    (flat_t, *rest_t), (flat_j, *rest_j) = _both(run)
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        assert flat_t[k].dtype == flat_j[k].dtype, k
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    assert rest_t == rest_j


def test_fleet_config_validation_equal_reference():
    for kw in (dict(n_replicas=4, r=4), dict(n_replicas=6, r=2,
                                             byz_ids=(0, 1))):
        for f in (tfleet, jfleet):
            with pytest.raises(ValueError):
                f.FleetConfig(**kw)
    assert tfleet.FleetConfig(n_replicas=8, r=2, byz_ids=(0, 1)).floor == 5


# ---------------------------------------------------------------------------
# hedged dispatch over each package's fault-injecting transport


def _dispatch_run(pkg, cfg_kw, n, crashes=(), t_seed=3, n_req=12,
                  spacing=2.0, req_seed=1, **faults):
    cfg = pkg.fleet.FleetConfig(n_replicas=n, **cfg_kw)
    honest = pkg.dispatch.honest_tokens
    disp = pkg.fleet.HedgedDispatcher(
        lambda j, req: honest(req), cfg,
        transport=_transport(pkg, n, crashes, seed=t_seed, **faults),
        jitter_instance=0)
    results = []
    for i, req in enumerate(_requests(n_req, seed=req_seed)):
        disp.now = max(disp.now, spacing * i)
        try:
            results.append(disp.dispatch(req))
        except pkg.dispatch.NoQuorumError as e:
            results.append(None)
            disp.now += 1.0
            assert e.deliverable < cfg.n_replicas - cfg.r
    return _disp_record(disp, results)


DISPATCH_CASES = {
    "clean": dict(cfg_kw=dict(r=2, seed=5), n=8),
    "crash_rejoin": dict(cfg_kw=dict(r=2, seed=5), n=8, n_req=40,
                         spacing=2.5, req_seed=2,
                         crashes=((0, 5.0, 60.0), (1, 5.0, 60.0))),
    "outage_backoff": dict(cfg_kw=dict(r=1, seed=7), n=4, n_req=6,
                           crashes=tuple((j, 5.0, 12.0) for j in range(4))),
    "total_outage": dict(cfg_kw=dict(r=0, seed=5, max_retries=2), n=3,
                         n_req=2, crashes=tuple((j, 0.0, 1e9)
                                                for j in range(3))),
    "byzantine": dict(cfg_kw=dict(r=2, byz_ids=(0, 5), attack="sign_flip",
                                  seed=9), n=8, t_seed=9, req_seed=3),
    "message_faults": dict(cfg_kw=dict(r=1, seed=4), n=5, n_req=20,
                           messages=None),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_hedged_dispatch_equal_reference(case):
    kw = dict(DISPATCH_CASES[case])
    if kw.pop("messages", 0) is None:
        ours = _dispatch_run(PORT, **kw, messages=tfaults.MessageFaults(
            drop_p=0.3, reorder_jitter=0.2))
        ref = _dispatch_run(REF, **kw, messages=jfaults.MessageFaults(
            drop_p=0.3, reorder_jitter=0.2))
    else:
        ours, ref = _both(_dispatch_run, **kw)
    assert ours == ref
    results, (trs, *_), _, _, hedges, retries, outages, _ = ours
    if case == "crash_rejoin":
        assert {tr[3] for tr in trs} == {"suspect", "dead", "recovering",
                                         "healthy"} and hedges >= 1
    if case in ("outage_backoff", "total_outage"):
        assert retries > 0
    if case == "total_outage":
        assert outages == 2 and results == [None, None]
    else:
        assert all(r is not None for r in results)


def test_serve_sheds_then_serves_equal_reference():
    def run(pkg):
        cfg = pkg.fleet.FleetConfig(n_replicas=4, r=1, seed=5, shed_below=1)
        honest = pkg.dispatch.honest_tokens
        disp = pkg.fleet.HedgedDispatcher(
            lambda j, req: honest(req), cfg, transport=_transport(pkg, 4),
            jitter_instance=0)
        disp.ctrl.state[0] = pkg.fleet.DEAD
        disp.ctrl.state[1] = pkg.fleet.DEAD
        results, lats = disp.serve(_requests(6, seed=4),
                                   priorities=[0, 1, 0, 2, 0, 1])
        return _disp_record(disp, results), lats.tolist()

    ours, ref = _both(run)
    assert ours == ref
    assert ours[0][-1] == 3 and all(r is not None for r in ours[0][0])


def test_reseed_replays_equal_reference():
    def run(pkg):
        cfg = pkg.fleet.FleetConfig(n_replicas=4, r=1, seed=7)
        honest = pkg.dispatch.honest_tokens
        disp = pkg.fleet.HedgedDispatcher(
            lambda j, rq: honest(rq), cfg,
            transport=_transport(pkg, 4, tuple((j, 5.0, 12.0)
                                               for j in range(4))),
            jitter_instance=1)
        req = _requests(1, seed=3)[0]
        out = []
        for _ in range(2):
            disp.now = 6.0
            out.append((_result(disp.dispatch(req)), disp.now, disp.retries))
            disp.reseed()
        return out

    ours, ref = _both(run)
    assert ours == ref and ours[0] == ours[1] and ours[0][2] > 0
