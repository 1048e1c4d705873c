"""Port parity for replica dispatch: ``repro_torch.serve.dispatch``
against ``repro.serve.dispatch`` on the same requests, seeds and
transports. For r in {0..3} and every attack in ``ATTACKS``, with a
crash window and reply drops in the transport, each ``DispatchResult``
(``tokens``, ``used``, ``n_received``, ``round_latency``,
``quorum_honest``) must be identical; so must ``majority_vote`` (ties
to the smallest token), ``honest_majority``, ``corrupt_stream``, the
request mixes, and the typed ``NoQuorumError`` of a total outage."""
import dataclasses

import numpy as np
import pytest

from repro.core import async_engine as jeng
from repro.core.byzantine import ATTACKS
from repro.serve import dispatch as jd
from repro.sim import faults as jfaults
from repro_torch.core import async_engine as teng
from repro_torch.serve import dispatch as td
from repro_torch.sim import faults as tfaults

N = 8


def _requests(n=24, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 8).astype(np.int32) for _ in range(n)]


def _transport(eng, faults):
    lat = eng.LatencyModel(n_agents=N, sigma=0.5, straggler_ids=(3,),
                           straggler_factor=6.0)
    return faults.SimTransport(N, faults.FaultSchedule(
        crashes=(faults.CrashWindow(agent=6, start=5.0, end=30.0),),
        messages=faults.MessageFaults(drop_p=0.1)), lat, seed=4)


def _result(res):
    return (res.tokens.tolist(), res.tokens.dtype, res.used, res.n_received,
            res.round_latency, res.quorum_honest)


def _serve(d, eng, faults, r, attack, byz, wait_for_all=False):
    cfg = d.DispatchConfig(n_replicas=N, r=r, byz_ids=byz, attack=attack,
                           seed=11)
    disp = d.RedundantDispatcher(lambda j, req: d.honest_tokens(req), cfg,
                                 transport=_transport(eng, faults))
    return [_result(disp.dispatch(q, wait_for_all=wait_for_all))
            for q in _requests()], disp.now


@pytest.mark.parametrize("attack", sorted(ATTACKS))
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_dispatch_results_match_reference(r, attack):
    a = _serve(jd, jeng, jfaults, r, attack, (1, 5))
    b = _serve(td, teng, tfaults, r, attack, (1, 5))
    assert b == a
    results, _ = b
    assert {n for _, _, _, n, _, _ in results} <= set(range(1, N - r + 1))


def test_dispatch_wait_for_all_and_default_transport_match():
    a = _serve(jd, jeng, jfaults, 2, "sign_flip", (0,), wait_for_all=True)
    b = _serve(td, teng, tfaults, 2, "sign_flip", (0,), wait_for_all=True)
    assert b == a
    out = []
    for d in (jd, td):
        disp = d.RedundantDispatcher(
            lambda j, req: d.honest_tokens(req),
            d.DispatchConfig(n_replicas=N, r=2, seed=5))
        toks, lats = disp.serve(_requests(10))
        disp.reseed()
        toks2, lats2 = disp.serve(_requests(10))
        assert np.array_equal(lats, lats2)
        out.append(([t.tolist() for t in toks], lats.tolist(),
                    d.tail_latency(lats), d.tail_latency(lats, 50.0)))
    assert out[1] == out[0]


def test_majority_vote_and_honest_majority_match():
    rng = np.random.default_rng(0)
    for m in (1, 2, 3, 4, 5, 7):
        for _ in range(20):
            s = rng.integers(0, 4, size=(m, 9)).astype(np.int32)
            v = td.majority_vote(s)
            assert v.dtype == s.dtype
            np.testing.assert_array_equal(v, jd.majority_vote(s))
    tie = np.array([[5, 1], [2, 1], [5, 3], [2, 3]], np.int64)
    np.testing.assert_array_equal(td.majority_vote(tie), [2, 1])
    assert td.majority_vote(np.zeros((3, 0), np.int32)).shape == (0,)
    for used in range(0, 9):
        for byz in range(0, used + 1):
            assert td.honest_majority(used, byz) == \
                jd.honest_majority(used, byz)
    assert not td.honest_majority(4, 2)              # a tie is not sound


@pytest.mark.parametrize("attack", [None, *sorted(ATTACKS)])
def test_corrupt_stream_matches(attack):
    toks = np.random.default_rng(1).integers(0, 256, 12).astype(np.int32)
    a = jd.corrupt_stream(toks, attack, np.random.default_rng(7))
    b = td.corrupt_stream(toks, attack, np.random.default_rng(7))
    assert b.dtype == a.dtype == np.int64
    np.testing.assert_array_equal(b, a)


def test_request_mixes_match():
    for req in _requests(5):
        np.testing.assert_array_equal(td.honest_tokens(req),
                                      jd.honest_tokens(req))
        np.testing.assert_array_equal(td.honest_tokens(req, 20),
                                      jd.honest_tokens(req, 20))
    for share in (0.0, 0.5, 0.9):
        a = jd.prefix_mix_requests(12, share, seed=3)
        b = td.prefix_mix_requests(12, share, seed=3)
        assert [x.tolist() for x in b] == [x.tolist() for x in a]


def test_total_outage_raises_typed_no_quorum_error():
    errs = []
    for d, eng, faults in ((jd, jeng, jfaults), (td, teng, tfaults)):
        dead = faults.SimTransport(N, faults.FaultSchedule(crashes=tuple(
            faults.CrashWindow(agent=j, start=0.0, end=1e9)
            for j in range(N))), eng.LatencyModel(n_agents=N), seed=0)
        disp = d.RedundantDispatcher(lambda j, req: d.honest_tokens(req),
                                     d.DispatchConfig(n_replicas=N, r=1),
                                     transport=dead)
        with pytest.raises(d.NoQuorumError) as info:
            disp.dispatch(_requests(1)[0])
        with pytest.raises(RuntimeError, match="no live replica"):
            disp.dispatch(_requests(1)[0])
        errs.append((info.value.rid, info.value.deliverable,
                     info.value.wait, str(info.value)))
    assert errs[1] == errs[0] == (0, 0, N - 1, errs[0][3])


def test_dispatch_config_validates_like_reference():
    for d in (jd, td):
        with pytest.raises(ValueError, match="0 <= r < n"):
            d.DispatchConfig(n_replicas=4, r=4)
        with pytest.raises(ValueError, match="outvote"):
            d.DispatchConfig(n_replicas=4, r=1, byz_ids=(0, 1))
    assert dataclasses.asdict(td.DispatchConfig(n_replicas=5)) == \
        dataclasses.asdict(jd.DispatchConfig(n_replicas=5))
