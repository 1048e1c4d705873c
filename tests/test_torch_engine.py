"""Port parity for the engine: ``repro_torch`` ``AsyncEngine`` and
``AsyncDGDServer`` against ``repro``'s on ``make_redundant_quadratics``
costs, fresh and stale, host and device backends, every rule, plus one
Byzantine case. The event fields (n_rx, max_age, staleness, comm_time,
wall, bytes_tx) come from the same numpy draws and must match exactly;
loss and iterate match within the tolerances of
``test_gradledger.py`` (the aggregation is f32 in both, in another
reduction order). Port-only: snapshot -> restore -> run is bit-identical
to the uninterrupted run, and ``reconfigure`` round-trips."""
import dataclasses

import numpy as np
import pytest

from repro.core import async_engine as jeng
from repro.core import redundancy as jred
from repro.core import server as jsrv
from repro_torch.core import async_engine as teng
from repro_torch.core import redundancy as tred
from repro_torch.core import server as tsrv

N, D, ITERS = 8, 4, 25
EXACT = ("n_rx", "max_age", "staleness", "comm_time", "wall", "bytes_tx")


def _costs(red):
    return red.make_redundant_quadratics(N, D, spread=0.02, cond=1.5, seed=0)


def _cfg(mod, **kw):
    base = dict(n_agents=N, step_size=lambda t: 0.02, proj_gamma=30.0,
                seed=1)
    base.update(kw)
    if mod is teng:
        base["device"] = "cpu"
    return mod.EngineConfig(**base)


def _run(mod, red, **kw):
    costs = _costs(red)
    eng = mod.AsyncEngine(lambda j, x, rng: costs.grad(j, x), np.zeros(D),
                          _cfg(mod, **kw), loss_fn=costs.loss,
                          x_star=costs.global_min())
    return eng, eng.run(ITERS)


def _assert_parity(jh, th, jx, tx):
    for name in EXACT:
        assert getattr(th, name) == getattr(jh, name), name
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(th.dist, jh.dist, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tx, np.float64),
                               np.asarray(jx, np.float64), rtol=1e-3,
                               atol=1e-5)


RULES = [("sum", 0), ("mean", 0), ("cge", 1), ("trimmed_mean", 1),
         ("quantized", 0)]


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["fresh", "stale"])
@pytest.mark.parametrize("rule,f", RULES)
def test_engine_matches_jax(rule, f, mode, backend):
    kw = dict(r=2, mode=mode, tau=3, f=f, rule=rule, agg_backend=backend)
    je, jh = _run(jeng, jred, **kw)
    te, th = _run(teng, tred, **kw)
    assert len(th.loss) == ITERS
    _assert_parity(jh, th, je.x, te.x)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_byzantine_sign_flip_cge_matches_jax(backend):
    kw = dict(r=1, f=1, rule="cge", byz_ids=(2,), attack="sign_flip",
              agg_backend=backend)
    je, jh = _run(jeng, jred, **kw)
    te, th = _run(teng, tred, **kw)
    _assert_parity(jh, th, je.x, te.x)


def test_crash_windows_match_jax():
    kw = dict(r=1, mode="stale", tau=2, agg_backend="device",
              crashes=((0, 0.0, 8.0), (5, 3.0, 20.0)))
    je, jh = _run(jeng, jred, **kw)
    te, th = _run(teng, tred, **kw)
    _assert_parity(jh, th, je.x, te.x)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["fresh", "stale"])
def test_server_matches_jax_across_reconfigure(mode, backend):
    runs = {}
    for mod, srvmod, red in ((jeng, jsrv, jred), (teng, tsrv, tred)):
        costs = _costs(red)
        srv = srvmod.AsyncDGDServer(lambda j, x, rng: costs.grad(j, x),
                                    np.zeros(D),
                                    _cfg(mod, r=2, mode=mode, tau=2,
                                         rule="cge", f=1,
                                         agg_backend=backend),
                                    loss_fn=costs.loss)
        srv.run(10)
        srv.reconfigure(r=3, rule="trimmed_mean")
        h = srv.run(10)
        runs[mod] = (h, srv.x)
    _assert_parity(*(runs[jeng][0], runs[teng][0]),
                   runs[jeng][1], runs[teng][1])


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["fresh", "stale"])
def test_snapshot_restore_bit_identical(mode, backend):
    costs = _costs(tred)
    cfg = _cfg(teng, r=2, mode=mode, tau=2, rule="cge", f=1,
               agg_backend=backend)
    srv = tsrv.AsyncDGDServer(lambda j, x, rng: costs.grad(j, x),
                              np.zeros(D), cfg, loss_fn=costs.loss)
    srv.run(12)
    snap = srv.snapshot()
    srv.run(15)
    x_a = srv.x.copy()
    hist_a = dataclasses.asdict(srv.engine.hist)
    ledger_a = srv.engine.ledger_host()
    srv.restore(snap, cfg)
    srv.run(15)
    np.testing.assert_array_equal(srv.x, x_a)            # exact, not close
    np.testing.assert_array_equal(srv.engine.ledger_host(), ledger_a)
    assert dataclasses.asdict(srv.engine.hist) == hist_a


def test_reconfigure_changes_r_and_keeps_history():
    costs = _costs(tred)
    srv = tsrv.AsyncDGDServer(lambda j, x, rng: costs.grad(j, x),
                              np.zeros(D), _cfg(teng, r=1,
                                                agg_backend="device"),
                              loss_fn=costs.loss)
    srv.run(5)
    bytes_before = srv.engine.hist.bytes_tx
    srv.reconfigure(r=4)
    assert srv.engine.cfg.r == 4 and srv.engine.cfg.device == "cpu"
    h = srv.run(5)
    assert h.n_rx == [N - 1] * 5 + [N - 4] * 5
    assert h.bytes_tx > bytes_before and len(h.loss) == 10


def test_backend_errors():
    with pytest.raises(ValueError, match="needs a mesh"):
        _run(teng, tred, agg_backend="sharded")
    with pytest.raises(ValueError, match="agg_backend"):
        _run(teng, tred, agg_backend="gpu")
    cfg = teng.EngineConfig(n_agents=2)
    assert cfg.device == "cuda" and cfg.agg_backend == "host"
    jfields = {f.name for f in dataclasses.fields(jeng.EngineConfig)}
    tfields = {f.name for f in dataclasses.fields(teng.EngineConfig)}
    assert tfields == jfields | {"device"}
