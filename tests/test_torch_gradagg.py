"""Port parity: every GradAgg rule of ``repro_torch.core.gradagg`` (and
the registry's reference column) against ``repro.core.gradagg`` on the
same numpy inputs, |S^t| = n - r, with the JAX suite's tolerance
(rtol/atol 2e-4). Edge cases: exact norm ties (broken by agent id),
m - f <= 0, every agent crashed, duplicate values in the trimmed mean,
and the int8 wire form bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradagg as jg
from repro.dist import registry as jreg
from repro_torch.core import gradagg as tg
from repro_torch.dist import registry as treg

TOL = dict(rtol=2e-4, atol=2e-4)


def _stack(n, d, r, seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    received = np.zeros(n, bool)
    received[rng.choice(n, size=n - r, replace=False)] = True
    return g, received


def _both(rule_j, rule_t, g, received):
    out_j = np.asarray(rule_j(jnp.asarray(g), jnp.asarray(received)))
    out_t = rule_t(torch.from_numpy(g), torch.from_numpy(received)).numpy()
    return out_j, out_t


@pytest.mark.parametrize("name", ["sum", "mean", "cge", "trimmed_mean",
                                  "quantized"])
@pytest.mark.parametrize("n,d,r,f", [(8, 50, 2, 1), (20, 300, 3, 2),
                                     (5, 17, 0, 1), (12, 1000, 5, 3)])
def test_rule_matches_jax(name, n, d, r, f):
    g, rx = _stack(n, d, r, seed=n * 7 + r)
    out_j, out_t = _both(jreg.get_rule(name).bind_reference(f),
                         treg.get_rule(name).bind_reference(f), g, rx)
    assert out_t.dtype == np.float32 and out_t.shape == (d,)
    np.testing.assert_allclose(out_t, out_j, **TOL, err_msg=name)


def test_registry_columns_match_jax():
    assert treg.rule_names() == jreg.rule_names()
    for name in treg.rule_names():
        a, b = treg.get_rule(name), jreg.get_rule(name)
        assert (a.needs_f, a.normalized, a.wire_bytes) == \
            (b.needs_f, b.normalized, b.wire_bytes), name
    with pytest.raises(ValueError, match="unknown aggregation rule"):
        treg.get_rule("median")


def test_make_gradagg_resolves_through_registry():
    g, rx = _stack(6, 40, 1, seed=3)
    out_j, out_t = _both(jg.make_gradagg("cge", f=2),
                         tg.make_gradagg("cge", f=2), g, rx)
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_cge_ties_break_by_agent_id():
    """Identical rows tie in norm exactly: the stable argsort keeps the
    lower agent id first, in both frameworks."""
    row = np.random.default_rng(6).normal(size=200).astype(np.float32)
    g = np.stack([row * 2.0, row, row, row * 3.0, row])
    rx = np.ones(5, bool)
    for f in (1, 2, 3):
        mask_j = np.asarray(jg.cge_mask(jnp.asarray(g), jnp.asarray(rx), f))
        mask_t = tg.cge_mask(torch.from_numpy(g), torch.from_numpy(rx),
                             f).numpy()
        np.testing.assert_array_equal(mask_t, mask_j)
    out_j, out_t = _both(lambda a, b: jg.agg_cge(a, b, 2),
                         lambda a, b: tg.agg_cge(a, b, 2), g, rx)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)


def test_cge_mask_from_norms_ties_and_unreceived():
    norms = np.array([1.0, 0.5, 0.5, 2.0, 0.1, 0.5], np.float32)
    rx = np.array([True, True, True, True, False, True])
    for f in range(0, 6):
        mj = np.asarray(jg.cge_mask_from_norms(jnp.asarray(norms),
                                               jnp.asarray(rx), f))
        mt = tg.cge_mask_from_norms(torch.from_numpy(norms),
                                    torch.from_numpy(rx), f).numpy()
        np.testing.assert_array_equal(mt, mj, err_msg=f"f={f}")


@pytest.mark.parametrize("name", ["cge", "trimmed_mean"])
def test_m_minus_f_nonpositive(name):
    g, _ = _stack(6, 90, 0, seed=5)
    rx = np.array([True, True] + [False] * 4)
    out_j, out_t = _both(jreg.get_rule(name).bind_reference(3),
                         treg.get_rule(name).bind_reference(3), g, rx)
    np.testing.assert_array_equal(out_t, 0.0)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)


@pytest.mark.parametrize("name", ["sum", "mean", "cge", "trimmed_mean",
                                  "quantized"])
def test_all_agents_crashed(name):
    g, _ = _stack(6, 90, 0, seed=4)
    rx = np.zeros(6, bool)
    out_j, out_t = _both(jreg.get_rule(name).bind_reference(1),
                         treg.get_rule(name).bind_reference(1), g, rx)
    np.testing.assert_array_equal(out_t, 0.0)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)


def test_trimmed_mean_duplicates():
    g = np.array([[1.0] * 30, [1.0] * 30, [2.0] * 30, [3.0] * 30,
                  [1.0] * 30], np.float32)
    for rx in (np.ones(5, bool), np.array([True, True, False, True, True])):
        for f in (1, 2):
            out_j, out_t = _both(
                lambda a, b: jg.agg_trimmed_mean(a, b, f),
                lambda a, b: tg.agg_trimmed_mean(a, b, f), g, rx)
            np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_parts_bit_exact(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(7, 513)) * rng.uniform(1e-3, 50.0, size=(7, 1))
         ).astype(np.float32)
    # exact half-way points of the int8 grid: both round half to even
    x[0, :8] = np.float32(127.0) * np.array(
        [0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 1.0, -2.5], np.float32) / 127.0
    x[1] = 0.0                                     # all-zero row: floor scale
    qj, sj = jg.quantize_int8_parts(jnp.asarray(x))
    qt, st = tg.quantize_int8_parts(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj, ej = jg.quantize_int8(jnp.asarray(x))
    dt, et = tg.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


@pytest.mark.parametrize("gamma", [0.5, 1e6])
def test_project_ball(gamma):
    x = np.random.default_rng(9).normal(size=300).astype(np.float32)
    out_j = np.asarray(jg.project_ball(jnp.asarray(x), gamma))
    out_t = tg.project_ball(torch.from_numpy(x), gamma).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-7)


def test_tree_agg_and_tree_project_ball():
    rng = np.random.default_rng(3)
    stacked = {"a": rng.normal(size=(6, 2, 3)).astype(np.float32),
               "z": {"w": rng.normal(size=(6, 4)).astype(np.float32)}}
    rx = rng.random(6) > 0.4
    jt = {"a": jnp.asarray(stacked["a"]),
          "z": {"w": jnp.asarray(stacked["z"]["w"])}}
    tt = {"a": torch.from_numpy(stacked["a"]),
          "z": {"w": torch.from_numpy(stacked["z"]["w"])}}
    oj = jg.tree_agg(jg.agg_mean, jt, jnp.asarray(rx))
    ot = tg.tree_agg(tg.agg_mean, tt, torch.from_numpy(rx))
    np.testing.assert_allclose(ot["a"].numpy(), np.asarray(oj["a"]), **TOL)
    np.testing.assert_allclose(ot["z"]["w"].numpy(),
                               np.asarray(oj["z"]["w"]), **TOL)
    pj = jg.tree_project_ball(oj, 0.3)
    pt = tg.tree_project_ball(ot, 0.3)
    np.testing.assert_allclose(pt["z"]["w"].numpy(),
                               np.asarray(pj["z"]["w"]), rtol=1e-5,
                               atol=1e-6)
