"""Port parity for the aggregation kernels: the plain torch forms of
``repro_torch.kernels.agg`` and the ``ops`` dispatchers against the JAX
Pallas kernels run in interpret mode, over ``test_kernels_agg.SWEEP``
(P not a tile multiple included), plus every registry device twin
against the JAX reference rule. The CUDA kernels themselves are held
against these plain forms on the card (``test_torch_kernels_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradagg as jg
from repro.dist import registry as jreg
from repro.kernels import agg as jagg
from repro_torch.core import gradagg as tg
from repro_torch.dist import registry as treg
from repro_torch.kernels import agg as tagg
from repro_torch.kernels import ops

SWEEP = [(8, 2048, 2048), (20, 4096, 1024), (6, 5000, 2048), (3, 1000, 512)]
TOL = dict(rtol=2e-4, atol=2e-4)


def _stack(n, p, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    received = rng.random(n) > 0.3
    return g, received


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


@pytest.mark.parametrize("n,p,tile", SWEEP)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_masked_cge_matches_pallas(n, p, tile, f):
    g, rx = _stack(n, p, seed=f)
    ref = np.asarray(jagg.masked_cge_reduce(jnp.asarray(g), jnp.asarray(rx),
                                            f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    np.testing.assert_allclose(tagg.masked_cge_dot(tgt, trx, f).numpy(),
                               ref, **TOL)
    np.testing.assert_allclose(ops.masked_cge_reduce(tgt, trx, f=f).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("n,p,tile", SWEEP)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_trimmed_mean_matches_pallas(n, p, tile, f):
    g, rx = _stack(n, p, seed=10 + f)
    ref = np.asarray(jagg.trimmed_mean_tiled(jnp.asarray(g), jnp.asarray(rx),
                                             f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    np.testing.assert_allclose(
        tagg.trimmed_mean_running(tgt, trx, f).numpy(), ref, **TOL)
    np.testing.assert_allclose(
        ops.trimmed_mean_tiled(tgt, trx, f=f).numpy(), ref, **TOL)


@pytest.mark.parametrize("n,p,tile", SWEEP)
def test_dequant_accum_matches_pallas(n, p, tile):
    g, rx = _stack(n, p, seed=20)
    qj, sj = jg.quantize_int8_parts(jnp.asarray(g))
    ref = np.asarray(jagg.dequant_accum(qj, sj[:, 0], jnp.asarray(rx),
                                        tile=tile, interpret=True))
    q, s = np.asarray(qj), np.asarray(sj)[:, 0]
    tq, ts, trx = _t(q, s, rx)
    np.testing.assert_allclose(tagg.dequant_dot(tq, ts, trx).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.dequant_accum(tq, ts, trx).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def _split_tie(p):
    """Seven rows, four of one norm with different contents (sign flips
    of one row square to the same values, so the norms tie exactly) and
    f=3: the keep-set of m-f=4 takes the smaller row and three of the
    four tied rows, so the id tie-break decides which tied row goes."""
    rng = np.random.default_rng(6)
    row = rng.normal(size=p).astype(np.float32)
    s1, s2 = np.where(rng.random((2, p)) < 0.5, -1.0, 1.0).astype(np.float32)
    g = np.stack([row * 0.5, row, -row, row * 2.0, row * s1, row * 3.0,
                  row * s2])
    return g, np.ones(7, bool), 3


@pytest.mark.parametrize("case", ["all_crashed", "m_minus_f_nonpositive",
                                  "ties", "duplicates"])
def test_edge_cases_match_pallas(case):
    g, _ = _stack(6, 1500, seed=4)
    f = 1
    if case == "all_crashed":
        rx = np.zeros(6, bool)
    elif case == "m_minus_f_nonpositive":
        rx, f = np.array([True, True] + [False] * 4), 3
    elif case == "ties":
        g, rx, f = _split_tie(1500)
    else:
        g = np.repeat(np.array([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                               np.float32), 1500, axis=1)
        rx = np.array([True, True, True, True, False, True])
    tgt, trx = _t(g, rx)
    for jk, tk in ((jagg.masked_cge_reduce, ops.masked_cge_reduce),
                   (jagg.trimmed_mean_tiled, ops.trimmed_mean_tiled)):
        ref = np.asarray(jk(jnp.asarray(g), jnp.asarray(rx), f, tile=512,
                            interpret=True))
        np.testing.assert_allclose(tk(tgt, trx, f=f).numpy(), ref,
                                   rtol=1e-6, atol=1e-6, err_msg=tk.__name__)


@pytest.mark.parametrize("impl", ["ref", "plain", "auto"])
def test_ops_impls_agree_on_cpu(impl):
    g, rx = _stack(7, 3333, seed=7)
    tgt, trx = _t(g, rx)
    for f in (0, 2):
        np.testing.assert_allclose(
            ops.masked_cge_reduce(tgt, trx, f=f, impl=impl).numpy(),
            np.asarray(jg.agg_cge(jnp.asarray(g), jnp.asarray(rx), f)), **TOL)
        np.testing.assert_allclose(
            ops.trimmed_mean_tiled(tgt, trx, f=f, impl=impl).numpy(),
            np.asarray(jg.agg_trimmed_mean(jnp.asarray(g), jnp.asarray(rx),
                                           f)), **TOL)
    q, s = tg.quantize_int8_parts(tgt)
    np.testing.assert_allclose(
        ops.dequant_accum(q, s[:, 0], trx, impl=impl).numpy(),
        np.asarray(jg.agg_quantized(jnp.asarray(g), jnp.asarray(rx))),
        rtol=1e-5, atol=1e-5)


def test_ops_rejects_cuda_impl_on_cpu_and_unknown_impl():
    tgt, trx = _t(*_stack(4, 100))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.masked_cge_reduce(tgt, trx, f=1, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.trimmed_mean_tiled(tgt, trx, f=1, impl="interpret")


def test_cpu_wrappers_launch_nothing():
    """On the CPU ``auto`` takes the plain forms and launches nothing; the
    wrappers themselves only launch, so a CPU tensor makes them raise."""
    tagg.reset_launches()
    tgt, trx = _t(*_stack(5, 300))
    q, s = tg.quantize_int8_parts(tgt)
    ops.masked_cge_reduce(tgt, trx, f=1)
    ops.trimmed_mean_tiled(tgt, trx, f=1)
    ops.dequant_accum(q, s[:, 0], trx)
    for call in (lambda: tagg.masked_cge_reduce(tgt, trx, 1),
                 lambda: tagg.trimmed_mean_tiled(tgt, trx, 1),
                 lambda: tagg.dequant_accum(q, s[:, 0], trx)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(tagg.LAUNCHES.values()) == {0}


def test_bind_device_every_rule_matches_jax_reference():
    g, rx = _stack(9, 2500, seed=8)
    tgt, trx = _t(g, rx)
    for name in treg.rule_names():
        ref = jreg.get_rule(name).bind_reference(f=1)(jnp.asarray(g),
                                                      jnp.asarray(rx))
        out = treg.get_rule(name).bind_device(f=1)(tgt, trx)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)
