"""Port parity for the §5 LeNet path: weights and the flat iterate carry
over from JAX as-is (ravel_pytree order, HWIO/NHWC layouts), logits and
flat gradients match the reference, and — the slice as a whole — three
server iterations of the §5 experiment at full LeNet width (n=4, r=1,
batch 8, the device backend) track ``benchmarks/comm_time.py``'s agent
gradient function driven by ``repro``'s engine step for step."""
import importlib.util
from pathlib import Path

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_engine as jeng
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import lenet as jlenet
from repro.models import model as jmodel
from repro_torch.core import async_engine as teng
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import lenet as tlenet
from repro_torch.models import model as tmodel

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)     # conv reduction order differs


def _comm_time():
    spec = importlib.util.spec_from_file_location(
        "comm_time_reference", ROOT / "benchmarks" / "comm_time.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_params():
    return jlenet.init_lenet(jax.random.PRNGKey(0))


def test_param_count_and_flat_order(jax_params):
    assert tlenet.param_count(
        tlenet.init_lenet(torch.Generator().manual_seed(0),
                          device="cpu")) == 431_080
    params = tlenet.params_from_jax(jax_params)
    assert tlenet.param_count(params) == 431_080
    flat_j, _ = jax.flatten_util.ravel_pytree(jax_params)
    layout = tlenet.lenet_layout()
    assert layout.total == 431_080
    np.testing.assert_array_equal(layout.flatten(params).numpy(),
                                  np.asarray(flat_j))
    back = layout.unflatten(tlenet.flat_from_jax(np.asarray(flat_j)))
    np.testing.assert_array_equal(back["c2"]["w"].numpy(),
                                  np.asarray(jax_params["c2"]["w"]))


def test_logits_and_grads_match_jax(jax_params):
    train, _ = jsyn.mnist_like(n_train=16, n_test=1, seed=3)
    x, y = train.x, train.y
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    logits_j = jlenet.apply_lenet(jax_params, jnp.asarray(x))
    params = tlenet.params_from_jax(jax_params)
    logits_t = tlenet.apply_lenet(params, torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **TOL)
    loss_j = jmodel.classifier_loss(logits_j, jnp.asarray(y), jnp.asarray(w))
    loss_t = tmodel.classifier_loss(logits_t, torch.from_numpy(y),
                                    torch.from_numpy(w))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)

    flat_j, unravel = jax.flatten_util.ravel_pytree(jax_params)

    def loss_flat(fl):
        lg = jlenet.apply_lenet(unravel(fl), jnp.asarray(x))
        return jmodel.classifier_loss(lg, jnp.asarray(y), jnp.asarray(w))

    grad_j = np.asarray(jax.grad(loss_flat)(flat_j))
    flat_t = tlenet.flat_from_jax(np.asarray(flat_j)).requires_grad_(True)
    lt = tmodel.classifier_loss(
        tlenet.apply_lenet(tlenet.lenet_layout().unflatten(flat_t),
                           torch.from_numpy(x)),
        torch.from_numpy(y), torch.from_numpy(w))
    (grad_t,) = torch.autograd.grad(lt, flat_t)
    np.testing.assert_allclose(grad_t.numpy(), grad_j, **TOL)


def test_data_and_partition_match_jax():
    tj, _ = jsyn.mnist_like(n_train=64, n_test=8, seed=1)
    tt, _ = tsyn.mnist_like(n_train=64, n_test=8, seed=1)
    np.testing.assert_array_equal(tt.x, tj.x)
    sj = jpart.partition(tj, 5, overlap=2, seed=1)
    st = tpart.partition(tt, 5, overlap=2, seed=1)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b.y, a.y)
    xb_j, _ = jpart.agent_batch(sj[2], 4, np.random.default_rng(7))
    xb_t, _ = tpart.agent_batch(st[2], 4, np.random.default_rng(7))
    np.testing.assert_array_equal(xb_t, xb_j)


def test_section5_slice_three_steps_match_jax():
    """The §5 experiment end to end at full LeNet width and small scale:
    same flat0 (from JAX), same data, same per-agent batch streams; the
    iterate after each server step within atol 1e-5 and the event fields
    exact."""
    n, r, batch, eta = 4, 1, 8, 0.05
    ct = _comm_time()
    train_j, _ = jsyn.mnist_like(n_train=256, n_test=8, seed=0)
    grad_j, flat0, _ = ct.make_agent_grad_fn(
        jpart.partition(train_j, n, overlap=2, seed=0), batch)
    train_t, _ = tsyn.mnist_like(n_train=256, n_test=8, seed=0)
    grad_t, flat0_t, _ = tlenet.make_agent_grad_fn(
        tpart.partition(train_t, n, overlap=2, seed=0), batch,
        device="cpu", flat0=tlenet.flat_from_jax(np.asarray(flat0)))
    np.testing.assert_array_equal(flat0_t.numpy(), np.asarray(flat0))

    engines = []
    for mod, grad_fn, extra in ((jeng, grad_j, {}),
                                (teng, grad_t, {"device": "cpu"})):
        cfg = mod.EngineConfig(n_agents=n, r=r, rule="mean",
                               agg_backend="device",
                               step_size=lambda t: eta, proj_gamma=1e6,
                               seed=0, **extra)
        engines.append(mod.AsyncEngine(
            grad_fn, np.asarray(flat0), cfg,
            latency=mod.default_latency(n, n_stragglers=1, factor=10.0,
                                        seed=0)))
    ej, et = engines
    for _ in range(3):
        ej.step_fresh()
        et.step_fresh()
        np.testing.assert_allclose(et.x, ej.x, rtol=0, atol=1e-5)
    assert not np.array_equal(et.x, np.asarray(flat0, np.float64))
    for name in ("n_rx", "comm_time", "wall", "bytes_tx", "max_age"):
        assert getattr(et.hist, name) == getattr(ej.hist, name), name
