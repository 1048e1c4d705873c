"""Port parity for ``repro_torch.launch.train.make_general_step`` on 4
gloo ranks on the CPU (mesh data = 4, one agent per rank): modes cge
(f = 1), stale (tau = 1), trimmed (f = 1) and quantized, 3 steps each
with one agent masked per step, reduced qwen2-0.5b (2 layers, f32),
against an aggregate built here from live ``repro``: per-agent
``value_and_grad`` of JAX's ``make_loss_fn``, the ``repro.core.gradagg``
rule on the stacked gradients, JAX's clipping, optimizer and
``apply_updates``; loss, grad norm and parameters within 1e-5, and the
parameters the same on every rank, bit for bit. SGD with momentum, as in
``test_torch_train.py``. At model = 1 each mode is also bit for bit what
it was before the step computed tensor-parallel over "model" (sha256
digests ``BEFORE_TP``); the step at model > 1 is
``test_torch_general_tp.py``."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("cge", "stale", "trimmed", "quantized")
N, B, S, STEPS = 4, 8, 16, 3
TIMEOUT = 240


def _tc_kwargs(mode):
    return dict(mode=mode, optimizer="sgdm", lr=3e-2, lr_kind="cosine",
                lr_total=10, warmup=1, remat_policy="none", f=1, tau=1)


def _cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2)


def _data():
    rng = np.random.default_rng(0)
    cfg = _cfg()
    batches, masks = [], []
    for t in range(STEPS):
        x = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                        "weights": np.ones((B, S), np.float32)})
        m = np.ones(N, np.float32)
        m[[2, 2, 0][t]] = 0.0           # agent 2 twice: a stale row
        masks.append(m)
    return batches, masks


def _rank(rank, world, np_params, batches, masks):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import params_from_jax
    mesh = make_test_mesh(data=4, model=1, device="cpu")
    cfg = _cfg()
    out = {}
    for mode in MODES:
        tc = T.TrainConfig(**_tc_kwargs(mode))
        state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                             max_pos=64, n_agents=N, device="cpu", mesh=mesh)
        state["params"] = params_from_jax(np_params)
        step = T.make_general_step(cfg, tc, mesh)
        ms = []
        for b, m in zip(batches, masks):
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, m)
            ms.append((float(met["loss"]), float(met["grad_norm"])))
        out[mode] = {"metrics": ms, "params": [
            l.numpy().copy() for l in tree_flatten(state["params"])[0]]}
    return out


def _jax_reference(mode, jparams, batches, masks):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro.configs.registry import get_config as jax_config
    from repro.core import gradagg
    from repro.launch import train as jtrain
    from repro.optim.optimizers import apply_updates, clip_by_global_norm
    jcfg = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), n_layers=2)
    tc = jtrain.TrainConfig(**_tc_kwargs(mode))
    opt = jtrain.make_optimizer(tc)
    loss_fn = jtrain.make_loss_fn(jcfg, tc, 1)
    vg = jax.jit(jax.value_and_grad(loss_fn))
    params, ost = jparams, opt.init(jparams)
    flat0, unravel = ravel_pytree(params)
    ledger = np.zeros((N, flat0.size), np.float32)
    ts = np.full(N, -1)
    err = np.zeros((N, flat0.size), np.float32)
    per = B // N
    metrics = []
    for t, (b, m) in enumerate(zip(batches, masks)):
        losses, grads = [], []
        for j in range(N):
            l, g = vg(params, {k: jnp.asarray(v[j * per:(j + 1) * per])
                               for k, v in b.items()})
            losses.append(float(l))
            grads.append(np.asarray(ravel_pytree(g)[0], np.float32))
        g = np.stack(grads)
        rx = m > 0
        lsum = float(np.sum(np.float32(losses) * m))
        if mode == "cge":
            keep = np.asarray(gradagg.cge_mask(jnp.asarray(g),
                                               jnp.asarray(rx), tc.f))
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(g),
                                             jnp.asarray(keep)))
            denom = float(keep.sum())
        elif mode == "trimmed":
            agg = np.asarray(gradagg.agg_trimmed_mean(jnp.asarray(g),
                                                      jnp.asarray(rx), tc.f))
            denom = 1.0
        elif mode == "stale":
            ts = np.where(rx, t, ts)
            ledger = np.where(rx[:, None], g, ledger)
            usable = (t - ts) <= tc.tau
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(ledger),
                                             jnp.asarray(usable)))
            denom = float(usable.sum())
        else:
            x = g + err
            deq, res = gradagg.quantize_int8(jnp.asarray(x))
            agg = np.asarray(gradagg.agg_sum(deq, jnp.asarray(rx)))
            err = np.where(rx[:, None], np.asarray(res), x)
            denom = float(m.sum())
        denom = max(denom, 1.0)
        agg = unravel(jnp.asarray(agg / np.float32(denom)))
        agg, gnorm = clip_by_global_norm(agg, tc.clip_norm)
        upd, ost = opt.update(agg, ost, params, jnp.asarray(t, jnp.int32))
        params = apply_updates(params, upd,
                               jtrain.lr_at(tc, jnp.asarray(t, jnp.int32)))
        metrics.append((lsum / denom, float(gnorm)))
    return metrics, [np.asarray(l, np.float32)
                     for l in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jmodel
    jcfg = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), n_layers=2)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg, max_pos=64)
    np_params = jax.tree.map(np.asarray, jparams)
    batches, masks = _data()
    res = run_ranks(_rank, N, backend="gloo", device="cpu", timeout=TIMEOUT,
                    threads=1, args=(np_params, batches, masks),
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return jparams, batches, masks, res


@pytest.mark.parametrize("mode", MODES)
def test_general_step_matches_live_reference(spawned, mode):
    jparams, batches, masks, res = spawned
    want_m, want_p = _jax_reference(mode, jparams, batches, masks)
    for o in res:
        got = o[mode]
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(want_m), **TOL)
        assert len(got["params"]) == len(want_p)
        for a, b in zip(got["params"], want_p):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_general_step_params_identical_across_ranks(spawned, mode):
    *_, res = spawned
    for o in res[1:]:
        assert o[mode]["metrics"] == res[0][mode]["metrics"]
        for a, b in zip(o[mode]["params"], res[0][mode]["params"]):
            np.testing.assert_array_equal(a, b)


# sha256 of (metrics, parameters) of each mode's 3 steps on data 4 x
# model 1, as the step computed them before it computed tensor-parallel
# over "model" (the same runs on the parent tree of that change, torch
# 2.13 CPU, gloo)
BEFORE_TP = {
    "cge": "59936795c4113994a3f812f372da7942182f36f6"
           "0cb8c8a284f7074fb4091c01",
    "stale": "1cb38ce29fc46dc143af154fa5e736ae0da2e882"
             "b818236340591a3219b351b0",
    "trimmed": "10bbe9f52ac65b67554a2e3f93713a686c1d4282"
               "82f591c3df0108339fcce9a5",
    "quantized": "c980ff7c65cb879345aa420934fe18643725b45c70bb9aa261fb100e23"
                 "cb5cfb",
}


def _digest(run):
    h = hashlib.sha256(repr(run["metrics"]).encode())
    for p in run["params"]:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("mode", MODES)
def test_general_step_at_model_one_is_bit_for_bit_unchanged(spawned, mode):
    *_, res = spawned
    for o in res:
        assert _digest(o[mode]) == BEFORE_TP[mode]
