"""Port parity for ``repro_torch.launch.train`` and ``launch.loop``:
``make_train_step`` (masked, sync, ``accum_steps = 2``, remat on and off;
SGD with momentum) over 3 steps of reduced qwen2-0.5b (2 layers, f32) against JAX's
``make_train_step`` on the same weights and batches, within 1e-5 on
loss, grad norm and parameters; ``lr_at`` for every schedule; the masked
weights equal the gradients of the surviving examples (as
``test_arch_smoke::test_masked_weights_equal_subset_gradients``);
``StragglerOracle`` masks and round times exactly the reference's; and
``TrainLoop``'s loss falling, checkpoint restore continuing and
``comm_saving`` growing with r (as ``tests/test_system.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.data.partition import mask_to_weights
from repro.launch import loop as jloop
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import tree_flatten
from repro_torch.data.synthetic import lm_batches, markov_tokens
from repro_torch.launch import loop as tloop
from repro_torch.launch import train as ttrain
from repro_torch.models.model import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-0.5b"


def _cfgs(layers=2):
    return (dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers),
            dataclasses.replace(jax_config(ARCH).reduced(), n_layers=layers))


def _batches(cfg, n_agents, steps, r=1, b=8, s=16, seed=0):
    tokens = markov_tokens(5_000, vocab=cfg.vocab_size, seed=seed)
    data = lm_batches(tokens, b, s, seed=1)
    oracle = tloop.StragglerOracle(n_agents, r, seed=2)
    out = []
    for _ in range(steps):
        x, y = next(data)
        mask, _, _ = oracle.next_mask()
        out.append((x.astype(np.int32), y.astype(np.int32),
                    mask_to_weights(mask, b, s)))
    return out


def _leaves_np(tree):
    return [np.asarray(l.detach().float()) if isinstance(l, torch.Tensor)
            else np.asarray(l, np.float32) for l in tree_flatten(tree)[0]]


def _jax_leaves(tree):
    return [np.asarray(l, np.float32) for l in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode,accum,remat", [
    ("masked", 1, "none"), ("masked", 1, "full"), ("sync", 1, "none"),
    ("masked", 2, "none"), ("sync", 2, "full")])
def test_train_step_matches_jax(mode, accum, remat):
    cfg, jcfg = _cfgs()
    # SGD with momentum: AdamW's u = m / (sqrt(v) + eps) turns gradient
    # elements of order eps (1e-8) and their last-bit rounding into
    # updates of order 1 (its arithmetic is held in test_torch_optim.py)
    tc = ttrain.TrainConfig(mode=mode, optimizer="sgdm", lr=3e-2,
                            lr_kind="cosine", lr_total=10, warmup=1,
                            remat_policy=remat, accum_steps=accum)
    jtc = jtrain.TrainConfig(**dataclasses.asdict(tc))
    jstate = jtrain.init_state(jax.random.PRNGKey(0), jcfg, jtc, max_pos=64,
                               n_agents=4)
    state = ttrain.init_state(torch.Generator().manual_seed(0), cfg, tc,
                              max_pos=64, n_agents=4, device="cpu")
    state["params"] = params_from_jax(jax.tree.map(np.asarray,
                                                   jstate["params"]))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtc, moe_groups=4))
    step = ttrain.make_train_step(cfg, tc, moe_groups=4)
    for x, y, w in _batches(cfg, 4, 3):
        if mode == "sync":
            w = np.ones_like(w)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(x),
                                    "targets": jnp.asarray(y),
                                    "weights": jnp.asarray(w)})
        state, m = step(state, {"tokens": torch.from_numpy(x),
                                "targets": torch.from_numpy(y),
                                "weights": torch.from_numpy(w)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for a, b in zip(_leaves_np(state["params"]),
                    _jax_leaves(jstate["params"])):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(_leaves_np(state["opt"]), _jax_leaves(jstate["opt"])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kind,warmup", [("constant", 0), ("inv_t", 0),
                                         ("cosine", 0), ("cosine", 5),
                                         ("constant", 3)])
def test_lr_at_matches_jax(kind, warmup):
    tc = ttrain.TrainConfig(lr_kind=kind, lr=3e-3, lr_total=40,
                            warmup=warmup)
    jtc = jtrain.TrainConfig(**dataclasses.asdict(tc))
    for s in range(0, 50, 3):
        np.testing.assert_allclose(
            ttrain.lr_at(tc, s),
            float(jtrain.lr_at(jtc, jnp.asarray(s, jnp.int32))),
            rtol=1e-6)


# the full cosine horizons: lr_total = 1000 (warmup 0 and 15) and
# examples/train_lm.py's defaults (300 steps, warmup 300 // 20 = 15), every
# step and past the end, equal to the reference's f32 value bit for bit
@pytest.mark.parametrize("total,warmup", [(1000, 0), (1000, 15), (300, 15)])
def test_lr_at_cosine_bit_exact_over_the_horizon(total, warmup):
    tc = ttrain.TrainConfig(lr_kind="cosine", lr=3e-3, lr_total=total,
                            warmup=warmup)
    jtc = jtrain.TrainConfig(**dataclasses.asdict(tc))
    steps = jnp.arange(total + 3, dtype=jnp.int32)
    ref = np.asarray(jax.vmap(lambda s: jtrain.lr_at(jtc, s))(steps))
    ours = np.array([ttrain.lr_at(tc, s) for s in range(total + 3)],
                    np.float32)
    assert ref.dtype == np.float32
    bad = np.flatnonzero(ours.view(np.int32) != ref.view(np.int32))
    assert bad.size == 0, [(int(s), float(ours[s]), float(ref[s]))
                           for s in bad[:10]]


def test_init_state_ledger_and_err_rows():
    cfg, _ = _cfgs(layers=1)
    st = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                           ttrain.TrainConfig(mode="stale"), max_pos=32,
                           n_agents=3, device="cpu")
    p = sum(l.numel() for l in tree_flatten(st["params"])[0])
    assert tuple(st["ledger"]["g"].shape) == (3, p)
    assert st["ledger"]["ts"].tolist() == [-1, -1, -1]
    st = ttrain.init_state(torch.Generator().manual_seed(0), cfg,
                           ttrain.TrainConfig(mode="quantized"), max_pos=32,
                           n_agents=2, device="cpu")
    for e, q in zip(tree_flatten(st["err"])[0],
                    tree_flatten(st["params"])[0]):
        assert tuple(e.shape) == (2,) + tuple(q.shape)
    with pytest.raises(ValueError, match="unknown train mode"):
        ttrain.make_train_step(cfg, ttrain.TrainConfig(mode="nope"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-6b", "deepseek-v2-236b",
                                  "rwkv6-3b"])
def test_masked_weights_equal_subset_gradients(arch):
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = jmodel.init_model(jax.random.PRNGKey(3),
                               jax_config(arch).reduced(), max_pos=64)
    params = params_from_jax(jax.tree.map(np.asarray, params))
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 8)).astype(np.int32))
    tc = ttrain.TrainConfig(aux_coef=0.0, remat_policy="none")
    loss_fn = ttrain.make_loss_fn(cfg, tc, 1)
    w = torch.cat([torch.zeros(2, 8), torch.ones(2, 8)])
    _, g_masked = ttrain.value_and_grad(
        loss_fn, params, {"tokens": tok, "targets": tok, "weights": w})
    _, g_subset = ttrain.value_and_grad(
        loss_fn, params, {"tokens": tok[2:], "targets": tok[2:],
                          "weights": torch.ones(2, 8)})
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_flatten(g_masked)[0],
                               tree_flatten(g_subset)[0]))
    assert diff < 2e-5


@pytest.mark.parametrize("n,r,seed", [(4, 0, 0), (4, 1, 7), (8, 2, 2),
                                      (20, 3, 11)])
def test_straggler_oracle_matches_reference(n, r, seed):
    a = tloop.StragglerOracle(n, r, seed=seed)
    b = jloop.StragglerOracle(n, r, seed=seed)
    for i in range(12):
        if i == 5:
            obs = np.random.default_rng(i).random(n)
            a.observe(obs)
            b.observe(obs)
        ma, ra, fa = a.next_mask()
        mb, rb, fb = b.next_mask()
        np.testing.assert_array_equal(ma, mb)
        assert (ra, fa) == (rb, fb)


def _loop(tmpdir=None, r=2, steps_seed=0):
    cfg = get_config(ARCH).reduced()
    tokens = markov_tokens(20_000, vocab=cfg.vocab_size, seed=0)
    data = lm_batches(tokens, 8, 32, seed=1)
    tc = ttrain.TrainConfig(mode="masked", lr=3e-3, remat_policy="none")
    return tloop.TrainLoop(cfg, tc, data, n_agents=4, r=r,
                           oracle=tloop.StragglerOracle(4, r,
                                                        seed=steps_seed),
                           ckpt_dir=str(tmpdir) if tmpdir else None,
                           ckpt_every=10, max_pos=64, device="cpu")


def test_loop_loss_decreases_with_stragglers_dropped():
    hist = _loop(r=1).run(60)
    assert np.mean(hist.loss[-10:]) < np.mean(hist.loss[:10]) - 0.3
    assert hist.comm_saving > 0.0


def test_loop_r0_is_synchronous():
    hist = _loop(r=0).run(5)
    assert hist.round_time == hist.sync_round_time


def test_loop_restart_from_checkpoint_continues(tmp_path):
    loop = _loop(tmp_path, r=1)
    loop.run(20)
    step_a = int(loop.state["step"])
    loop2 = _loop(tmp_path, r=1)
    assert int(loop2.state["step"]) == step_a
    for a, b in zip(_leaves_np(loop.state), _leaves_np(loop2.state)):
        np.testing.assert_array_equal(a, b)
    hist = loop2.run(10)
    assert int(loop2.state["step"]) == step_a + 10
    assert np.isfinite(hist.loss).all()


def test_loop_comm_saving_grows_with_r():
    savings = [_loop(r=r, steps_seed=7).run(15).comm_saving
               for r in (0, 1, 2)]
    assert savings[0] == pytest.approx(0.0)
    assert savings[2] >= savings[1] >= -1e-9


def test_loop_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.TrainLoop(cfg, ttrain.TrainConfig(), iter(()), n_agents=2)
