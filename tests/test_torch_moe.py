"""Port parity for the mixture-of-experts layer (``repro_torch.models.moe``
against ``repro.models.moe``): the capacity, the dispatch maps as
integers (random routes, tied scores, a capacity overflow), the router's
top-k order on tied scores, ``apply_moe``'s output and aux loss in f32
within 1e-5 (reductions in another order) with one and two dispatch
groups, shared experts and arctic's dense residual, and the init tree's
shapes and dtypes (f32 router inside a bf16 model) carried over by
``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.model import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)      # f32, reductions in another order
MOE_ARCHS = ["arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b"]


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("tokens", [1, 4, 9, 64, 1000])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_capacity_matches_reference(name, tokens):
    for cfg, jcfg in ((get_config(name), jax_config(name)),
                      (get_config(name).reduced(),
                       jax_config(name).reduced())):
        assert tmoe._capacity(tokens, cfg.moe) == \
            jmoe._capacity(tokens, jcfg.moe)
        # drop-free serving: capacity_factor = E / top_k covers every token
        free = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
        assert tmoe._capacity(tokens, free) >= tokens


def _routes(kind, t=12, k=2, e=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        top_i = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    elif kind == "overflow":                  # every token on experts 1, 2
        top_i = np.tile(np.array([1, 2]), (t, 1))
    else:                                     # "skewed": expert 3 popular
        top_i = np.stack([[3, rng.integers(0, 3)] for _ in range(t)])
    top_w = rng.random((t, k)).astype(np.float32)
    return top_i.astype(np.int32), top_w


@pytest.mark.parametrize("kind,c", [("random", 4), ("random", 8),
                                    ("overflow", 5), ("skewed", 4),
                                    ("skewed", 13)])
def test_dispatch_indices_match_reference(kind, c):
    top_i, top_w = _routes(kind)
    want = jmoe._dispatch_indices(jnp.asarray(top_i), jnp.asarray(top_w),
                                  4, c)
    got = tmoe._dispatch_indices(torch.from_numpy(top_i),
                                 torch.from_numpy(top_w), 4, c)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # each choice's slot: its (expert, rank) where kept, e*c where dropped
    slot = _np(got[3])
    kept = slot < 4 * c
    if kind == "overflow":
        assert (~kept).sum() == 2 * (12 - c)
    tm = _np(got[0]).reshape(-1)
    np.testing.assert_array_equal(tm[slot[kept]],
                                  np.nonzero(kept)[0].astype(np.int32))


def test_router_top_k_breaks_ties_like_reference():
    """Tied router scores (duplicate router columns) pick the lower
    expert id first, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(1)
    router = rng.normal(size=(16, 3)).astype(np.float32)
    router = np.concatenate([router, router[:, :1], router[:, 1:2],
                             router[:, :1]], axis=1)   # experts 3, 4, 5 tie
    x = rng.normal(size=(10, 16)).astype(np.float32)
    for k in (1, 2, 3, 4):
        probs, top_w, top_i = tmoe._route(torch.from_numpy(router),
                                          torch.from_numpy(x), k)
        jp = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
        jw, ji = jax.lax.top_k(jp, k)
        np.testing.assert_array_equal(_np(top_i), np.asarray(ji))
        jw = jw / jnp.maximum(jnp.sum(jw, -1, keepdims=True), 1e-9)
        np.testing.assert_allclose(_np(top_w), np.asarray(jw), **TOL)
        np.testing.assert_allclose(_np(probs), np.asarray(jp), **TOL)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_apply_moe_matches_reference(name, n_groups):
    """deepseek-v2 carries a shared expert, arctic its dense residual;
    capacity 1.25 over 4 experts drops tokens in the 2-group case."""
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg,
                                                jcfg.moe))
    x = np.random.default_rng(4).normal(size=(2, 9, 64)).astype(np.float32)
    out, aux = tmoe.apply_moe(params_from_jax(jp), torch.from_numpy(x), cfg,
                              cfg.moe, n_groups=n_groups)
    want, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, jcfg.moe,
                                n_groups=n_groups)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert ("shared" in jp) == bool(cfg.moe.num_shared_experts)
    assert ("dense" in jp) == cfg.moe.dense_residual


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_init_moe_tree_and_dtypes(name):
    cfg = dataclasses.replace(get_config(name).reduced(),
                              param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_config(name).reduced(),
                               param_dtype="bfloat16")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jcfg.moe)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.moe,
                       "cpu")
    carried = params_from_jax(jax.tree.map(np.asarray, jp))
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    for tree in (tp, carried):
        tl = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: np.zeros(t.shape), tree))[0]
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, j), (_, t) in zip(jl, tl):
            assert j.shape == t.shape, path
    for tree in (tp, carried):
        assert tree["router"].dtype == torch.float32
        assert tree["w_gate"].dtype == torch.bfloat16
        assert tree["w_gate"].dim() == 3
    std = tp["w_up"].float().std().item() * cfg.d_model ** 0.5
    assert abs(std - 1) < 0.1
