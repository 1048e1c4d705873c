"""Port parity for the dense decoder stack: the layers (norm, RoPE and
M-RoPE, SwiGLU/GELU MLPs), the attention math, and ``apply_model``'s
train/prefill, dense-decode and paged-decode logits against ``repro`` on
JAX weights carried over with ``params_from_jax``, for the reduced
qwen2-0.5b, qwen2-1.5b, qwen1.5-4b and yi-6b (f32, within 1e-5); the
parameter count of the full configs; the init tree's shapes; and the
registry's refusal of model families not ported yet."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve.kv_cache import PagedCacheConfig as JCacheCfg
from repro.serve.kv_cache import PagedKVCache as JKV
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache

DENSE = ["qwen2-0.5b", "qwen2-1.5b", "qwen1.5-4b", "yi-6b"]
TOL = dict(rtol=1e-5, atol=1e-5)      # f32, reductions in another order

# the reference model, compiled once per config, mode and shape
jax_apply = jax.jit(jmodel.apply_model,
                    static_argnames=("cfg", "mode", "remat_policy"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    jcfg = jax_config(request.param).reduced()
    jp = jax.tree.map(np.asarray,
                      jmodel.init_model(jax.random.PRNGKey(0), jcfg,
                                        max_pos=64))
    return get_config(request.param).reduced(), jcfg, jp


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), norm=norm)
    jcfg = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), norm=norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    out = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    want = jlayers.apply_norm(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)


@pytest.mark.parametrize("mrope", [None, (16, 24, 24), (2, 3, 3), (1, 1)])
def test_apply_rope(mrope):
    rng = np.random.default_rng(1)
    d = 16
    x = rng.normal(size=(2, 6, 3, d)).astype(np.float32)
    if mrope is None:
        pos = rng.integers(0, 5000, size=(2, 6)).astype(np.int32)
    else:
        pos = rng.integers(0, 5000, size=(3, 2, 6)).astype(np.int32)
    out = tlayers.apply_rope(_t(x), _t(pos), 1e6, mrope)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope)
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5,
                               atol=1e-4)   # cos/sin of large angles


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act):
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), act=act)
    jcfg = dataclasses.replace(jax_config("yi-6b").reduced(), act=act)
    jp = jax.tree.map(np.asarray,
                      jlayers.init_mlp(jax.random.PRNGKey(2), jcfg))
    if act == "gelu":
        jp = {**jp, "b_in": np.full_like(jp["b_in"], 0.1),
              "b_out": np.full_like(jp["b_out"], -0.2)}
    x = np.random.default_rng(2).normal(size=(2, 4, 64)).astype(np.float32)
    out = tlayers.apply_mlp(tmodel.params_from_jax(jp), _t(x), cfg)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference(causal):
    rng = np.random.default_rng(3)
    q, k = (rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, 8, 2, 12)).astype(np.float32)
    out = tattn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                  chunk=4)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, chunk=4)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    plain = tattn.plain_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(out), _np(plain), **TOL)


# ---------------------------------------------------------------------------
# the model


def test_init_tree_matches_reference_shapes(arch):
    cfg, _, jp = arch
    tp = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu", max_pos=64)
    jleaves, jtree = jax.tree_util.tree_flatten_with_path(jp)
    tleaves, ttree = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tp))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    assert [a.shape for _, a in jleaves] == [a.shape for _, a in tleaves]
    # the reference's distributions: unit norms, zero biases, normal
    # weights with std 1/sqrt(d_in), embeddings with std 0.02
    blk = tp["blocks"][0]
    assert torch.all(blk["norm1"]["scale"] == 1)
    std = blk["mixer"]["wq"].std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(tp["embed"]["tok"].std().item() / 0.02 - 1) < 0.1
    if cfg.qkv_bias:
        assert torch.all(blk["mixer"]["bq"] == 0)


@pytest.mark.parametrize("name", DENSE)
def test_count_params_full_configs(name):
    assert get_config(name).param_count() == \
        jmodel.count_params(jax_config(name))


def test_train_and_prefill_logits(arch):
    cfg, jcfg, jp = arch
    tp = tmodel.params_from_jax(jp)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 11)) \
        .astype(np.int32)
    j_logits, _, j_cache = jax_apply(jp, jnp.asarray(tokens), jcfg,
                                     mode="prefill", remat_policy="none")
    t_logits, aux, t_cache = tmodel.apply_model(tp, _t(tokens), cfg,
                                                mode="prefill")
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(t_cache[0]["mixer"][name]),
                                   np.asarray(j_cache[0]["mixer"][name]),
                                   **TOL)
    train, _, none = tmodel.apply_model(tp, _t(tokens), cfg)
    assert none is None and float(aux) == 0.0
    np.testing.assert_allclose(_np(train), _np(t_logits), rtol=0, atol=0)
    targets = np.roll(tokens, -1, axis=1)
    w = np.ones(tokens.shape, np.float32)
    w[:, -1] = 0
    np.testing.assert_allclose(
        float(tmodel.lm_loss(t_logits, _t(targets), _t(w))),
        float(jmodel.lm_loss(j_logits, jnp.asarray(targets),
                             jnp.asarray(w))), rtol=1e-5)


@pytest.mark.parametrize("vector_index", [True, False])
def test_dense_decode_logits(arch, vector_index):
    cfg, jcfg, jp = arch
    tp = tmodel.params_from_jax(jp)
    rng = np.random.default_rng(5)
    b, t = 2, 12
    jc = jmodel.init_cache(jcfg, b, t)
    tc = tmodel.init_cache(cfg, b, t, device="cpu")
    lens = np.array([3, 7], np.int32) if vector_index else 5
    for step in range(3):
        tok = rng.integers(0, 256, (b, 1)).astype(np.int32)
        idx = lens + step
        j_logits, _, jc = jax_apply(
            jp, jnp.asarray(tok), jcfg, mode="decode", cache=jc,
            cache_index=jnp.asarray(idx), remat_policy="none")
        t_logits, _, tc = tmodel.apply_model(
            tp, _t(tok), cfg, mode="decode", cache=tc,
            cache_index=_t(np.asarray(idx, np.int32)))
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                                   **TOL)
    np.testing.assert_allclose(_np(tc[0]["mixer"]["k"]),
                               np.asarray(jc[0]["mixer"]["k"]), **TOL)


def test_paged_decode_logits(arch):
    """Prefill two prompts, admit them into both packages' paged caches
    (ragged lengths over 4-token pages), then decode three tokens through
    the page tables: logits and pools agree with the reference's."""
    cfg, jcfg, jp = arch
    tp = tmodel.params_from_jax(jp)
    rng = np.random.default_rng(6)
    jkv = JKV(jcfg, JCacheCfg(num_slots=3, page_size=4, num_pages=16,
                              max_pages_per_seq=5))
    tkv = PagedKVCache(cfg, PagedCacheConfig(num_slots=3, page_size=4,
                                             num_pages=16,
                                             max_pages_per_seq=5),
                       device="cpu")
    for slot, s0 in ((0, 6), (2, 9)):
        prompt = rng.integers(0, 256, (1, s0)).astype(np.int32)
        _, _, jc = jax_apply(jp, jnp.asarray(prompt), jcfg, mode="prefill",
                             remat_policy="none")
        _, _, tc = tmodel.apply_model(tp, _t(prompt), cfg, mode="prefill")
        jkv.admit(slot, jc, s0, s0 + 8)
        tkv.admit(slot, tc, s0, s0 + 8)
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    for _ in range(3):
        tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
        j_logits, _, jcache = jax_apply(
            jp, jnp.asarray(tok), jcfg, mode="decode", cache=jkv.cache,
            cache_index=jkv.kv_lens_dev, page_table=jkv.page_table_dev,
            remat_policy="none")
        jkv.update(jcache)
        t_logits, _, tcache = tmodel.apply_model(
            tp, _t(tok), cfg, mode="decode", cache=tkv.cache,
            cache_index=tkv.kv_lens_dev, page_table=tkv.page_table_dev)
        tkv.update(tcache)
        active = [0, 2]
        # the idle slot 1 attends the null page: only active rows compare
        np.testing.assert_allclose(_np(t_logits)[active],
                                   np.asarray(j_logits)[active], **TOL)
        jkv.commit_token(active)
        tkv.commit_token(active)
    np.testing.assert_array_equal(tkv.kv_lens, jkv.kv_lens)
    for name in ("k_pages", "v_pages"):
        for slot in (0, 2):
            np.testing.assert_allclose(
                _np(tkv.gather_dense(slot, 0, name)),
                np.asarray(jkv.gather_dense(slot, 0, name)), **TOL)


def test_registry_refuses_unported_families():
    assert list_configs() == sorted(DENSE)
    for name in ("deepseek-v2-236b", "rwkv6-3b", "jamba-v0.1-52b",
                 "whisper-base", "qwen2-vl-2b", "arctic-480b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            get_config(name)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    moe = dataclasses.replace(get_config("qwen2-0.5b"),
                              layer_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tmodel.init_model(None, moe, device="meta")
