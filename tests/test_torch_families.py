"""Port parity for the model families beyond the dense decoders:
``apply_model`` of the reduced arctic-480b (MoE with a dense residual),
deepseek-v2-236b (MLA + MoE with a shared expert), jamba-v0.1-52b
(Mamba/attention hybrid with MoE every other layer), rwkv6-3b (RWKV-6),
qwen2-vl-2b (M-RoPE) and whisper-base (encoder-decoder) against
``repro`` on JAX weights carried over with ``params_from_jax``, f32:
train and prefill logits, aux loss and prefill caches; dense decode with
a scalar and a per-row index; paged decode through both packages' page
tables (whisper: both refuse to page). The init tree (paths, shapes,
dtypes of a bf16 model) and ``count_params`` of every registered config,
total and active, equal the reference's.

Tolerances: 1e-5 (rtol and atol) for the attention families
(arctic, deepseek-v2, qwen2-vl, whisper): matmuls and softmaxes summed
in another order. 1e-4 for the recurrent ones (jamba, rwkv6): the Mamba
scan's doubling order against ``lax.associative_scan`` and the f32 state
carried across decode steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as jmodel
from repro.serve.kv_cache import PagedCacheConfig as JCacheCfg
from repro.serve.kv_cache import PagedKVCache as JKV
from repro_torch.configs.registry import get_config
from repro_torch.models import model as tmodel
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache

FAMILIES = ["arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b",
            "rwkv6-3b", "qwen2-vl-2b", "whisper-base"]
RECURRENT = {"jamba-v0.1-52b", "rwkv6-3b"}

jax_apply = jax.jit(jmodel.apply_model,
                    static_argnames=("cfg", "mode", "remat_policy"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(a, b, name):
    tol = 1e-4 if name in RECURRENT else 1e-5
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tree))[0]


@pytest.fixture(scope="module", params=FAMILIES)
def arch(request):
    name = request.param
    jcfg = jax_config(name).reduced()
    jp = jax.tree.map(np.asarray,
                      jmodel.init_model(jax.random.PRNGKey(0), jcfg,
                                        max_pos=64))
    return name, get_config(name).reduced(), jcfg, jp


def _enc(cfg, b=2, seed=11):
    """Frame embeddings for an encoder-decoder arch, else None."""
    if not cfg.encoder_decoder:
        return None
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _prefill(name, cfg, jcfg, jp, tp, tokens):
    enc = _enc(cfg, tokens.shape[0])
    jkw = {} if enc is None else {"enc_embed": jnp.asarray(enc)}
    tkw = {} if enc is None else {"enc_embed": _t(enc)}
    j = jax_apply(jp, jnp.asarray(tokens), jcfg, mode="prefill",
                  remat_policy="none", **jkw)
    t = tmodel.apply_model(tp, _t(tokens), cfg, mode="prefill", **tkw)
    return t, j, tkw


def test_init_tree_matches_reference(arch):
    """Paths and shapes of the reduced f32 tree, and of the bf16 tree
    (the port on the meta device) with each leaf's dtype: the router and
    the SSM leaves stay f32."""
    name, cfg, jcfg, jp = arch
    tp = tmodel.init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu", max_pos=64)
    jl, tl = _leaves(jp), _leaves(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert [a.shape for _, a in jl] == [a.shape for _, a in tl]
    jb = jax.eval_shape(lambda: jmodel.init_model(
        jax.random.PRNGKey(0),
        dataclasses.replace(jcfg, param_dtype="bfloat16"), max_pos=64))
    tb = tmodel.init_model(None, dataclasses.replace(
        cfg, param_dtype="bfloat16"), device="meta", max_pos=64)
    jbl = jax.tree_util.tree_flatten_with_path(jb)[0]
    tbl = jax.tree_util.tree_flatten_with_path(
        tb, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [str(j.dtype) for _, j in jbl] == \
        [str(t.dtype)[6:] for _, t in tbl]
    assert len(tp["blocks"]) == cfg.period


@pytest.mark.parametrize("name", sorted(set(FAMILIES) | {
    "qwen2-0.5b", "qwen2-1.5b", "qwen1.5-4b", "yi-6b"}))
def test_count_params_full_configs(name):
    for active in (False, True):
        assert tmodel.count_params(get_config(name), active_only=active) \
            == jmodel.count_params(jax_config(name), active_only=active)


def test_train_and_prefill_logits(arch):
    name, cfg, jcfg, jp = arch
    tp = tmodel.params_from_jax(jp)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 8)).astype(
        np.int32)
    (t_logits, t_aux, t_cache), (j_logits, j_aux, j_cache), tkw = \
        _prefill(name, cfg, jcfg, jp, tp, tokens)
    _close(t_logits, j_logits, name)
    _close(t_aux, j_aux, name)
    assert (float(j_aux) > 0) == (cfg.moe is not None)
    jl, tl = _leaves(j_cache), _leaves(t_cache)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, _), a, b in zip(jl, jax.tree.leaves(t_cache),
                               jax.tree.leaves(j_cache)):
        assert tuple(a.shape) == b.shape, path
        _close(a, b, name)
    train, aux, none = tmodel.apply_model(tp, _t(tokens), cfg, **tkw)
    assert none is None
    np.testing.assert_array_equal(_np(train), _np(t_logits))
    assert float(aux) == float(t_aux)


def _pad_attention(cache, cfg, jcfg, t):
    """Grow the attention leaves of a prefill cache (sequence axis 2) to
    t positions with zeros; recurrent and cross leaves stay."""
    def pad(leaf, path):
        keys = [getattr(k, "key", None) for k in path]
        if "cross" in keys or keys[-1] not in ("k", "v", "ckv", "kr"):
            return leaf
        width = [(0, 0)] * leaf.ndim
        width[2] = (0, t - leaf.shape[2])
        return np.pad(np.asarray(leaf, np.float32), width)
    return jax.tree_util.tree_map_with_path(lambda p, l: pad(l, p), cache)


@pytest.mark.parametrize("vector_index", [True, False])
def test_dense_decode_logits(arch, vector_index):
    """Prefill 6 tokens (vector index: from an empty cache at ragged
    lengths instead), then decode three through the dense cache."""
    name, cfg, jcfg, jp = arch
    tp = tmodel.params_from_jax(jp)
    rng = np.random.default_rng(5)
    b, t = 2, 12
    if vector_index:
        jc = jmodel.init_cache(jcfg, b, t)
        tc = tmodel.init_cache(cfg, b, t, device="cpu")
        lens = np.array([3, 7], np.int32)
    else:
        prompt = rng.integers(0, 256, (b, 6)).astype(np.int32)
        (_, _, tcache), (_, _, jcache), _ = _prefill(name, cfg, jcfg, jp, tp,
                                                     prompt)
        jc = jax.tree.map(jnp.asarray, _pad_attention(jcache, cfg, jcfg, t))
        tc = tuple(tmodel.params_from_jax(
            _pad_attention(jax.tree.map(np.asarray, tcache), cfg, jcfg, t)))
        lens = 6
    for step in range(3):
        tok = rng.integers(0, 256, (b, 1)).astype(np.int32)
        idx = lens + step
        j_logits, _, jc = jax_apply(
            jp, jnp.asarray(tok), jcfg, mode="decode", cache=jc,
            cache_index=jnp.asarray(idx), remat_policy="none")
        t_logits, _, tc2 = tmodel.apply_model(
            tp, _t(tok), cfg, mode="decode", cache=tc,
            cache_index=_t(np.asarray(idx, np.int32)))
        assert tc2 is tc                          # written in place
        _close(t_logits, j_logits, name)
    for a, b_ in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        _close(a, b_, name)


def test_paged_decode_logits(arch):
    """Prefill two prompts, admit them into both packages' paged caches
    (ragged lengths over 4-token pages; recurrent state into slot rows),
    then decode three tokens through the page tables."""
    name, cfg, jcfg, jp = arch
    ccfg = dict(num_slots=3, page_size=4, num_pages=16, max_pages_per_seq=5)
    if cfg.encoder_decoder:
        for make in (lambda: JKV(jcfg, JCacheCfg(**ccfg)),
                     lambda: PagedKVCache(cfg, PagedCacheConfig(**ccfg),
                                          device="cpu")):
            with pytest.raises(NotImplementedError, match="decoder-only"):
                make()
        return
    tp = tmodel.params_from_jax(jp)
    rng = np.random.default_rng(6)
    jkv = JKV(jcfg, JCacheCfg(**ccfg))
    tkv = PagedKVCache(cfg, PagedCacheConfig(**ccfg), device="cpu")
    assert _leaves(jkv.cache) and [p for p, _ in _leaves(jkv.cache)] == \
        [p for p, _ in _leaves(tkv.cache)]
    for slot, s0 in ((0, 6), (2, 9)):
        prompt = rng.integers(0, 256, (1, s0)).astype(np.int32)
        (_, _, tc), (_, _, jc), _ = _prefill(name, cfg, jcfg, jp, tp, prompt)
        jkv.admit(slot, jc, s0, s0 + 8)
        tkv.admit(slot, tc, s0, s0 + 8)
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    active = [0, 2]
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
        # the idle slot 1 attends the null page: only active rows compare
        _close(_np(t_logits)[active], np.asarray(j_logits)[active], name)
        jkv.commit_token(active)
        tkv.commit_token(active)
    np.testing.assert_array_equal(tkv.kv_lens, jkv.kv_lens)
    for pos, kind in enumerate(cfg.layer_pattern):
        for part, leaves in jkv.cache[pos].items():
            for leaf_name, leaf in leaves.items():
                if kind == "attn":
                    for slot in active:
                        _close(tkv.gather_dense(slot, pos, leaf_name),
                               jkv.gather_dense(slot, pos, leaf_name), name)
                else:
                    _close(tkv.cache[pos][part][leaf_name][:, active],
                           np.asarray(leaf)[:, active], name)
