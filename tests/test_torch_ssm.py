"""Port parity for the state-space mixers (``repro_torch.models.ssm``
against ``repro.models.ssm``), f32: the chunked linear scan (the port's
doubling scan sums in another order than ``lax.associative_scan``:
within 1e-4) and its chunk rule; Mamba train, prefill (with the conv
tail, also of a 1-token prompt) and one-token decode; RWKV-6's token
shift, sequential and chunked WKV scans, time mix (both forms) and
channel mix within 1e-4; the head-wise group norm within 1e-5; and the
f32 SSM leaves of a bf16 model carried over by ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.model import params_from_jax

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _cfgs(name, chunk=None):
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    if chunk is not None:
        cfg = dataclasses.replace(
            cfg, rwkv=dataclasses.replace(cfg.rwkv, chunk=chunk))
        jcfg = dataclasses.replace(
            jcfg, rwkv=dataclasses.replace(jcfg.rwkv, chunk=chunk))
    return cfg, jcfg


@pytest.mark.parametrize("s,chunk", [(1, 256), (7, 256), (12, 4),
                                     (256, 256), (512, 256), (40, 8)])
def test_chunked_linear_scan(s, chunk):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    hs, h = tssm.chunked_linear_scan(_t(a), _t(b), _t(h0), chunk)
    jhs, jh = jssm.chunked_linear_scan(*map(jnp.asarray, (a, b, h0)), chunk)
    np.testing.assert_allclose(_np(hs), np.asarray(jhs), **SCAN_TOL)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **SCAN_TOL)


def test_chunked_linear_scan_refuses_what_the_reference_refuses():
    a = np.ones((1, 300, 2), np.float32)
    with pytest.raises(AssertionError):
        jssm.chunked_linear_scan(jnp.asarray(a), jnp.asarray(a),
                                 jnp.zeros((1, 2)))
    with pytest.raises(ValueError, match="300"):
        tssm.chunked_linear_scan(_t(a), _t(a), torch.zeros(1, 2))


@pytest.fixture(scope="module")
def mamba():
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    jp = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(1),
                                                  jcfg))
    return cfg, jcfg, jp, params_from_jax(jp)


@pytest.mark.parametrize("s", [1, 5, 16])
def test_mamba_train_and_prefill(mamba, s):
    cfg, jcfg, jp, tp = mamba
    x = np.random.default_rng(2).normal(size=(2, s, 64)).astype(np.float32)
    out, cache = tssm.apply_mamba(tp, _t(x), cfg, return_cache=True)
    want, jcache = jssm.apply_mamba(jp, jnp.asarray(x), jcfg,
                                    return_cache=True)
    np.testing.assert_allclose(_np(out), np.asarray(want), **SCAN_TOL)
    for name in ("h", "conv"):
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(_np(cache[name]),
                                   np.asarray(jcache[name]), **SCAN_TOL)
    assert cache["conv"].shape[1] == min(s, 3)    # the conv tail's rows
    train, none = tssm.apply_mamba(tp, _t(x), cfg)
    assert none is None
    np.testing.assert_allclose(_np(train), _np(out), rtol=0, atol=0)


def test_mamba_decode_writes_the_cache_in_place(mamba):
    cfg, jcfg, jp, tp = mamba
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    _, jcache = jssm.apply_mamba(jp, jnp.asarray(x), jcfg, return_cache=True)
    _, cache = tssm.apply_mamba(tp, _t(x), cfg, return_cache=True)
    for step in range(4):
        tok = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, jcache = jssm.apply_mamba(jp, jnp.asarray(tok), jcfg,
                                        cache=jcache)
        h = cache["h"]
        out, new = tssm.apply_mamba(tp, _t(tok), cfg, cache=cache)
        assert new is cache and new["h"] is h
        np.testing.assert_allclose(_np(out), np.asarray(want), **SCAN_TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(_np(cache[name]),
                                       np.asarray(jcache[name]), **SCAN_TOL)


def test_token_shift():
    x = np.random.default_rng(4).normal(size=(2, 5, 8)).astype(np.float32)
    last = np.full((2, 8), 7.0, np.float32)
    for xs, lst in ((x, None), (x, last), (x[:, :1], None),
                    (x[:, :1], last)):
        got = tssm._token_shift(_t(xs), None if lst is None else _t(lst))
        want = jssm._token_shift(jnp.asarray(xs),
                                 None if lst is None else jnp.asarray(lst))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _wkv_inputs(s, seed=5, h=3, d=4):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(2, s, h, d)).astype(np.float32)
               for _ in range(3))
    # decays exp(-exp(z)) over (0.1, 1), and one strong decay: far
    # smaller ones overflow the chunked form's split factors in both
    # packages, and a zero decay hits its 1e-38 clamp, a subnormal that
    # XLA's CPU flushes to 0 and torch keeps
    w = np.exp(-np.exp(rng.normal(-2, 1, size=(2, s, h, d)))).clip(
        0.1, 1).astype(np.float32)
    w[0, 0, 0, 0] = 1e-3
    u = rng.normal(size=(h, d)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(2, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("s", [1, 9])
def test_wkv_scan(s):
    args = _wkv_inputs(s)
    y, st = tssm._wkv_scan(*map(_t, args))
    jy, jst = jssm._wkv_scan(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(_np(st), np.asarray(jst), **SCAN_TOL)


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 8), (8, 32), (24, 8)])
def test_wkv_chunked(s, chunk):
    args = _wkv_inputs(s, seed=s + chunk)
    y, st = tssm._wkv_chunked(*map(_t, args), chunk=chunk)
    jy, jst = jssm._wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(_np(st), np.asarray(jst), **SCAN_TOL)
    seq, sst = tssm._wkv_scan(*map(_t, args))     # the same recurrence
    np.testing.assert_allclose(_np(y), _np(seq), **SCAN_TOL)
    np.testing.assert_allclose(_np(st), _np(sst), **SCAN_TOL)


def test_group_norm():
    x = np.random.default_rng(6).normal(size=(2, 5, 3, 16)).astype(
        np.float32) * 4 + 1
    np.testing.assert_allclose(
        _np(tlayers.apply_group_norm(_t(x))),
        np.asarray(jlayers.apply_group_norm(jnp.asarray(x), 3)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [0, 4])
def test_rwkv_time_and_channel_mix(chunk):
    """Prefill 8 tokens (chunk 4 takes the chunked form), then decode
    three, each call's state written into the cache in place."""
    cfg, jcfg = _cfgs("rwkv6-3b", chunk)
    jt = jax.tree.map(np.asarray, jssm.init_rwkv(jax.random.PRNGKey(7),
                                                 jcfg))
    jc = jax.tree.map(np.asarray, jssm.init_rwkv_channel(
        jax.random.PRNGKey(8), jcfg))
    tt, tc = params_from_jax(jt), params_from_jax(jc)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    caches = []
    for fn_t, fn_j, tp, jp in ((tssm.apply_rwkv_time, jssm.apply_rwkv_time,
                                tt, jt),
                               (tssm.apply_rwkv_channel,
                                jssm.apply_rwkv_channel, tc, jc)):
        out, cache = fn_t(tp, _t(x), cfg, return_cache=True)
        want, jcache = fn_j(jp, jnp.asarray(x), jcfg, return_cache=True)
        np.testing.assert_allclose(_np(out), np.asarray(want), **SCAN_TOL)
        caches.append((fn_t, fn_j, tp, jp, cache, jcache))
    for _ in range(3):
        tok = rng.normal(size=(2, 1, 64)).astype(np.float32)
        for i, (fn_t, fn_j, tp, jp, cache, jcache) in enumerate(caches):
            out, new = fn_t(tp, _t(tok), cfg, cache=cache)
            want, jcache = fn_j(jp, jnp.asarray(tok), jcfg, cache=jcache)
            assert new is cache
            np.testing.assert_allclose(_np(out), np.asarray(want),
                                       **SCAN_TOL)
            for name in jcache:
                np.testing.assert_allclose(_np(cache[name]),
                                           np.asarray(jcache[name]),
                                           **SCAN_TOL)
            caches[i] = (fn_t, fn_j, tp, jp, cache, jcache)


@pytest.mark.parametrize("name,init", [("jamba-v0.1-52b", "init_mamba"),
                                       ("rwkv6-3b", "init_rwkv")])
def test_f32_leaves_survive_in_a_bf16_model(name, init):
    cfg, jcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                 for c in _cfgs(name))
    jp = getattr(jssm, init)(jax.random.PRNGKey(0), jcfg)
    tp = getattr(tssm, init)(torch.Generator().manual_seed(0), cfg, "cpu")
    carried = params_from_jax(jax.tree.map(np.asarray, jp))
    assert sorted(tp) == sorted(jp)
    for k, leaf in jp.items():
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert tp[k].dtype == carried[k].dtype == want, k
        assert tuple(tp[k].shape) == leaf.shape, k
    f32 = {k for k, v in jp.items() if v.dtype == jnp.float32}
    assert f32 == ({"dt_b", "a_log", "d"} if init == "init_mamba"
                   else {"w0", "u"})
