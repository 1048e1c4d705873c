"""Port parity for ``repro_torch.launch.serve`` against live
``repro.launch.serve``, reduced configs in f32 on the CPU on JAX weights
(``params_from_jax``):

- ``greedy_generate``'s tokens equal the reference's for dense
  (qwen2-0.5b), MoE (arctic-480b) and rwkv6-3b, at superstep_k 8 and 1,
  and the ``max_len`` check raises in both packages;
- ``make_prefill_step`` and ``make_decode_step``'s next tokens equal the
  reference's and their caches agree within 1e-5 (rtol and atol; 1e-4
  for rwkv6's f32 state, as in test_torch_families.py), with and without
  an activation policy; under a policy the tokens equal the policy-free
  call's bit for bit (constraints change nothing in the port). The
  reference runs under its policy with ``with_sharding_constraint`` an
  identity, there being no mesh."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

ARCHS = ["qwen2-0.5b", "arctic-480b", "rwkv6-3b"]
POLICY = dict(dp="data", tp="model", sizes={"data": 2, "model": 2})


def _tol(name):
    t = 1e-4 if name == "rwkv6-3b" else 1e-5
    return dict(rtol=t, atol=t)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg = dataclasses.replace(jax_config(name).reduced(), n_layers=2)
    cfg = dataclasses.replace(get_config(name).reduced(), n_layers=2)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg, max_pos=64)
    return name, cfg, jcfg, jp, tmodel.params_from_jax(
        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("k", [8, 1])
def test_greedy_generate_matches_reference(arch, k):
    name, cfg, jcfg, jp, tp = arch
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 7)).astype(np.int32)
    ref = jserve.greedy_generate(jp, jcfg, jnp.asarray(prompt), max_len=32,
                                 steps=6, superstep_k=k)
    out = tserve.greedy_generate(tp, cfg, prompt, max_len=32, steps=6,
                                 superstep_k=k, device="cpu")
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 13)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out[:, :7].numpy(), prompt)


def test_greedy_generate_max_len_check(arch):
    name, cfg, jcfg, jp, tp = arch
    prompt = np.zeros((2, 10), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        jserve.greedy_generate(jp, jcfg, jnp.asarray(prompt), max_len=12,
                               steps=3)
    with pytest.raises(ValueError, match="max_len"):
        tserve.greedy_generate(tp, cfg, prompt, max_len=12, steps=3,
                               device="cpu")


@pytest.mark.parametrize("policy", [False, True])
def test_prefill_and_decode_steps_match_reference(arch, policy,
                                                  monkeypatch):
    name, cfg, jcfg, jp, tp = arch
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: x)
    kw = POLICY if policy else {}
    rng = np.random.default_rng(5)
    b, s, t = 2, 6, 12
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jtok, jcache = jserve.make_prefill_step(jcfg, **kw)(
        jp, {"tokens": jnp.asarray(tokens)})
    ttok, tcache = tserve.make_prefill_step(cfg, **kw)(
        tp, {"tokens": torch.from_numpy(tokens)})
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for a, c in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **_tol(name))
    if policy:
        plain, _ = tserve.make_prefill_step(cfg)(
            tp, {"tokens": torch.from_numpy(tokens)})
        assert torch.equal(plain, ttok)

    # decode three tokens through dense caches grown to t positions
    jc = jmodel.init_cache(jcfg, b, t)
    tc = tmodel.init_cache(cfg, b, t, device="cpu")
    jdec = jserve.make_decode_step(jcfg, **kw)
    tdec = tserve.make_decode_step(cfg, **kw)
    jnext, tnext = jtok[:, None], ttok[:, None]
    for i in range(3):
        jnext, jc = jdec(jp, {"tokens": jnext, "cache": jc,
                              "pos": jnp.asarray(i, jnp.int32)})
        tnext, tc2 = tdec(tp, {"tokens": tnext, "cache": tc,
                               "pos": torch.tensor(i, dtype=torch.int32)})
        assert tc2 is tc                          # written in place
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        jnext, tnext = jnext[:, None], tnext[:, None]
    for a, c in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **_tol(name))
