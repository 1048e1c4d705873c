"""Port parity for ``repro_torch.optim.optimizers``: ``sgd`` (plain,
momentum, nesterov), ``adamw`` (with and without weight decay, f32 and
bf16 moments), ``apply_updates`` and ``clip_by_global_norm`` against
``repro.optim.optimizers`` over several steps on seeded trees, within
rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.core.ledger import tree_flatten
from repro_torch.optim import optimizers as topt

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "blocks": ({"a": (rng.normal(size=(3, 4)) * scale
                              ).astype(np.float32)},
                       {"a": (rng.normal(size=(3, 4)) * scale
                              ).astype(np.float32)}),
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_to_torch(v) for v in t)
    return torch.from_numpy(np.array(t))


def _to_jax(t):
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_to_jax(v) for v in t)
    return jnp.asarray(t)


def _assert_tree_close(t, j, **tol):
    tl = tree_flatten(t)[0]
    jl = tree_flatten(_to_torch(_np(j)))[0]
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **tol)


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_np(v) for v in t)
    return np.asarray(t, np.float32)


OPTS = [("sgd", dict()), ("sgd", dict(momentum=0.9)),
        ("sgd", dict(momentum=0.9, nesterov=True)),
        ("adamw", dict()), ("adamw", dict(weight_decay=0.1)),
        ("adamw", dict(b1=0.8, b2=0.99, eps=1e-6))]


@pytest.mark.parametrize("name,kw", OPTS, ids=lambda v: str(v))
def test_optimizer_steps_match_reference(name, kw):
    params = _tree(0)
    tp, jp = _to_torch(params), _to_jax(params)
    topt_ = getattr(topt, name)(**kw)
    jopt_ = getattr(jopt, name)(**kw)
    ts, js = topt_.init(tp), jopt_.init(jp)
    for step in range(5):
        g = _tree(10 + step, scale=0.3)
        tu, ts = topt_.update(_to_torch(g), ts, tp, step)
        ju, js = jopt_.update(_to_jax(g), js, jp, jnp.asarray(step,
                                                              jnp.int32))
        _assert_tree_close(tu, ju, **TOL)
        tp = topt.apply_updates(tp, tu, 0.05)
        jp = jopt.apply_updates(jp, ju, jnp.float32(0.05))
        _assert_tree_close(tp, jp, **TOL)
    if name == "adamw":
        _assert_tree_close(ts["m"], js["m"], **TOL)
        _assert_tree_close(ts["v"], js["v"], **TOL)


def test_adamw_bf16_moments_keep_their_dtype():
    params = _tree(1)
    tp = _to_torch(params)
    opt = topt.adamw(moment_dtype="bfloat16")
    st = opt.init(tp)
    assert all(m.dtype == torch.bfloat16 for m in tree_flatten(st["m"])[0])
    upd, st = opt.update(_to_torch(_tree(2)), st, tp, 0)
    assert all(u.dtype == torch.float32 for u in tree_flatten(upd)[0])
    assert all(v.dtype == torch.bfloat16 for v in tree_flatten(st["v"])[0])


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    tc, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    jc, jn = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_tree_close(tc, jc, **TOL)


def test_apply_updates_bf16_params_cast_back():
    """f32 arithmetic, one rounding into the parameter's bf16."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=(64,)).astype(np.float32)
    u = rng.normal(size=(64,)).astype(np.float32)
    tp = torch.from_numpy(p).bfloat16()
    out = topt.apply_updates({"p": tp}, {"p": torch.from_numpy(u)}, 0.01)
    jout = jopt.apply_updates({"p": jnp.asarray(p, jnp.bfloat16)},
                              {"p": jnp.asarray(u)}, jnp.float32(0.01))
    assert out["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["p"].float().numpy(),
                                  np.asarray(jout["p"], np.float32))
