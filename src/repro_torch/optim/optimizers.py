"""Optimizers over trees of tensors (counterpart of
``repro.optim.optimizers``).

State mirrors the parameter tree leaf for leaf. The arithmetic is the
reference's: AdamW keeps its moments in ``moment_dtype`` (f32 by
default) and computes every update in f32, ``apply_updates`` subtracts
in f32 and casts back to the parameter's dtype, and
``clip_by_global_norm`` scales in f32 before the cast, so a bf16 leaf
sees one rounding, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.ledger import tree_flatten, tree_map, tree_unflatten

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], tuple]
    # update(grads, opt_state, params, step) -> (updates, new_opt_state)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        del params, step
        if momentum == 0.0:
            return grads, state
        m = tree_map(lambda m, g: momentum * m + g, state["m"], grads)
        upd = (tree_map(lambda m, g: momentum * m + g, m, grads)
               if nesterov else m)
        return upd, {"m": m}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype: str = "float32"
          ) -> Optimizer:
    mdt = _DTYPES[moment_dtype]

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        c1 = float(1.0 - b1 ** t)
        c2 = float(1.0 - b2 ** t)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m32 = m.to(torch.float32) * b1 + (1 - b1) * gf
            v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(gf)
            u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return u.to(g.dtype), m32.to(mdt), v32.to(mdt)

        gl, spec = tree_flatten(grads)
        res = [upd(g, m, v, p) for g, m, v, p in zip(
            gl, tree_flatten(state["m"])[0], tree_flatten(state["v"])[0],
            tree_flatten(params)[0])]
        return (tree_unflatten(spec, [r[0] for r in res]),
                {"m": tree_unflatten(spec, [r[1] for r in res]),
                 "v": tree_unflatten(spec, [r[2] for r in res])})

    return Optimizer(init, update)


def apply_updates(params, updates, lr):
    """p - lr * u in f32, cast back to p's dtype (``lr`` an f32 value)."""
    lr = float(lr)
    return tree_map(lambda p, u: (p.to(torch.float32)
                                  - lr * u.to(torch.float32)).to(p.dtype),
                    params, updates)


# ---------------------------------------------------------------------------
# global-norm clipping (used by the LM training loop)


def clip_to_norm(grads, max_norm: float, norm):
    """``grads`` scaled so that a global norm ``norm`` becomes at most
    ``max_norm`` (each leaf in f32, cast back to its dtype)."""
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads)


def clip_by_global_norm(grads, max_norm: float):
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_flatten(grads)[0])
    norm = torch.sqrt(sq)
    return clip_to_norm(grads, max_norm, norm), norm
