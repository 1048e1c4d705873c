"""Plain PyTorch reference of Algorithm 1's masked step with global-norm
clipping and the SGD update.

Each step the agents of S^t are all but the r slowest of that step's
per-agent times; the loss is the mean token cross-entropy over their rows
alone (the masked agents' rows carry no weight); the gradient is clipped
to a global norm of at most ``clip``; the update is x - lr * g, computed
in float32 and stored in the parameters' dtype (bfloat16, as the
configuration states). Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from reference.model import Matmul, lm_loss


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(v, it) for v in tree)
    return next(it)


def sgd_step(params, tokens, targets, config: Dict, lr: float, clip: float,
             mm: Matmul, split=None):
    """One step on the kept rows ``tokens``/``targets`` (rows, seq),
    updating ``params`` in place. Returns (loss, each leaf's clipped
    gradient norm: a vector over the leading axis where ``split`` marks
    the leaf, else a scalar)."""
    orig = _flat(params)
    split = split or [False] * len(orig)
    leaves = [p.detach().requires_grad_(True) for p in orig]
    with torch.enable_grad():
        loss = lm_loss(_rebuild(params, iter(leaves)), tokens, targets,
                       config, mm)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    del leaves
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads
                          if g is not None))
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    norms = []
    for i, (p, cut) in enumerate(zip(orig, split)):
        g = grads[i]
        grads[i] = None
        if g is None:
            g = torch.zeros_like(p)
        g = g.float().mul_(scale)
        norms.append(g.flatten(1).norm(dim=1) if cut else g.norm())
        p.copy_((p.float() - lr * g).to(p.dtype))
        del g
    return float(loss.detach()), norms


def run_steps(params, steps: List, config: Dict, lr: float, clip: float,
              mm: Matmul, on_step=None, split=None):
    """``steps``: per step (kept tokens, kept targets); ``params`` is
    updated in place. ``on_step(t, loss, norms)`` sees each step's
    result (t 1-based)."""
    for t, (x, y) in enumerate(steps, 1):
        loss, norms = sgd_step(params, x, y, config, lr, clip, mm, split)
        if on_step is not None:
            on_step(t, loss, norms)
    return params
