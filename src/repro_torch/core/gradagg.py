"""Gradient aggregation rules (GradAgg, paper eq. (10)) on torch tensors.

All rules operate on a stack of per-agent gradients ``g: (n, d)`` plus a
boolean ``received`` mask encoding S^t (|S^t| = n - r in Algorithm 1).
They run op by op on whatever device ``g`` lives on; ``tree_agg`` lifts
any rule to nested dicts/lists of tensors.

Rules
-----
- ``agg_sum``           Algorithm 1, eq. (3):  sum over S^t.
- ``agg_mean``          sum / |S^t| (the LR-rescaled variant used by D-SGD).
- ``agg_cge``           CGE gradient filter (paper eq. (18)): sum of the
                        m - f smallest-norm received gradients.
- ``agg_trimmed_mean``  coordinate-wise trimmed mean (Yin et al. [55]).
- ``agg_quantized``     int8 symmetric per-agent quantization + sum.

Each rule is registered as an ``AggregationRule`` in
``repro_torch.dist.registry``; ``make_gradagg`` resolves through it.
"""
from __future__ import annotations

from typing import Callable

import torch

BIG = 1e30


def agg_sum(g: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    return torch.sum(g * received[:, None].to(g.dtype), dim=0)


def agg_mean(g: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    s = agg_sum(g, received)
    return s / torch.clamp(torch.sum(received.to(g.dtype)), min=1.0)


def cge_mask_from_norms(norms: torch.Tensor, received: torch.Tensor,
                        f: int) -> torch.Tensor:
    """CGE keep-set from precomputed per-agent gradient norms (n,):
    stable rank of the received-masked norms (ties by agent id), keep the
    m - f smallest."""
    n = norms.shape[0]
    norms = torch.where(received, norms, BIG)
    order = torch.argsort(norms, stable=True)        # received first, by norm
    keep_k = torch.sum(received.to(torch.int64)) - f
    rank = torch.empty(n, dtype=torch.int64, device=norms.device)
    rank[order] = torch.arange(n, device=norms.device)
    return (rank < keep_k) & received


def cge_mask(g: torch.Tensor, received: torch.Tensor, f: int) -> torch.Tensor:
    """Boolean mask selecting the m-f smallest-norm received gradients,
    where m = |received|. Non-received agents are never selected."""
    norms = torch.linalg.vector_norm(g.to(torch.float32), dim=1)
    return cge_mask_from_norms(norms, received, f)


def agg_cge(g: torch.Tensor, received: torch.Tensor, f: int) -> torch.Tensor:
    return agg_sum(g, cge_mask(g, received, f))


def agg_trimmed_mean(g: torch.Tensor, received: torch.Tensor,
                     f: int) -> torch.Tensor:
    """Coordinate-wise: drop the f largest and f smallest received values
    per coordinate, average the rest. Non-received values excluded."""
    m = torch.sum(received.to(torch.int64))
    lo = torch.where(received[:, None], g, BIG)
    srt_lo = torch.sort(lo, dim=0).values            # received ascending
    ranks = torch.arange(g.shape[0], device=g.device)[:, None]
    keep = (ranks >= f) & (ranks < m - f)            # trim f per side
    total = torch.sum(torch.where(keep, srt_lo, 0.0), dim=0)
    cnt = torch.clamp(m - 2 * f, min=1)
    return total / cnt.to(g.dtype)


def quantize_int8_parts(x: torch.Tensor):
    """The wire form of :func:`quantize_int8`: symmetric int8 payload +
    one f32 scale per leading row. ``q`` values are integral in
    [-127, 127], so the int8 cast is exact and dequantization from the
    parts is bit-identical to the fused form below. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor):
    """Symmetric int8 quantization with one scale per leading row.
    Returns (dequantized, residual)."""
    q, scale = quantize_int8_parts(x)
    deq = q.to(x.dtype) * scale
    return deq, x - deq


def agg_quantized(g: torch.Tensor, received: torch.Tensor) -> torch.Tensor:
    """Stateless reference of the int8 error-feedback collective: quantize
    each agent's (whole) gradient with a per-agent scale, sum over S^t."""
    deq, _ = quantize_int8(g.to(torch.float32))
    return agg_sum(deq, received).to(g.dtype)


def make_gradagg(rule: str, f: int = 0) -> Callable:
    """Resolve a rule name to its reference callable ``(g, received) ->
    (d,)`` via ``repro_torch.dist.registry`` (lazy import: the dist layer
    depends on this module)."""
    from repro_torch.dist.registry import get_rule
    return get_rule(rule).bind_reference(f)


# ---------------------------------------------------------------------------
# nested-container lifting


def tree_agg(rule: Callable, grads_stacked, received):
    """grads_stacked: nested dicts/lists of tensors with a leading agent
    axis on every leaf. Leaf offsets come from the cached
    ``repro_torch.core.ledger`` layout."""
    from repro_torch.core.ledger import layout_of  # lazy: imports this
    layout = layout_of(grads_stacked, stacked=True)
    agg = rule(layout.flatten_stack(grads_stacked), received)
    return layout.unflatten(agg)


def project_ball(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """Euclidean projection onto W = {x : ||x|| <= gamma} (paper eq. (3))."""
    nrm = torch.linalg.vector_norm(x)
    return x * torch.clamp(gamma / torch.clamp(nrm, min=1e-30), max=1.0)


def tree_project_ball(tree, gamma: float):
    from repro_torch.core.ledger import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(tree)
    sq = sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves)
    scale = torch.clamp(gamma / torch.clamp(torch.sqrt(sq), min=1e-30),
                        max=1.0)
    return tree_unflatten(spec, [(l * scale).to(l.dtype) for l in leaves])
