"""Aggregation-rule registry: one ``AggregationRule`` per rule, bundling

- ``reference``   the op-by-op torch form from ``repro_torch.core.gradagg``
                  over a stacked ``(n, d)`` gradient matrix plus a boolean
                  ``received`` mask (the host engine's view),
- ``collective``  the raw SPMD twin from ``repro_torch.dist.collectives``
                  (native signature — e.g. ``cge_psum`` also returns its
                  keep-set), run on every rank of a mesh,
- ``spmd``        a uniform wrapper ``(tree, mask_self, f, axes, *, mesh)
                  -> tree`` with exactly the reference semantics, which
                  the parity tests hold against the reference,
- ``wire_bytes``  upload payload width per parameter (None -> the wire
                  dtype's width; 1 for the int8 compressed rule), which
                  ``History.bytes_tx`` accounting uses,
- ``device``      the f32 twin over a flat ``(n, P)`` ledger, which
                  reaches the CUDA kernels through ``kernels/ops.py``;
                  rules without a specialized form fall back to their
                  reference.

``EngineConfig.rule`` (via ``gradagg.make_gradagg``) and
``TrainConfig.mode`` (via ``resolve_mode`` in the step factories) both
resolve here.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import gradagg
from repro_torch.core.ledger import tree_flatten, tree_map
from repro_torch.dist import collectives as C


@dataclasses.dataclass(frozen=True)
class AggregationRule:
    name: str
    reference: Callable                  # (g, received[, f]) -> (d,)
    collective: Callable                 # native SPMD twin
    spmd: Callable                       # (tree, mask_self, f, axes, *, mesh)
    needs_f: bool = False
    normalized: bool = False             # True if output is already a mean
    wire_bytes: Optional[int] = None     # upload bytes/param (None = dtype)
    device: Optional[Callable] = None    # (g (n,P) f32, received[, f]) twin
    doc: str = ""

    def bind_reference(self, f: int = 0) -> Callable:
        """Reference callable with the Byzantine tolerance bound."""
        if self.needs_f:
            return partial(self.reference, f=f)
        return self.reference

    def bind_device(self, f: int = 0) -> Callable:
        """Device twin ``(g (n, P) f32, received (n,) bool) -> (P,) f32``
        over a resident ledger. Falls back to the reference when no
        kernel-backed form exists."""
        fn = self.device or self.reference
        if self.needs_f:
            return partial(fn, f=f)
        return fn

    def bind_sharded(self, f: int = 0, *, axes, n: int, mesh,
                     combine: str = "gather") -> Callable:
        """Twin over a dp-sharded ledger, run on every rank:
        ``(g_loc (n_loc, P) f32, received (n,) bool) -> (P,) f32`` where
        ``g_loc`` is this rank's row block and ``received`` the full
        mask. Two combine modes:

        - ``"gather"``   rebuild the full ledger bit-exactly
                         (``ledger_all_rows``) and run the unsharded
                         device twin — bit-identical to the
                         single-buffer device path by construction.
        - ``"partial"``  run the rule's kernel on the local row block and
                         finish with ONE all-reduce (memory per rank
                         stays n_loc x P); the sum runs in another order
                         than the whole-ledger kernel's, so parity is
                         tolerance-checked. trimmed_mean has no partial
                         form (coordinate-wise order statistics need
                         every row) and falls back to gather.
        """
        if combine not in ("gather", "partial"):
            raise ValueError(f"unknown combine mode {combine!r}")
        sharded = (_PARTIAL_FORMS.get(self.name) if combine == "partial"
                   else None)
        if sharded is not None:
            if self.needs_f:
                return partial(sharded, f=f, axes=axes, n=n, mesh=mesh)
            return partial(sharded, axes=axes, n=n, mesh=mesh)
        dev = self.bind_device(f)

        def gather_run(g_loc, received):
            return dev(C.ledger_all_rows(g_loc, axes, n, mesh=mesh),
                       received)

        return gather_run


# ---------------------------------------------------------------------------
# uniform SPMD wrappers (parity semantics == reference semantics)


def _spmd_sum(tree, mask, f, axes, *, mesh):
    del f
    return C.masked_psum(tree, mask, axes, mesh=mesh)


def _spmd_mean(tree, mask, f, axes, *, mesh):
    del f
    agg = C.masked_psum(tree, mask, axes, mesh=mesh)
    m = torch.as_tensor(mask, dtype=torch.float32,
                        device=tree_flatten(agg)[0][0].device)
    denom = torch.clamp(C.psum_all(m, axes, mesh=mesh), min=1.0)
    return tree_map(lambda g: g / denom, agg)


def _spmd_cge(tree, mask, f, axes, *, mesh):
    return C.cge_psum(tree, mask > 0, f, axes, mesh=mesh)[0]


def _spmd_trimmed(tree, mask, f, axes, *, mesh):
    return C.trimmed_mean_all(tree, mask > 0, f, axes, mesh=mesh)


def _spmd_quantized(tree, mask, f, axes, *, mesh):
    del f
    zeros = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), tree)
    return C.quantized_psum(tree, mask, zeros, axes, mesh=mesh)[0]


# ---------------------------------------------------------------------------
# device twins (flat (n, P) f32 ledger form; kernels/ops dispatches on the
# tensor's device — CUDA kernel for a CUDA tensor, plain torch on the CPU)


def _dev_sum(g, received):
    from repro_torch.kernels.agg import masked_sum_dot
    return masked_sum_dot(g, received)


def _dev_mean(g, received):
    from repro_torch.kernels.agg import masked_sum_dot
    s = masked_sum_dot(g, received)
    return s / torch.clamp(torch.sum(received.to(torch.float32)), min=1.0)


def _dev_cge(g, received, f):
    from repro_torch.kernels import ops as K
    return K.masked_cge_reduce(g, received, f=f)


def _dev_trimmed(g, received, f):
    from repro_torch.kernels import ops as K
    return K.trimmed_mean_tiled(g, received, f=f)


def _dev_quantized(g, received):
    from repro_torch.kernels import ops as K
    q, scale = gradagg.quantize_int8_parts(g.to(torch.float32))
    return K.dequant_accum(q, scale[:, 0], received)


# ---------------------------------------------------------------------------
# rank-local partial forms (combine="partial")
#
# Each runs on this rank's (n_loc, P) row block with the full (n,)
# received mask, applies the rule's kernel (or its matvec) on the n_loc
# rows, and finishes with ONE all-reduce. Row-local math (norms, int8
# quantization per row) is exact on shards, since a row is whole on its
# rank; only the final cross-rank sum runs in another order.


def _recv_local(received, axes, n, mesh):
    row0, n_loc = C.shard_row_slice(axes, n, mesh=mesh)
    return received[row0:row0 + n_loc]


def _part_sum(g_loc, received, *, axes, n, mesh):
    from repro_torch.kernels.agg import masked_sum_dot
    return C.psum_all(masked_sum_dot(
        g_loc, _recv_local(received, axes, n, mesh)), axes, mesh=mesh)


def _part_mean(g_loc, received, *, axes, n, mesh):
    s = _part_sum(g_loc, received, axes=axes, n=n, mesh=mesh)
    return s / torch.clamp(torch.sum(received.to(torch.float32)), min=1.0)


def _part_cge(g_loc, received, *, f, axes, n, mesh):
    from repro_torch.kernels.agg import row_norms
    # the (n,) norm vector all-reduced bit-exactly: every rank derives the
    # identical keep-set (the keep-set math exists once, as in cge_psum)
    norms = C.ledger_all_rows(row_norms(g_loc), axes, n, mesh=mesh)
    keep = gradagg.cge_mask_from_norms(norms, received, f)
    keep_loc = _recv_local(keep, axes, n, mesh)
    return C.psum_all(keep_loc.to(torch.float32) @ g_loc.to(torch.float32),
                      axes, mesh=mesh)


def _part_quantized(g_loc, received, *, axes, n, mesh):
    from repro_torch.kernels import ops as K
    q, scale = gradagg.quantize_int8_parts(g_loc.to(torch.float32))
    return C.psum_all(K.dequant_accum(
        q, scale[:, 0], _recv_local(received, axes, n, mesh)),
        axes, mesh=mesh)


_PARTIAL_FORMS: Dict[str, Callable] = {
    "sum": _part_sum,
    "mean": _part_mean,
    "cge": _part_cge,
    "quantized": _part_quantized,
    # trimmed_mean: intentionally absent -> gather fallback
}


# ---------------------------------------------------------------------------
# registry


_REGISTRY: Dict[str, AggregationRule] = {}


def register_rule(rule: AggregationRule) -> AggregationRule:
    _REGISTRY[rule.name] = rule
    return rule


def get_rule(name: str) -> AggregationRule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregation rule {name!r}; "
            f"registered: {sorted(_REGISTRY)}") from None


def rule_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_rule(AggregationRule(
    name="sum", reference=gradagg.agg_sum,
    collective=C.masked_psum, spmd=_spmd_sum, device=_dev_sum,
    doc="Algorithm 1 eq. (3): sum over S^t."))

register_rule(AggregationRule(
    name="mean", reference=gradagg.agg_mean,
    collective=C.masked_psum, spmd=_spmd_mean, normalized=True,
    device=_dev_mean,
    doc="sum / |S^t| — the LR-rescaled D-SGD variant."))

register_rule(AggregationRule(
    name="cge", reference=gradagg.agg_cge,
    collective=C.cge_psum, spmd=_spmd_cge, needs_f=True, device=_dev_cge,
    doc="CGE filter eq. (18): sum of the m-f smallest-norm gradients."))

register_rule(AggregationRule(
    name="trimmed_mean", reference=gradagg.agg_trimmed_mean,
    collective=C.trimmed_mean_all, spmd=_spmd_trimmed, needs_f=True,
    normalized=True, device=_dev_trimmed,
    doc="Coordinate-wise trimmed mean (Yin et al.)."))

register_rule(AggregationRule(
    name="quantized", reference=gradagg.agg_quantized,
    collective=C.quantized_psum, spmd=_spmd_quantized, wire_bytes=1,
    device=_dev_quantized,
    doc="int8 symmetric per-agent quantization + sum (1 byte/param "
        "uploads)."))


# ---------------------------------------------------------------------------
# TrainConfig.mode -> rule resolution (the step factories)

_MODE_RULES = {
    "masked": "sum",      # Algorithm 1 via loss-weight masking (fast path)
    "sync": "sum",
    "cge": "cge",
    "stale": "sum",       # rule (15): ledger substitution, then masked sum
    "trimmed": "trimmed_mean",
    "quantized": "quantized",
}


def resolve_mode(mode: str) -> AggregationRule:
    try:
        return get_rule(_MODE_RULES[mode])
    except KeyError:
        raise ValueError(
            f"unknown train mode {mode!r}; known: {sorted(_MODE_RULES)}"
        ) from None
