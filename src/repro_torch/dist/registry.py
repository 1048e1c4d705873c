"""Aggregation-rule registry: one ``AggregationRule`` per rule, bundling

- ``reference``   the op-by-op torch form from ``repro_torch.core.gradagg``
                  over a stacked ``(n, d)`` gradient matrix plus a boolean
                  ``received`` mask (the host engine's view),
- ``wire_bytes``  upload payload width per parameter (None -> the wire
                  dtype's width; 1 for the int8 compressed rule), which
                  ``History.bytes_tx`` accounting uses,
- ``device``      the f32 twin over a flat ``(n, P)`` ledger, which
                  reaches the CUDA kernels through ``kernels/ops.py``;
                  rules without a specialized form fall back to their
                  reference.

``EngineConfig.rule`` resolves here (via ``gradagg.make_gradagg``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import gradagg


@dataclasses.dataclass(frozen=True)
class AggregationRule:
    name: str
    reference: Callable                  # (g, received[, f]) -> (d,)
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
    name="sum", reference=gradagg.agg_sum, device=_dev_sum,
    doc="Algorithm 1 eq. (3): sum over S^t."))

register_rule(AggregationRule(
    name="mean", reference=gradagg.agg_mean, normalized=True,
    device=_dev_mean,
    doc="sum / |S^t| — the LR-rescaled D-SGD variant."))

register_rule(AggregationRule(
    name="cge", reference=gradagg.agg_cge, needs_f=True, device=_dev_cge,
    doc="CGE filter eq. (18): sum of the m-f smallest-norm gradients."))

register_rule(AggregationRule(
    name="trimmed_mean", reference=gradagg.agg_trimmed_mean, needs_f=True,
    normalized=True, device=_dev_trimmed,
    doc="Coordinate-wise trimmed mean (Yin et al.)."))

register_rule(AggregationRule(
    name="quantized", reference=gradagg.agg_quantized, wire_bytes=1,
    device=_dev_quantized,
    doc="int8 symmetric per-agent quantization + sum (1 byte/param "
        "uploads)."))
