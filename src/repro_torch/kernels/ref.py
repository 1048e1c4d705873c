"""Torch oracles for the aggregation kernels (the allclose ground truth)."""
from __future__ import annotations

import torch

from repro_torch.core import gradagg


def ref_masked_cge_reduce(g, received, f: int):
    """CGE aggregate oracle: exactly ``gradagg.agg_cge`` in f32."""
    return gradagg.agg_cge(g.to(torch.float32), received, f)


def ref_trimmed_mean(g, received, f: int):
    """Coordinate-wise trimmed-mean oracle: ``gradagg.agg_trimmed_mean``
    in f32 (full sort; the kernel's running min/max must match it)."""
    return gradagg.agg_trimmed_mean(g.to(torch.float32), received, f)


def ref_dequant_accum(q, scale, received):
    """q: (n, P) int8, scale: (n,) f32 -> (P,) f32 masked dequant sum."""
    w = scale.to(torch.float32) * received.to(torch.float32)
    return torch.sum(q.to(torch.float32) * w[:, None], dim=0)
