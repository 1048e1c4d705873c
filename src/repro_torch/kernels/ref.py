"""Torch oracles for the kernels (the allclose ground truth)."""
from __future__ import annotations

import torch

from repro_torch.core import gradagg

NEG_INF = -1e30


def ref_paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens):
    """Single-query attention over a paged KV cache, in f32.

    q: (B, H, D); k_pages: (N, PS, Hkv, D); v_pages: (N, PS, Hkv, Dv);
    page_table: (B, Pmax) int; kv_lens: (B,) int. Returns (B, H, Dv) in
    q's dtype. Grouped: head h reads KV head h // G (G = H // Hkv), with
    no H-fold repeat of the KV. Table entries are clamped into the pool
    (-1 and stale entries read page 0, masked by the length), and a row
    with no valid token (kv_len == 0) is exactly zero.
    """
    b, h, d = q.shape
    n, ps, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    tbl = page_table.long().clamp(0, n - 1)
    t = tbl.shape[1] * ps
    k = k_pages[tbl].reshape(b, t, hkv, d).to(torch.float32)
    v = v_pages[tbl].reshape(b, t, hkv, dv).to(torch.float32)
    qg = q.reshape(b, hkv, h // hkv, d).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) * (d ** -0.5)
    mask = (torch.arange(t, device=q.device)[None, :]
            < kv_lens.long()[:, None])                        # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(dim=1)[:, None, None, None], w, 0.0)
    out = torch.einsum("bkgt,btkv->bkgv", w, v)
    return out.reshape(b, h, dv).to(q.dtype)


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
