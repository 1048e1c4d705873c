"""Dispatchers for the kernels, with ``repro.kernels.ops``'s ``impl=``
contract:

- ``"ref"``    the torch oracle (``kernels/ref.py``),
- ``"plain"``  the plain torch form of the kernel (``kernels/agg.py``,
               ``kernels/decode_attention.py``,
               ``kernels/flash_attention.py``, ``kernels/cge_norms.py``),
- ``"cuda"``   the CUDA kernel; its wrapper raises for a tensor that is
               not on a card,
- ``"auto"``   decided by the tensor's device: a CUDA tensor gets the
               kernel (or an exception), a CPU tensor the plain form.

This is the one place that decides by device; the kernel wrappers only
launch. ``tree_bucket`` lays a parameter or gradient tree out as the rows
the CGE norm kernels consume.
"""
from __future__ import annotations

import torch

from repro_torch.core.ledger import tree_flatten
from repro_torch.kernels import agg as _agg
from repro_torch.kernels import cge_norms as _cn
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "ref", "plain", "cuda")


def _route(impl: str, x) -> str:
    """``impl`` with ``"auto"`` resolved by ``x``'s device."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.device.type == "cuda" else "plain"
    return impl


def flash_attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    """q, k: (B, H, S|T, D); v: (B, H, T, Dv) -> (B, H, S, Dv) in q's
    dtype; the causal mask is top-left."""
    impl = _route(impl, q)
    if impl == "ref":
        return _ref.ref_flash_attention(q, k, v, causal=causal)
    if impl == "plain":
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def block_sq_norms(x, *, impl: str = "auto"):
    """x: (n_buckets, width) -> (n_buckets,) f32 squared row norms."""
    impl = _route(impl, x)
    if impl == "ref":
        return _ref.ref_block_sq_norms(x)
    if impl == "plain":
        return _cn.block_sq_norms_plain(x)
    return _cn.block_sq_norms(x)


def masked_scale(x, scale, *, impl: str = "auto"):
    """x: (n_buckets, width), scale: (n_buckets,) f32 -> x * scale[:, None]
    in x's dtype (the CGE keep/drop weights per bucket row)."""
    impl = _route(impl, x)
    if impl == "ref":
        return _ref.ref_masked_scale(x, scale)
    if impl == "plain":
        return _cn.masked_scale_plain(x, scale)
    return _cn.masked_scale(x, scale)


def masked_cge_reduce(g, received, *, f: int = 0, impl: str = "auto"):
    """CGE aggregate over the (n, P) gradient ledger: per-agent norms +
    keep-set + masked sum (paper eq. (18))."""
    impl = _route(impl, g)
    if impl == "ref":
        return _ref.ref_masked_cge_reduce(g, received, f)
    if impl == "plain":
        return _agg.masked_cge_dot(g, received, f)
    return _agg.masked_cge_reduce(g, received, f)


def trimmed_mean_tiled(g, received, *, f: int = 0, impl: str = "auto"):
    """Coordinate-wise trimmed mean over the (n, P) ledger via running
    min/max extraction; ``impl="ref"`` forces the sort oracle."""
    impl = _route(impl, g)
    if impl == "ref":
        return _ref.ref_trimmed_mean(g, received, f)
    if impl == "plain":
        return _agg.trimmed_mean_running(g, received, f)
    return _agg.trimmed_mean_tiled(g, received, f)


def dequant_accum(q, scale, received, *, impl: str = "auto"):
    """int8 payload x per-agent scale, masked f32 accumulation (the
    quantized rule's server-side reduction)."""
    impl = _route(impl, q)
    if impl == "ref":
        return _ref.ref_dequant_accum(q, scale, received)
    if impl == "plain":
        return _agg.dequant_dot(q, scale, received)
    return _agg.dequant_accum(q, scale, received)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           impl: str = "auto"):
    """Single-query attention over paged KV (the serving decode hot path).
    q: (B, H, D); k_pages/v_pages: (N, PS, Hkv, D|Dv); page_table:
    (B, Pmax) int32; kv_lens: (B,) int32. Returns (B, H, Dv). Every form
    is KV-head grouped: head h reads KV head h // (H // Hkv)."""
    impl = _route(impl, q)
    if impl == "ref":
        return _ref.ref_paged_decode_attention(q, k_pages, v_pages,
                                               page_table, kv_lens)
    if impl == "plain":
        return _da.paged_decode_plain(q, k_pages, v_pages, page_table,
                                      kv_lens)
    return _da.paged_flash_decode(q, k_pages, v_pages, page_table, kv_lens)


def tree_bucket(tree, width: int = 2048):
    """Flatten a parameter or gradient tree into (n_buckets, width) bf16
    rows, zero-padded: the layout the CGE kernels consume. Leaves go in
    ``jax.tree.leaves`` order (dict keys sorted, sequences in order).
    Returns (rows, n), n the number of elements before padding."""
    leaves = [leaf.reshape(-1).to(torch.bfloat16)
              for leaf in tree_flatten(tree)[0]]
    n = sum(leaf.numel() for leaf in leaves)
    rows = -(-n // width)
    pad = torch.zeros(rows * width - n, dtype=torch.bfloat16,
                      device=leaves[0].device)
    return torch.cat([*leaves, pad]).reshape(rows, width), n
