"""Attention: grouped-query attention with optional QKV bias, its KV
caches and the paged decode (counterpart of the GQA half of
``repro.models.attention``).

Prefill and training attention are plain torch matmuls and a f32
softmax (``plain_attention``; ``chunked_attention`` above 2048 tokens),
as the reference computes them outside any Pallas kernel. Paged decode
attends through ``kernels/ops.paged_decode_attention``: the hand-written
CUDA kernel for a CUDA tensor, its plain form for a CPU tensor.

Caches are written in place (``index_put_`` without accumulate, where the
reference returns an updated copy or donates the buffer), so a decode
step allocates no new pool. Cross-attention, ``_paged_read`` and MLA wait
for the model families that use them (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, param_dtype, rotate

PLAIN_MAX_SEQ = 2048          # above this, use chunked online-softmax
CHUNK = 1024

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# shared attention math


def plain_attention(q, k, v, *, causal: bool, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None):
    """q: (B, S, H, D); k, v: (B, T, H, D) (KV already repeated to H
    heads). Returns (B, S, H, D)."""
    s, d = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores * d ** -0.5
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    if kv_len is not None:                       # decode: valid cache prefix
        mask = torch.arange(t, device=q.device)[None, :] < kv_len[:, None]
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(q.dtype), v)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = CHUNK):
    """Online softmax over key chunks. q, k: (B, S, H, D); v: (B, T, H, Dv)."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    t = k.shape[1]
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"sequence {t} is not a multiple of chunk {c}")
    scale = d ** -0.5
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dv), dtype=q.dtype, device=q.device)
    for i in range(t // c):
        ki, vi = k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c]
        sc = torch.einsum("bshd,bchd->bhsc", q, ki).to(torch.float32) * scale
        if causal:
            kpos = i * c + torch.arange(c, device=q.device)
            sc = sc.masked_fill(~(kpos[None, :] <= qpos[:, None])[None, None],
                                NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhsc,bchd->bhsd", p.to(q.dtype), vi)
        acc = acc * corr[..., None].to(q.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(q.dtype)
    return out.transpose(1, 2)                   # (B, S, H, Dv)


def attention_math(q, k, v, *, causal: bool, kv_len=None):
    if q.shape[1] == k.shape[1] and q.shape[1] > PLAIN_MAX_SEQ:
        return chunked_attention(q, k, v, causal=causal)
    return plain_attention(q, k, v, causal=causal, kv_len=kv_len)


# ---------------------------------------------------------------------------
# GQA


def init_gqa(gen, cfg: ArchConfig, device):
    d, dt = cfg.d_model, param_dtype(cfg)
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(width * hd, dtype=dt, device=device)
    return p


def _proj_qkv(p, x, cfg: ArchConfig):
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def _paged_append(pool, new, page_table, lens, ps: int) -> None:
    """Write one token per sequence into its page pool, in place.
    pool: (N, PS, ...); new: (B, ...); position lens[b] in logical pages.
    Idle slots (table rows of the null page 0) may write one location
    together: any of the writes may land, and no active slot reads it."""
    b = new.shape[0]
    rows = torch.arange(b, device=pool.device)
    phys = page_table[rows, lens // ps].long()
    pool.index_put_((phys, (lens % ps).long()), new.to(pool.dtype))


def apply_gqa(p, x, cfg: ArchConfig, *, rope=None, cache=None,
              cache_index=None, causal=True, return_cache=False,
              page_table=None, impl: str = "auto"):
    """Self-attention of a decoder layer.

    - training: cache=None, full sequence.
    - prefill: return_cache=True -> also returns {"k", "v"} (B, S, Hkv, hd).
    - decode: cache given + cache_index -> one-token step, the cache
      written in place. cache_index is a scalar (all rows at one
      position) or a (B,) vector of per-sequence lengths.
    - paged decode: cache holds ``k_pages``/``v_pages`` pools (N, PS, Hkv,
      hd) and ``page_table`` (B, Pmax) maps logical to physical pages;
      cache_index is the (B,) lengths. ``impl`` picks the attention form.

    ``rope`` is the (cos, sin) pair of ``layers.rope_cos_sin`` for this
    call's positions, or None for an arch without rotary positions.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    q, k_new, v_new = _proj_qkv(p, x, cfg)
    if rope is not None:
        q, k_new = rotate(q, *rope), rotate(k_new, *rope)

    def expand_kv(t):
        return torch.repeat_interleave(t, g, dim=2) if g > 1 else t

    new_cache = None
    if cache is not None and cache_index is not None:
        if "k_pages" in cache:
            lens = cache_index
            kp, vp = cache["k_pages"], cache["v_pages"]
            ps = kp.shape[1]
            _paged_append(kp, k_new[:, 0], page_table, lens, ps)
            _paged_append(vp, v_new[:, 0], page_table, lens, ps)
            out = ops.paged_decode_attention(
                q[:, 0].contiguous(), kp, vp, page_table, lens + 1,
                impl=impl)[:, None]                   # (B, 1, H, hd)
            y = out.to(x.dtype).reshape(b, s, -1) @ p["wo"]
            return y, cache
        k, v = cache["k"], cache["v"]
        idx = torch.as_tensor(cache_index, device=x.device)
        if idx.dim():
            # ragged continuous batch: each row writes at its own length
            rows = torch.arange(b, device=x.device)
            k.index_put_((rows, idx.long()), k_new[:, 0].to(k.dtype))
            v.index_put_((rows, idx.long()), v_new[:, 0].to(v.dtype))
            kv_len = idx + 1
        else:
            i = int(idx)
            k[:, i:i + s] = k_new.to(k.dtype)
            v[:, i:i + s] = v_new.to(v.dtype)
            kv_len = torch.full((b,), i + 1, device=x.device)
        out = plain_attention(q, expand_kv(k), expand_kv(v), causal=False,
                              kv_len=kv_len)
        new_cache = cache
    else:
        out = attention_math(q, expand_kv(k_new), expand_kv(v_new),
                             causal=causal)
        if return_cache:
            new_cache = {"k": k_new, "v": v_new}
    y = out.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
    return y, new_cache
