"""Attention: grouped-query attention with optional QKV bias and its
cross-attention branch, DeepSeek's multi-head latent attention (MLA),
their KV caches and the paged decode (counterpart of
``repro.models.attention``).

Prefill and training attention are plain torch matmuls and a f32
softmax (``plain_attention``; ``chunked_attention`` above 2048 tokens),
as the reference computes them outside any Pallas kernel. GQA's paged
decode attends through ``kernels/ops.paged_decode_attention``: the
hand-written CUDA kernel for a CUDA tensor, its plain form for a CPU
tensor. MLA's absorbed decode scores in latent space over pages gathered
by ``_paged_read``, and cross-attention reads the encoder's K/V: both
torch operations, as in the reference (its latent width of 512 is past
the decode kernel's head dim too).

Caches are written in place (``index_put_`` without accumulate, where the
reference returns an updated copy or donates the buffer), so a decode
step allocates no new pool.

Under a serving mesh (``dist.sharding.serve_tp``, installed by the
tensor-parallel ``ServeEngine``) every rank computes the whole layer
but its attention: GQA's paged decode appends this rank's KV-head block
to its pools and attends through ``tp_paged_decode``; MLA's absorbed
decode splits over query heads (``_mla_tp_shard``). Both meet again in
one exact all-reduce before ``wo``, so every rank's output is the
replicated engine's.

Under tensor-parallel compute (``dist.tp``, the placed train step and
``launch.serve``'s steps on a mesh) GQA runs on this rank's blocks of
the reference's compute layout (``_apply_gqa_tp``): the query heads over
gcd(H, tp) groups of ranks (a head over several ranks where H divides
tp: ``_gqa_head_split``), ``wo``'s fan-in block summed over tp, and a
dense decode over this rank's head_dim block of the cache. Cross-
attention takes the same path: K/V from the encoder's output, a
prefill's ``ck`` / ``cv`` in the cache's head_dim layout, a decode's
partial dots over them. MLA does too
(``_apply_mla_tp``): its latents projected on this rank's columns,
normed by block sums of squares summed over tp and gathered whole,
``w_uk`` / ``w_uv`` re-laid from a block of every head to the group's
whole heads, ``wo``'s fan-in block summed over tp, and a dense decode
on a cache of this rank's latent and rope-key columns, gathered whole.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.act_sharding import constrain
from repro_torch.dist.sharding import current_serve_tp
from repro_torch.dist.tp import (copy_to_tp, current_tp, gather_from_tp,
                                 lead_only, reduce_from_tp, scatter_to_tp,
                                 sum_over_group)
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init,
                                       param_dtype, rotate)

PLAIN_MAX_SEQ = 2048          # above this, use chunked online-softmax
CHUNK = 1024

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# shared attention math


def plain_attention(q, k, v, *, causal: bool, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, reduce=None):
    """q: (B, S, H, D); k, v: (B, T, H, D) (KV already repeated to H
    heads; v may be narrower). Returns (B, S, H, Dv). ``scale`` (D^-0.5
    by default) multiplies the scores after ``reduce`` (None: none), which
    joins partial scores over blocks of the head dimension."""
    s, d = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    if reduce is not None:
        scores = reduce(scores)
    scores = scores * (d ** -0.5 if scale is None else scale)
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


def chunked_attention(q, k, v, *, causal: bool, chunk: int = CHUNK,
                      scale: Optional[float] = None, reduce=None):
    """Online softmax over key chunks. q, k: (B, S, H, D); v: (B, T, H, Dv).
    ``scale`` and ``reduce`` as in :func:`plain_attention`."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    t = k.shape[1]
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"sequence {t} is not a multiple of chunk {c}")
    scale = d ** -0.5 if scale is None else scale
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dv), dtype=q.dtype, device=q.device)
    for i in range(t // c):
        ki, vi = k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c]
        sc = torch.einsum("bshd,bchd->bhsc", q, ki).to(torch.float32)
        if reduce is not None:
            sc = reduce(sc)
        sc = sc * scale
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


def attention_math(q, k, v, *, causal: bool, kv_len=None, scale=None,
                   reduce=None):
    if q.shape[1] == k.shape[1] and q.shape[1] > PLAIN_MAX_SEQ:
        return chunked_attention(q, k, v, causal=causal, scale=scale,
                                 reduce=reduce)
    return plain_attention(q, k, v, causal=causal, kv_len=kv_len,
                           scale=scale, reduce=reduce)


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


def _proj_q(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)


def _proj_kv(p, kv_x, cfg: ArchConfig):
    b, t, _ = kv_x.shape
    k, v = kv_x @ p["wk"], kv_x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    hd = cfg.resolved_head_dim
    return (k.reshape(b, t, cfg.n_kv_heads, hd),
            v.reshape(b, t, cfg.n_kv_heads, hd))


def _paged_append(pool, new, page_table, lens, ps: int) -> None:
    """Write one token per sequence into its page pool, in place.
    pool: (N, PS, ...); new: (B, ...); position lens[b] in logical pages.
    Idle slots (table rows of the null page 0) may write one location
    together: any of the writes may land, and no active slot reads it."""
    b = new.shape[0]
    rows = torch.arange(b, device=pool.device)
    phys = page_table[rows, lens // ps].long()
    pool.index_put_((phys, (lens % ps).long()), new.to(pool.dtype))


def _paged_read(pool, page_table):
    """A contiguous (B, Pmax*PS, ...) gather of a paged leaf; table
    entries of -1 read page 0. MLA's absorbed decode reads its latent
    pages this way (GQA's goes through the decode kernel)."""
    g = pool[torch.clamp(page_table, min=0).long()]   # (B, Pmax, PS, ...)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def apply_gqa(p, x, cfg: ArchConfig, *, rope=None, kv_x=None, cache=None,
              cache_index=None, causal=True, return_cache=False,
              page_table=None, impl: str = "auto"):
    """Self- or cross-attention.

    - training / encoder: cache=None, full sequence.
    - prefill: return_cache=True -> also returns {"k", "v"} (B, S, Hkv,
      hd), or {"ck", "cv"} over the encoder's T tokens for cross-attention.
    - cross-attention: ``kv_x`` (B, T, d) the encoder output; or, in
      decode, a cache holding the encoder's ``ck``/``cv`` (returned as
      it is).
    - decode: cache given + cache_index -> one-token step, the cache
      written in place. cache_index is a scalar (all rows at one
      position) or a (B,) vector of per-sequence lengths.
    - paged decode: cache holds ``k_pages``/``v_pages`` pools (N, PS, Hkv,
      hd) and ``page_table`` (B, Pmax) maps logical to physical pages;
      cache_index is the (B,) lengths. ``impl`` picks the attention form.

    ``rope`` is the (cos, sin) pair of ``layers.rope_cos_sin`` for this
    call's positions, or None for an arch without rotary positions (and
    for cross-attention).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    tp = current_tp()
    if tp is not None and p["wq"].shape[-1] != cfg.n_heads * hd:
        return _apply_gqa_tp(p, x, cfg, tp, rope=rope, kv_x=kv_x,
                             cache=cache, cache_index=cache_index,
                             causal=causal, return_cache=return_cache)

    def expand_kv(t, kind="heads4"):
        # KV repeated to the H query heads (the reference's TP layout)
        return constrain(torch.repeat_interleave(t, g, dim=2) if g > 1
                         else t, kind)

    def project_out(out):
        return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"]

    q = _proj_q(p, x, cfg)
    if cache is not None and "ck" in cache:
        # cross-attention against the cached encoder K/V
        out = plain_attention(constrain(q, "heads4"), expand_kv(cache["ck"]),
                              expand_kv(cache["cv"]), causal=False)
        return project_out(out), cache
    if kv_x is not None:
        k, v = _proj_kv(p, kv_x, cfg)
        out = attention_math(constrain(q, "heads4"), expand_kv(k),
                             expand_kv(v), causal=False)
        return project_out(out), ({"ck": k, "cv": v} if return_cache
                                  else None)

    k_new, v_new = _proj_kv(p, x, cfg)
    if rope is not None:
        q, k_new = rotate(q, *rope), rotate(k_new, *rope)
    new_cache = None
    if cache is not None and cache_index is not None:
        if "k_pages" in cache:
            lens = cache_index
            kp, vp = cache["k_pages"], cache["v_pages"]
            ps = kp.shape[1]
            k1, v1 = k_new[:, 0], v_new[:, 0]
            tp_ctx = current_serve_tp()
            kv_block = tp_ctx[2] if tp_ctx is not None else None
            if kv_block is not None:             # this rank's KV-head block
                k1, v1 = (k1[:, kv_block[0]:kv_block[1]],
                          v1[:, kv_block[0]:kv_block[1]])
            _paged_append(kp, k1, page_table, lens, ps)
            _paged_append(vp, v1, page_table, lens, ps)
            if kv_block is not None:
                from repro_torch.kernels.decode_attention import (
                    tp_paged_decode)
                out = tp_paged_decode(
                    q[:, 0].contiguous(), kp, vp, page_table, lens + 1,
                    mesh=tp_ctx[0], kv_block=kv_block,
                    n_kv_heads=cfg.n_kv_heads, tp_axes=tp_ctx[1],
                    impl=impl)[:, None]
            else:
                out = ops.paged_decode_attention(
                    q[:, 0].contiguous(), kp, vp, page_table, lens + 1,
                    impl=impl)[:, None]               # (B, 1, H, hd)
            return project_out(out.to(x.dtype)), cache
        k, v = cache["k"], cache["v"]
        kv_len = _write_decode(cache_index, b, s, (k, k_new), (v, v_new))
        # the decode's layout: head_dim over tp
        out = plain_attention(constrain(q, "hd_tp"), expand_kv(k, "hd_tp"),
                              expand_kv(v, "hd_tp"), causal=False,
                              kv_len=kv_len)
        new_cache = cache
    else:
        out = attention_math(constrain(q, "heads4"), expand_kv(k_new),
                             expand_kv(v_new), causal=causal)
        if return_cache:
            new_cache = {"k": k_new, "v": v_new}
    return project_out(out), new_cache


def _apply_gqa_tp(p, x, cfg: ArchConfig, tp, *, rope, kv_x, cache,
                  cache_index, causal, return_cache):
    """GQA self- or cross-attention on this rank's blocks of the compute
    layout (``wq`` split over tp on its fan-out, ``wo`` on its fan-in,
    ``wk`` / ``wv`` and the biases whole), as the reference's compiled
    steps split it.

    - The query heads split over g = gcd(H, n) groups of consecutive tp
      ranks; a group's ranks compute its heads alike. Where H % n = 0
      (g = n) each rank projects its own heads and only the KV heads they
      read; otherwise ``wq``'s columns cross head boundaries, the query is
      gathered to the group's heads and K/V are projected whole, or,
      under the general step's program (``dist.tp.TP``), only the KV
      heads the group reads, their gradient kept on one rank a group.
      K/V come from ``x``, or for cross-attention from ``kv_x`` (the
      encoder's output, whole on every rank).
    - Train and prefill attend over the group's heads; the output's block
      of ``wo``'s fan-in is this rank's, and the partial products are
      summed over tp. A prefill returns the cache in ``cache_specs``'
      layout: every KV head, this rank's block of head_dim (``k`` / ``v``,
      or cross-attention's ``ck`` / ``cv``).
    - A dense decode reads that cache: the query gathered whole, scores
      as partial dots over the head_dim blocks summed over tp, the output
      gathered over head_dim before ``wo``'s fan-in block is taken. A
      self-attention decode first writes its token's block; a
      cross-attention decode (a cache holding ``ck`` / ``cv``) reads the
      encoder's K/V as they are and returns the cache.
    """
    if cache is not None and cache_index is not None and "k_pages" in cache:
        raise NotImplementedError("paged decode runs on the serving "
                                  "engine's own TP (dist.sharding.serve_tp)")
    b, s, _ = x.shape
    H, hkv, hd, n = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp.size
    rep = H // hkv
    groups = math.gcd(H, n)
    heads = tp.block(H, groups)                 # this group's query heads
    cross_decode = cache is not None and "ck" in cache
    decode = cross_decode or (cache is not None and cache_index is not None)
    # project only the KV heads read
    own_kv = (groups == n or tp.program == "general") and not decode

    xc = copy_to_tp(x)
    q = xc @ p["wq"]
    if cfg.qkv_bias:
        q = q + scatter_to_tp(p["bq"], -1)
    if cross_decode:
        q = gather_from_tp(q, -1).reshape(b, s, H, hd)
        out = _tp_dense_attend(q, cache["ck"], cache["cv"], None, tp, rep)
        out = scatter_to_tp(out.reshape(b, s, H * hd), -1)
        return reduce_from_tp(out @ p["wo"]), cache
    src = x if kv_x is None else kv_x
    if not decode and groups == H < n:
        return _gqa_head_split(p, q, x, src, kv_x is not None, cfg, tp,
                               rope=rope, causal=causal,
                               return_cache=return_cache)
    if own_kv:
        srcc = xc if kv_x is None else copy_to_tp(kv_x)
        t = src.shape[1]
        k0, k1 = heads.start // rep, (heads.stop - 1) // rep + 1
        cols = slice(k0 * hd, k1 * hd)
        k, v = (srcc @ copy_to_tp(p[w])[:, cols] for w in ("wk", "wv"))
        if cfg.qkv_bias:
            k = k + copy_to_tp(p["bk"])[cols]
            v = v + copy_to_tp(p["bv"])[cols]
        k, v = (lead_only(t_, groups).reshape(b, t, k1 - k0, hd)
                for t_ in (k, v))
    else:
        k0, k1 = 0, hkv
        k, v = _proj_kv(p, src, cfg)
    if rope is not None:
        k = rotate(k, *rope)

    if decode:
        q = gather_from_tp(q, -1).reshape(b, s, H, hd)
        if rope is not None:
            q = rotate(q, *rope)
        out = _tp_dense_decode(q, k, v, cache, cache_index, tp, rep)
        out = scatter_to_tp(out.reshape(b, s, H * hd), -1)
        return reduce_from_tp(out @ p["wo"]), cache
    q = gather_from_tp(q, -1, groups).reshape(b, s, H // groups, hd)
    if rope is not None:
        q = rotate(q, *rope)
    new_cache = None
    if return_cache:
        names = ("k", "v") if kv_x is None else ("ck", "cv")
        new_cache = {nm: _cache_block(tp, t_, k0, H, rep, hkv)
                     for nm, t_ in zip(names, (k, v))}
    if not own_kv:
        k, v = (copy_to_tp(t_, groups) for t_ in (k, v))
    idx = (torch.arange(heads.start, heads.stop, device=x.device) // rep
           - k0)
    out = attention_math(constrain(q, "heads4"),
                         constrain(k.index_select(2, idx), "heads4"),
                         constrain(v.index_select(2, idx), "heads4"),
                         causal=causal)
    out = out.reshape(b, s, H // groups * hd)
    out = scatter_to_tp(out, -1, groups)
    return reduce_from_tp(out @ p["wo"]), new_cache


def _gqa_head_split(p, q, x, src, cross: bool, cfg: ArchConfig, tp, *,
                    rope, causal, return_cache):
    """Train and prefill where each head spans r = n / H ranks (H divides
    n, H < n: whisper's 8 heads at model 16), as the reference's compiled
    steps split it. This rank's block of ``wq``'s fan-out (``q``, the
    query projected from ``copy_to_tp(x)``) and of ``wo``'s fan-in are
    one block of hd / r columns of its group's head; the values, and so
    the output, take only those columns, which are this rank's block of
    ``wo``'s fan-in as they are. K/V come from ``src`` (``x``, or the
    encoder's output).

    - The masked program (the placed step and serving): the query is
      gathered whole and the scores take the head's whole head_dim on K/V
      projected whole. Each rank's gradients of the query, K and V are
      its columns' part, summed over tp.
    - The general step's program: the query, K and V all on this rank's
      hd / r columns, the partial scores summed over the group's ranks
      (``dist.tp.sum_over_group``); with rotary positions (their pairs
      span the blocks) the masked program's form."""
    b, s, _ = x.shape
    H, hkv, hd, n = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp.size
    t = src.shape[1]
    head = tp.rank // (n // H)
    kvh = head // (H // hkv)
    blk = tp.block(H * hd)                  # this rank's q / wo columns
    vcols = slice(blk.start - head * hd + kvh * hd,
                  blk.stop - head * hd + kvh * hd)
    new_cache, reduce = None, None
    if tp.program == "general" and not return_cache and rope is None:
        srcc = copy_to_tp(src)
        k, v = (srcc @ copy_to_tp(p[w])[:, vcols] for w in ("wk", "wv"))
        if cfg.qkv_bias:
            k = k + copy_to_tp(p["bk"])[vcols]
            v = v + copy_to_tp(p["bv"])[vcols]
        q = q.reshape(b, s, 1, -1)
        k, v = k.reshape(b, t, 1, -1), v.reshape(b, t, 1, -1)

        def reduce(scores):
            return sum_over_group(scores, H)
    else:
        q = copy_to_tp(gather_from_tp(q, -1)).reshape(b, s, H, hd)
        q = q[:, :, head:head + 1]
        k, v = _proj_kv(p, src, cfg)
        if rope is not None:
            q, k = rotate(q, *rope), rotate(k, *rope)
        if return_cache:
            names = ("ck", "cv") if cross else ("k", "v")
            new_cache = {nm: _cache_block(tp, t_, 0, H, H // hkv, hkv)
                         for nm, t_ in zip(names, (k, v))}
        k = copy_to_tp(k)[:, :, kvh:kvh + 1]
        v = copy_to_tp(v).reshape(b, t, hkv * hd)[..., vcols]
        v = v.reshape(b, t, 1, -1)
    out = attention_math(constrain(q, "heads4"), constrain(k, "heads4"),
                         constrain(v, "heads4"), causal=causal,
                         scale=hd ** -0.5, reduce=reduce)
    return reduce_from_tp(out.reshape(b, s, -1) @ p["wo"]), new_cache


def _cache_block(tp, kv, k0: int, H: int, rep: int, hkv: int):
    """A prefill's K or V in ``cache_specs``' layout: every KV head, this
    rank's block of head_dim (whole where tp does not divide it). ``kv``
    holds heads ``k0:k0 + kv.shape[2]``; where that is not all of them
    (each rank projected its own), every head comes from the lowest rank
    that holds it, through one ``-0.0``-padded all-reduce."""
    hd = kv.shape[-1]
    if kv.shape[2] != hkv:
        n, r = tp.size, tp.rank
        prev = (r * H // n - 1) // rep + 1 if r else 0   # rank r-1's end
        w0 = max(k0, prev)
        buf = torch.full(kv.shape[:2] + (hkv, hd), -0.0, dtype=kv.dtype,
                         device=kv.device)
        buf[:, :, w0:k0 + kv.shape[2]] = kv[:, :, w0 - k0:].detach()
        kv = tp.all_reduce(buf)
    return kv[..., tp.block(hd)] if hd % tp.size == 0 else kv


def _tp_dense_decode(q, k_new, v_new, cache, cache_index, tp, rep: int):
    """One token against a dense cache in ``cache_specs``' layout (head_dim
    over tp where it divides), its K/V written first: the query whole
    (B, 1, H, hd); returns the output whole (B, 1, H, hd)."""
    b, s, _, hd = q.shape
    kc, vc = cache["k"], cache["v"]
    if kc.shape[-1] != hd:
        blk = tp.block(hd)
        k_new, v_new = k_new[..., blk], v_new[..., blk]
    kv_len = _write_decode(cache_index, b, s, (kc, k_new), (vc, v_new))
    return _tp_dense_attend(q, kc, vc, kv_len, tp, rep)


def _tp_dense_attend(q, kc, vc, kv_len, tp, rep: int):
    """The whole query (B, S, H, hd) against dense K/V (B, T, Hkv, hd or
    this rank's head_dim block): where the cache holds a block, the scores
    are partial dots over it summed over tp and the output is gathered
    over head_dim. ``kv_len`` (B,) masks a valid prefix (None: every
    position). Returns the output whole (B, S, H, hd)."""
    hd = q.shape[-1]
    split = kc.shape[-1] != hd
    if split:
        q = q[..., tp.block(hd)]
    kr = torch.repeat_interleave(kc, rep, dim=2) if rep > 1 else kc
    vr = torch.repeat_interleave(vc, rep, dim=2) if rep > 1 else vc
    q, kr, vr = (constrain(t, "hd_tp") for t in (q, kr, vr))
    scores = torch.einsum("bshd,bthd->bhst", q, kr).to(torch.float32)
    if split:
        scores = reduce_from_tp(scores)
    scores = scores * hd ** -0.5
    if kv_len is not None:
        mask = (torch.arange(kc.shape[1], device=q.device)[None, :]
                < kv_len[:, None])
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w.to(q.dtype), vr)
    return gather_from_tp(out, -1) if split else out


def _write_decode(cache_index, b: int, s: int, *pairs):
    """Write each (dense cache (B, T, ...), new rows (B, S, ...)) pair at
    ``cache_index``, in place: a (B,) vector writes row b's one token at
    its own length (a ragged continuous batch), a scalar writes all rows'
    S tokens at one position. Returns the (B,) valid lengths. A scalar
    position is read on the host as it is given (an int or a host
    tensor), before anything moves to the cache's device: no copy to the
    device and back, and a step runs on meta tensors."""
    dev = pairs[0][0].device
    idx = (cache_index if isinstance(cache_index, torch.Tensor)
           else torch.as_tensor(cache_index))
    if idx.dim():
        idx = idx.to(dev)
        rows = torch.arange(b, device=dev)
        for buf, new in pairs:
            buf.index_put_((rows, idx.long()), new[:, 0].to(buf.dtype))
        return idx + 1
    i = int(idx)
    for buf, new in pairs:
        buf[:, i:i + s] = new.to(buf.dtype)
    return torch.full((b,), i + 1, device=dev)


# ---------------------------------------------------------------------------
# DeepSeek MLA


def init_mla(gen, cfg: ArchConfig, device):
    m = cfg.mla
    d, dt, h = cfg.d_model, param_dtype(cfg), cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dt, device),
        "q_norm": torch.ones(m.q_lora_rank, dtype=dt, device=device),
        "w_uq": dense_init(gen, m.q_lora_rank, h * qd, dt, device),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dt, device),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=dt, device=device),
        "w_kr": dense_init(gen, d, m.qk_rope_head_dim, dt, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dt,
                           device).reshape(m.kv_lora_rank, h,
                                           m.qk_nope_head_dim),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dt,
                           device).reshape(m.kv_lora_rank, h, m.v_head_dim),
        "wo": dense_init(gen, h * m.v_head_dim, d, dt, device),
    }


def _rms(x, scale):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _mla_tp_shard(absorbed, q_nope, q_rope, w_uk, w_uv, h: int):
    """The absorbed decode, split over query heads when a serving TP
    context is active (the identity otherwise): each rank computes its
    head block (q_nope/q_rope dim 2, w_uk/w_uv dim 1), the latent pools
    being whole on every rank, and the blocks meet in one all-reduce of
    ``-0.0`` pads — exact, since per-head math has no cross-head
    reduction before ``wo``."""
    tp_ctx = current_serve_tp()
    if tp_ctx is None:
        return absorbed(q_nope, q_rope, w_uk, w_uv)
    mesh, tp_axes, _ = tp_ctx
    ts = mesh.axis_size(tp_axes)
    if ts == 1 or h % ts:
        return absorbed(q_nope, q_rope, w_uk, w_uv)
    hl, r = h // ts, mesh.axis_index(tp_axes)
    blk = slice(r * hl, (r + 1) * hl)
    out_loc = absorbed(q_nope[:, :, blk], q_rope[:, :, blk], w_uk[:, blk],
                       w_uv[:, blk])
    full = torch.full(out_loc.shape[:2] + (h,) + out_loc.shape[3:], -0.0,
                      dtype=out_loc.dtype, device=out_loc.device)
    full[:, :, blk] = out_loc
    return mesh.all_reduce(full, tp_axes)


def _absorbed(qn, qr, wuk, wuv, ckv, kr, kv_len, scale: float):
    """MLA's absorbed decode over a latent cache: ``w_uk`` absorbed into
    the query, ``w_uv`` into the output, scores and values in latent
    space. qn (B, S, h, nope), qr (B, S, h, rope), wuk (rank, h, nope),
    wuv (rank, h, v), ckv (B, T, rank), kr (B, T, rope) -> (B, S, h, v)."""
    t = ckv.shape[1]
    q_abs = torch.einsum("bshn,lhn->bshl", qn, wuk)
    scores = (torch.einsum("bshl,btl->bhst", q_abs, ckv)
              + torch.einsum("bshr,btr->bhst", qr, kr)
              ).to(torch.float32) * scale
    mask = torch.arange(t, device=ckv.device)[None, :] < kv_len[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(qn.dtype)
    out_lat = torch.einsum("bhst,btl->bshl", w, ckv)
    return torch.einsum("bshl,lhv->bshv", out_lat, wuv)


def apply_mla(p, x, cfg: ArchConfig, *, positions, cache=None,
              cache_index=None, return_cache=False, page_table=None):
    """Multi-head latent attention. Train and prefill materialise
    per-head K (nope + rope dims) and V; prefill caches the normed latent
    ``ckv`` (B, S, rank) and the roped key ``kr`` (B, S, rope). Decode
    (dense ``ckv``/``kr`` or paged ``ckv_pages``/``kr_pages``, written in
    place) absorbs ``w_uk`` into the query and ``w_uv`` into the output,
    so scores and values stay in latent space."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rp, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    tp = current_tp()
    if tp is not None and p["w_uq"].shape[-1] != h * (nope + rp):
        return _apply_mla_tp(p, x, cfg, tp, positions=positions, cache=cache,
                             cache_index=cache_index,
                             return_cache=return_cache)

    cq = _rms(x @ p["w_dq"], p["q_norm"])
    q = (cq @ p["w_uq"]).reshape(b, s, h, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_new = _rms(x @ p["w_dkv"], p["kv_norm"])
    kr_new = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if cache is not None and cache_index is not None:
        if "ckv_pages" in cache:
            lens = cache_index
            ckv_p, kr_p = cache["ckv_pages"], cache["kr_pages"]
            ps = ckv_p.shape[1]
            _paged_append(ckv_p, ckv_new[:, 0], page_table, lens, ps)
            _paged_append(kr_p, kr_new[:, 0], page_table, lens, ps)
            ckv = _paged_read(ckv_p, page_table)     # (B, Pmax*PS, rank)
            kr = _paged_read(kr_p, page_table)
            kv_len = lens + 1
        else:
            ckv, kr = cache["ckv"], cache["kr"]
            kv_len = _write_decode(cache_index, b, s, (ckv, ckv_new),
                                   (kr, kr_new))
        scale = (nope + rp) ** -0.5

        def absorbed(qn, qr, wuk, wuv):
            return _absorbed(qn, qr, wuk, wuv, ckv, kr, kv_len, scale)

        out = _mla_tp_shard(absorbed, q_nope, q_rope, p["w_uk"], p["w_uv"],
                            h)
        new_cache = cache
    else:
        k_nope = torch.einsum("btl,lhn->bthn", ckv_new, p["w_uk"])
        v = torch.einsum("btl,lhv->bthv", ckv_new, p["w_uv"])
        k = torch.cat([k_nope, kr_new[:, :, None, :].expand(b, s, h, rp)],
                      dim=-1)
        out = attention_math(
            constrain(torch.cat([q_nope, q_rope], dim=-1), "heads4"),
            constrain(k, "heads4"), constrain(v, "heads4"), causal=True)
        new_cache = ({"ckv": ckv_new, "kr": kr_new} if return_cache
                     else None)
    return out.reshape(b, s, h * vd).to(x.dtype) @ p["wo"], new_cache


def _rms_split(x, scale, full: int):
    """``_rms`` over a last dimension of which ``x`` is this rank's block
    (``full`` wide in all) and ``scale`` the whole replicated leaf: the
    block's sum of squares summed over tp, as the reference's compiled
    norm does (its mean can differ from one process's by an ulp)."""
    xf = x.to(torch.float32)
    ss = copy_to_tp(reduce_from_tp(xf.square().sum(-1, keepdim=True)))
    y = xf * torch.rsqrt(ss / full + 1e-6)
    return (y * scatter_to_tp(scale, -1).to(torch.float32)).to(x.dtype)


def _latent(x, xc, w, scale, full: int):
    """A latent projection, normed by ``scale`` (None: not normed), on
    this rank's block of ``w``'s columns (``xc`` the input through
    ``copy_to_tp``) and gathered whole, or on the whole ``w`` where it
    is whole."""
    if w.shape[-1] == full:
        return x @ w if scale is None else _rms(x @ w, scale)
    blk = xc @ w
    if scale is not None:
        blk = _rms_split(blk, scale, full)
    return gather_from_tp(blk, -1)


def _head_block(w, full: int, groups: int, heads: slice):
    """``w_uk`` or ``w_uv`` (rank, H, d) from this rank's block of its
    last dimension (or the whole) to the group's heads with the whole
    last dimension, the layout the attention wants. The backward sums one
    rank of each group over tp (the group's ranks repeat its heads), so
    every rank holds the whole gradient before it keeps its block."""
    if w.shape[-1] != full:
        w = gather_from_tp(w, -1)
    return copy_to_tp(w, groups)[:, heads]


def _cache_cols(t, tp):
    """A latent's block in ``cache_specs``' layout: this rank's block of
    its last dimension, the whole where tp does not divide it."""
    d = t.shape[-1]
    return t[..., tp.block(d)] if d % tp.size == 0 else t


def _apply_mla_tp(p, x, cfg: ArchConfig, tp, *, positions, cache,
                  cache_index, return_cache):
    """MLA on this rank's blocks of the compute layout, as the reference's
    compiled steps split it (read from their HLO): ``w_dq``, ``w_dkv``,
    ``w_kr`` and ``w_uq`` column blocks, ``w_uk`` / ``w_uv`` split within
    each head on their last dimension, ``wo`` a row block, the two norms
    whole.

    - The latents are projected on this rank's columns and normed with
      the block's sum of squares summed over tp, then gathered whole; the
      rope key is gathered before its rotation, whose pairs span blocks.
    - The query heads split over g = gcd(H, n) groups of consecutive
      ranks (its ``w_uq`` columns gathered to the group's heads where
      g < n). ``w_uk`` and ``w_uv`` are re-laid from this rank's block of
      every head to the group's heads whole, the reference's all-to-all.
    - Train and prefill attend over the group's heads; ``wo``'s fan-in
      block is this rank's, the partial products summed over tp. A
      prefill returns the cache in ``cache_specs``' layout: this rank's
      block of the latent and of the rope key.
    - A dense decode writes its blocks into that cache, gathers the whole
      cache, and runs the absorbed decode on the group's heads.
    """
    if cache is not None and cache_index is not None and "ckv_pages" in cache:
        raise NotImplementedError("paged decode runs on the serving "
                                  "engine's own TP (dist.sharding.serve_tp)")
    m = cfg.mla
    b, s, _ = x.shape
    H, n = cfg.n_heads, tp.size
    nope, rp, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    groups = math.gcd(H, n)
    heads = tp.block(H, groups)                 # this group's query heads
    gh = H // groups

    xc = copy_to_tp(x)
    cq = _latent(x, xc, p["w_dq"], p["q_norm"], m.q_lora_rank)
    ckv_new = _latent(x, xc, p["w_dkv"], p["kv_norm"], m.kv_lora_rank)
    kr_new = _latent(x, xc, p["w_kr"], None, rp)
    kr_new = apply_rope(kr_new[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    q = copy_to_tp(cq) @ p["w_uq"]
    if groups != n:
        q = gather_from_tp(q, -1, groups)
    q = q.reshape(b, s, gh, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    wuk = _head_block(p["w_uk"], nope, groups, heads)
    wuv = _head_block(p["w_uv"], vd, groups, heads)

    if cache is not None and cache_index is not None:
        ckv, kr = cache["ckv"], cache["kr"]
        kv_len = _write_decode(
            cache_index, b, s,
            (ckv, ckv_new if ckv.shape[-1] == m.kv_lora_rank
             else _cache_cols(ckv_new, tp)),
            (kr, kr_new if kr.shape[-1] == rp else _cache_cols(kr_new, tp)))
        if ckv.shape[-1] != m.kv_lora_rank:
            ckv = gather_from_tp(ckv, -1)
        if kr.shape[-1] != rp:
            kr = gather_from_tp(kr, -1)
        out = _absorbed(q_nope, q_rope, wuk, wuv, ckv, kr, kv_len,
                        (nope + rp) ** -0.5)
        new_cache = cache
    else:
        ckv_c, kr_c = (copy_to_tp(t, groups) for t in (ckv_new, kr_new))
        k_nope = torch.einsum("btl,lhn->bthn", ckv_c, wuk)
        v = torch.einsum("btl,lhv->bthv", ckv_c, wuv)
        k = torch.cat([k_nope, kr_c[:, :, None, :].expand(b, s, gh, rp)],
                      dim=-1)
        out = attention_math(
            constrain(torch.cat([q_nope, q_rope], dim=-1), "heads4"),
            constrain(k, "heads4"), constrain(v, "heads4"), causal=True)
        new_cache = ({"ckv": _cache_cols(ckv_new, tp),
                      "kr": _cache_cols(kr_new, tp)} if return_cache
                     else None)
    out = out.reshape(b, s, gh * vd).to(x.dtype)
    if groups != n:
        out = scatter_to_tp(out, -1, groups)
    return reduce_from_tp(out @ p["wo"]), new_cache
