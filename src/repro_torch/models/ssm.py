"""State-space mixers: Mamba-1 selective scan (Jamba) and RWKV-6 Finch
(counterpart of ``repro.models.ssm``).

Training and prefill scan the sequence in chunks of ``SCAN_CHUNK``: a
log-depth (doubling) scan inside each chunk, then one carry from chunk
to chunk; decode is one O(1) state update, written into the cache in
place. RWKV-6's WKV recurrence is the sequential per-token scan, or the
chunked matmul form where ``RWKVConfig.chunk`` asks for it. All plain
torch, as the reference computes them outside any Pallas kernel. The
doubling scan sums in another order than ``lax.associative_scan``, so it
agrees with the reference within f32 rounding, not bit for bit.

The reference's limits are kept, not repaired: a Mamba scan over S
tokens needs ``S % min(SCAN_CHUNK, S) == 0``, and a prefill's conv tail
holds ``min(S, d_conv - 1)`` rows (ROADMAP Queue 3).

Under tensor-parallel compute (``dist.tp``: the placed train step, the
general step and ``launch.serve``'s steps on a mesh) Mamba runs on this
rank's blocks of the reference's compute layout (``_apply_mamba_tp``):
its inner width di split over tp, ``a_log`` and the decode cache's
state ``h`` split over d_state, ``w_out``'s fan-in block summed over
tp; and RWKV-6 on its weights' column blocks (``_apply_rwkv_time_tp``,
``_apply_rwkv_channel_tp``): its WKV scan on a head group's heads, its
decode on a block of every head's value columns.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.act_sharding import constrain
from repro_torch.dist.tp import (copy_to_tp, current_tp, fan_in_dot,
                                 gather_from_tp, reduce_from_tp,
                                 scatter_to_tp)
from repro_torch.models.layers import (_normal, apply_group_norm,
                                       dense_init, param_dtype)

SCAN_CHUNK = 256


# ---------------------------------------------------------------------------
# linear-recurrence helpers


def chunked_linear_scan(a, b, h0, chunk: int = SCAN_CHUNK):
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, S, ...).

    Returns (h_all (B, S, ...), h_last). Raises where the reference's
    assert fails: S not a multiple of min(chunk, S). Every chunk is
    scanned at once, then the state carried from chunk to chunk: the
    same operations on the same numbers as one chunk at a time."""
    s = a.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"linear scan over {s} steps needs a multiple of "
                         f"the chunk {c}")
    k = s // c
    pa = a.reshape(a.shape[0], k, c, *a.shape[2:])
    pb = b.reshape(pa.shape)
    off = 1
    while off < c:                # inclusive scan by doubling, per chunk
        pa, pb = (torch.cat([pa[:, :, :off],
                             pa[:, :, off:] * pa[:, :, :-off]], 2),
                  torch.cat([pb[:, :, :off],
                             pb[:, :, :-off] * pa[:, :, off:]
                             + pb[:, :, off:]], 2))
        off *= 2
    starts, h = [], h0
    for i in range(k):            # each chunk's starting state
        starts.append(h)
        h = pb[:, i, -1] + pa[:, i, -1] * h
    hs = pb + pa * torch.stack(starts, 1)[:, :, None]
    return hs.reshape(b.shape), h


# ---------------------------------------------------------------------------
# Mamba


def _dt_rank(cfg: ArchConfig) -> int:
    r = cfg.ssm.dt_rank
    return r if r else math.ceil(cfg.d_model / 16)


def init_mamba(gen, cfg: ArchConfig, device):
    ssm = cfg.ssm
    d, dt = cfg.d_model, param_dtype(cfg)
    di = ssm.expand * d
    rank = _dt_rank(cfg)
    # log(1..N) made on the host and moved: a first log or arange on the
    # meta device loads its Python kernels, seconds in a fresh process
    a_log = torch.log(torch.arange(1, ssm.d_state + 1, dtype=torch.float32))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, d, 2 * di, dt, device),
        "conv_w": _normal(gen, (ssm.d_conv, di), 0.1, dt, device),
        "conv_b": torch.zeros(di, dtype=dt, device=device),
        "x_proj": dense_init(gen, di, rank + 2 * ssm.d_state, dt, device),
        "dt_w": dense_init(gen, rank, di, dt, device),
        "dt_b": torch.full((di,), -4.6, **f32),    # softplus^-1(0.01)
        "a_log": a_log.expand(di, ssm.d_state).contiguous().to(device),
        "d": torch.ones(di, **f32),
        "w_out": dense_init(gen, di, d, dt, device),
    }


def _mamba_conv_train(p, xh):
    """Causal depthwise conv over the sequence. xh: (B, S, di)."""
    w = p["conv_w"].to(xh.dtype)                   # (K, di)
    k, s = w.shape[0], xh.shape[1]
    pad = F.pad(xh, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + p["conv_b"].to(xh.dtype)


def apply_mamba(p, x, cfg: ArchConfig, *, cache=None, return_cache=False):
    """x: (B, S, d). cache: {"h": (B, di, N) f32, "conv": (B, K-1, di)};
    with S == 1 a decode step that writes the cache in place."""
    ssm = cfg.ssm
    b, s, d = x.shape
    di, n = ssm.expand * d, ssm.d_state
    rank = _dt_rank(cfg)
    tp = current_tp()
    if tp is not None and p["w_in"].shape[-1] != 2 * di:
        return _apply_mamba_tp(p, x, cfg, tp, cache=cache,
                               return_cache=return_cache)

    xz = x @ p["w_in"]
    xh, z = constrain(xz[..., :di], "ffn"), constrain(xz[..., di:], "ffn")
    decode = cache is not None and s == 1
    if decode:
        window = torch.cat([cache["conv"], xh], dim=1)      # (B, K, di)
        new_conv = window[:, 1:]
        xh = (torch.einsum("bkd,kd->bd", window,
                           p["conv_w"].to(xh.dtype))[:, None]
              + p["conv_b"].to(xh.dtype))
    else:
        xh = _mamba_conv_train(p, xh)
    xh = F.silu(xh.to(torch.float32)).to(x.dtype)

    dbc = xh @ p["x_proj"]
    dt_in, b_, c_ = (dbc[..., :rank], dbc[..., rank:rank + n],
                     dbc[..., rank + n:])
    delta = F.softplus((dt_in @ p["dt_w"]).to(torch.float32)
                       + p["dt_b"])                    # (B, S, di) f32
    a = -torch.exp(p["a_log"])                         # (di, N)
    abar = torch.exp(delta[..., None] * a)             # (B, S, di, N)
    bx = ((delta * xh.to(torch.float32))[..., None]
          * b_.to(torch.float32)[:, :, None, :])       # (B, S, di, N)

    new_cache = None
    if decode:
        h = abar[:, 0] * cache["h"] + bx[:, 0]         # (B, di, N)
        y = torch.einsum("bdn,bn->bd", h,
                         c_.to(torch.float32)[:, 0])[:, None]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        h0 = (cache["h"] if cache is not None
              else torch.zeros(b, di, n, dtype=torch.float32,
                               device=x.device))
        hs, h_last = chunked_linear_scan(abar, bx, h0)
        y = torch.einsum("bsdn,bsn->bsd", hs, c_.to(torch.float32))
        if return_cache:
            k = p["conv_w"].shape[0]
            tail = x[:, -(k - 1):] @ p["w_in"]
            new_cache = {"h": h_last, "conv": tail[..., :di]}

    y = y + p["d"] * xh.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z.to(torch.float32)).to(x.dtype)
    return y @ p["w_out"], new_cache


def _apply_mamba_tp(p, x, cfg: ArchConfig, tp, *, cache, return_cache):
    """Mamba on this rank's blocks of the compute layout, as the reference's
    compiled steps split it (read from their HLO): ``w_in`` and ``x_proj``
    on their fan-out columns, ``conv_w``, ``conv_b``, ``dt_w``, ``dt_b``
    and ``d`` on a block of di, ``a_log`` on a block of d_state, ``w_out``
    on its fan-in rows.

    - ``xz`` is computed on this rank's columns, which lie in the ``xh``
      half or the ``z`` half, and re-laid to this rank's block of di in
      each (the reference's collective-permutes; here one gather of
      ``xz`` whole, its gradient summed back to the columns).
    - The causal conv runs on the di block. ``xh`` is gathered whole for
      ``x_proj``; its columns' products (dt, B, C) are gathered whole and
      their gradients summed over tp, as is ``xh``'s.
    - Train and prefill scan this rank's block of di over every state,
      ``a_log`` re-laid to that block (the reference's all-to-all). A
      prefill returns the cache in ``cache_specs``' layout: ``h`` on this
      rank's block of d_state, ``conv`` on its block of di.
    - A decode updates its block of d_state of ``h`` from ``delta``
      gathered whole and sums ``y``'s partial dots over tp.
    - ``w_out``'s partial products are summed over tp.

    Where tp does not divide ``x_proj``'s fan-out or d_state, that leaf
    and ``h`` are whole, as the reference's ``fit`` leaves them.
    """
    ssm = cfg.ssm
    b, s, d = x.shape
    di, n = ssm.expand * d, ssm.d_state
    rank = _dt_rank(cfg)
    decode = cache is not None and s == 1
    if cache is not None and not decode:
        raise NotImplementedError("a prefill over a given Mamba state runs "
                                  "whole (no tensor-parallel form)")
    split_n = p["a_log"].shape[-1] != n

    xz = gather_from_tp(copy_to_tp(x) @ p["w_in"], -1)     # (B, S, 2 di)
    xz = scatter_to_tp(xz.reshape(b, s, 2, -1), -1)        # this di block
    xh, z = constrain(xz[:, :, 0], "ffn"), constrain(xz[:, :, 1], "ffn")
    if decode:
        window = torch.cat([cache["conv"], xh], dim=1)      # (B, K, di/n)
        new_conv = window[:, 1:]
        xc = (torch.einsum("bkd,kd->bd", window,
                           p["conv_w"].to(xh.dtype))[:, None]
              + p["conv_b"].to(xh.dtype))
    else:
        xc = _mamba_conv_train(p, xh)
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)

    xw = gather_from_tp(xc, -1)                             # (B, S, di)
    if p["x_proj"].shape[-1] == rank + 2 * n:
        dbc = copy_to_tp(xw @ p["x_proj"])
    else:
        dbc = copy_to_tp(gather_from_tp(copy_to_tp(xw) @ p["x_proj"], -1))
    dt_in, b_, c_ = (dbc[..., :rank], dbc[..., rank:rank + n],
                     dbc[..., rank + n:])
    delta = F.softplus((dt_in @ p["dt_w"]).to(torch.float32)
                       + p["dt_b"])                    # (B, S, di/n) f32

    new_cache = None
    if decode:
        # this rank's block of d_state, every channel
        nb = tp.block(n) if split_n else slice(None)
        dw = gather_from_tp(delta, -1)[:, 0]                # (B, di)
        a = -torch.exp(p["a_log"])                          # (di, N/n)
        h = (torch.exp(dw[..., None] * a) * cache["h"]
             + (dw * xw[:, 0].to(torch.float32))[..., None]
             * b_[:, 0, nb].to(torch.float32)[:, None])     # (B, di, N/n)
        y = torch.einsum("bdn,bn->bd", h, c_[:, 0, nb].to(torch.float32))
        if split_n:
            y = reduce_from_tp(y)
        y = y[:, None, tp.block(di)]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        # this rank's block of di, every state
        a_log = p["a_log"] if not split_n else gather_from_tp(p["a_log"], -1)
        a = -torch.exp(copy_to_tp(a_log)[tp.block(di)])     # (di/n, N)
        abar = torch.exp(delta[..., None] * a)              # (B, S, di/n, N)
        bx = ((delta * xc.to(torch.float32))[..., None]
              * b_.to(torch.float32)[:, :, None, :])
        h0 = torch.zeros(b, a.shape[0], n, dtype=torch.float32,
                         device=x.device)
        hs, h_last = chunked_linear_scan(abar, bx, h0)
        y = torch.einsum("bsdn,bsn->bsd", hs, c_.to(torch.float32))
        if return_cache:
            h_all = tp.gather(h_last.detach(), 1)           # (B, di, N)
            k = p["conv_w"].shape[0]
            new_cache = {"h": tp.keep(h_all, -1) if split_n else h_all,
                         "conv": xh[:, -(k - 1):].detach().contiguous()}

    y = y + p["d"] * xc.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z.to(torch.float32)).to(x.dtype)
    return reduce_from_tp(y @ p["w_out"]), new_cache


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)


def init_rwkv(gen, cfg: ArchConfig, device):
    rw = cfg.rwkv
    d, dt = cfg.d_model, param_dtype(cfg)
    h = d // rw.head_dim
    la, lw = rw.ddlerp_lora, rw.decay_lora
    return {
        # token-shift data-dependent lerp
        "mu_x": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),  # w,k,v,r,g
        "dd_w1": dense_init(gen, d, 5 * la, dt, device),
        "dd_w2": _normal(gen, (5, la, d), 0.01, dt, device),
        # projections
        "w_r": dense_init(gen, d, d, dt, device),
        "w_k": dense_init(gen, d, d, dt, device),
        "w_v": dense_init(gen, d, d, dt, device),
        "w_g": dense_init(gen, d, d, dt, device),
        "w_o": dense_init(gen, d, d, dt, device),
        # data-dependent decay
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_a": dense_init(gen, d, lw, dt, device),
        "w_b": dense_init(gen, lw, d, dt, device),
        # per-head bonus
        "u": _normal(gen, (h, rw.head_dim), 0.1, torch.float32, device),
    }


def init_rwkv_channel(gen, cfg: ArchConfig, device):
    d, dt = cfg.d_model, param_dtype(cfg)
    return {
        "cm_mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "cm_mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "cm_wr": dense_init(gen, d, d, dt, device),
        "cm_wk": dense_init(gen, d, cfg.d_ff, dt, device),
        "cm_wv": dense_init(gen, cfg.d_ff, d, dt, device),
    }


def _token_shift(x, last=None):
    """xx_t = x_{t-1}; the first position takes ``last`` (decode cache)
    or 0."""
    if x.shape[1] == 1:
        return last[:, None] if last is not None else torch.zeros_like(x)
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        prev[:, 0] = last
    return prev


def _wkv_scan(r, k, v, w, u, s0):
    """RWKV-6 recurrence, one token at a time. r, k, v, w: (B, S, H, D)
    (w the decay in (0, 1)); u: (H, D); state s0 (B, H, D, D) keyed
    [key, value]. Returns (y (B, S, H, D), s_last)."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, Dk, Dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[:, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = 32):
    """Chunked-parallel RWKV-6 recurrence (matmul form). Within a chunk
    of C steps the pairwise decay prod_{u=s+1}^{t-1} w_u =
    exp(L_{t-1} - L_s) (L = cumsum log w) is split as
    exp(L_{t-1} - m) * exp(m - L_s) with the per-channel shift
    m = L_C / 2, keeping both factors in f32 range for C <= 32."""
    b, s, h, d = r.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunked WKV over {s} steps needs a multiple of "
                         f"the chunk {c}")
    tri = torch.tril(torch.ones(c, c, dtype=torch.float32,
                                device=r.device), diagonal=-1)
    state, ys = s0, []
    for i in range(s // c):
        rc, kc, vc, wc = (t[:, i * c:(i + 1) * c] for t in (r, k, v, w))
        lw = torch.log(torch.clamp(wc, min=1e-38))
        big_l = torch.cumsum(lw, dim=1)          # L_t (inclusive)
        l_prev = big_l - lw                      # L_{t-1}
        # chunk-start state: decay prod_{u<t} w_u = exp(L_{t-1})
        y_state = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(l_prev),
                               state)
        # intra-chunk pairs (s < t)
        m = big_l[:, -1:] * 0.5
        qh = rc * torch.exp(l_prev - m)
        kh = kc * torch.exp(m - big_l)
        scores = torch.einsum("bchk,bshk->bhcs", qh, kh) * tri
        y_intra = torch.einsum("bhcs,bshv->bchv", scores, vc)
        # diagonal (s = t) with the u bonus
        dot = torch.einsum("bchk,hk->bch", rc * kc, u)
        ys.append(y_state + y_intra + dot[..., None] * vc)
        # carry: diag(exp(L_C)) state + sum_s exp(L_C - L_s) k_s v_s
        kd = kc * torch.exp(big_l[:, -1:] - big_l)
        state = (torch.exp(big_l[:, -1])[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", kd, vc))
    return torch.cat(ys, 1), state


def apply_rwkv_time(p, x, cfg: ArchConfig, *, cache=None,
                    return_cache=False):
    """RWKV-6 time mix. cache: {"wkv": (B, H, D, D) f32, "tm_x": (B, d)};
    a call with a cache writes it in place and returns it."""
    rw = cfg.rwkv
    b, s, d = x.shape
    h, hd = d // rw.head_dim, rw.head_dim
    tp = current_tp()
    if tp is not None and (p["w_r"].shape[-1] != d
                           or tp.idle and cache is not None):
        return _apply_rwkv_time_tp(p, x, cfg, tp, cache=cache,
                                   return_cache=return_cache)

    last = cache["tm_x"] if cache is not None else None
    dx = _token_shift(x, last) - x
    xbase = x + dx * p["mu_x"]
    la = p["dd_w1"].shape[1] // 5
    dd = torch.tanh((xbase @ p["dd_w1"]).reshape(b, s, 5, la))
    dd = torch.einsum("bsfl,fld->bsfd", dd, p["dd_w2"])    # (B, S, 5, d)
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu"][None, None] + dd)
    xw, xk, xv, xr, xg = (mixed[:, :, i] for i in range(5))

    r = constrain((xr @ p["w_r"]).reshape(b, s, h, hd), "heads4")
    k = constrain((xk @ p["w_k"]).reshape(b, s, h, hd), "heads4")
    v = constrain((xv @ p["w_v"]).reshape(b, s, h, hd), "heads4")
    g = F.silu((xg @ p["w_g"]).to(torch.float32)).to(x.dtype)
    wdec = torch.exp(-torch.exp(
        p["w0"] + (torch.tanh(xw @ p["w_a"]) @ p["w_b"]).to(torch.float32)
    )).reshape(b, s, h, hd)

    s0 = (cache["wkv"] if cache is not None
          else torch.zeros(b, h, hd, hd, dtype=torch.float32,
                           device=x.device))
    f32 = [t.to(torch.float32) for t in (r, k, v)]
    ck = rw.chunk
    if ck and s > 1 and s % min(ck, s) == 0:
        y, s_last = _wkv_chunked(*f32, wdec, p["u"], s0, chunk=ck)
    else:
        y, s_last = _wkv_scan(*f32, wdec, p["u"], s0)
    y = apply_group_norm(y.to(x.dtype))
    out = (y.reshape(b, s, d) * g.reshape(b, s, d)) @ p["w_o"]
    new_cache = None
    if cache is not None:
        cache["wkv"].copy_(s_last)
        cache["tm_x"].copy_(x[:, -1])
        new_cache = cache
    elif return_cache:
        new_cache = {"wkv": s_last, "tm_x": x[:, -1]}
    return out, new_cache


def apply_rwkv_channel(p, x, cfg: ArchConfig, *, cache=None,
                       return_cache=False):
    """RWKV-6 channel mix (squared-ReLU FFN with a receptance gate).
    cache: {"cm_x": (B, d)}, written in place."""
    tp = current_tp()
    if tp is not None and (p["cm_wr"].shape[-1] != x.shape[-1]
                           or tp.idle and cache is not None):
        return _apply_rwkv_channel_tp(p, x, tp, cache=cache,
                                      return_cache=return_cache)
    last = cache["cm_x"] if cache is not None else None
    dx = _token_shift(x, last) - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    r = torch.sigmoid((xr @ p["cm_wr"]).to(torch.float32)).to(x.dtype)
    k = constrain(xk @ p["cm_wk"], "ffn")
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    out = r * (k @ p["cm_wv"])
    new_cache = None
    if cache is not None:
        cache["cm_x"].copy_(x[:, -1])
        new_cache = cache
    elif return_cache:
        new_cache = {"cm_x": x[:, -1]}
    return out, new_cache


# ---------------------------------------------------------------------------
# RWKV-6 over tp


def _gather_last(*xs, groups: int = 1, partial: bool = False):
    """Each of ``xs`` from this rank's block of its last dimension to its
    group's block (``groups`` = 1: the whole), all in one all-reduce in
    their widest dtype (each cast back, exactly); the backward keeps this
    rank's block of each. ``partial``: each is a ``dist.tp.fan_in_dot``
    product, summed over the idle dp axes in the same all-reduce."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in xs))
    flat = gather_from_tp(torch.cat([t.reshape(1, -1).to(dt) for t in xs],
                                    1), 0, groups,
                          partial)                   # (ranks of the group, .)
    out, off = [], 0
    for t in xs:
        part = flat[:, off:off + t.numel()].reshape(-1, *t.shape)
        out.append(part.movedim(0, -2).reshape(*t.shape[:-1], -1)
                   .to(t.dtype))
        off += t.numel()
    return out


def _group_wkv_state(tp, s_last, h: int, groups: int):
    """The cache's ``wkv`` in ``cache_specs``' layout (every head, this
    rank's block of value columns) from each group's state of its heads
    (B, H/groups, Dk, Dv): the first rank of each group writes its heads
    into ``-0.0`` pads, one all-reduce joins them (no autograd)."""
    b, hg, dk, dv = s_last.shape
    buf = torch.full((b, h, dk, dv), -0.0, dtype=s_last.dtype,
                     device=s_last.device)
    if tp.leads(groups):
        buf[:, tp.block(h, groups)] = s_last.detach()
    return tp.keep(tp.all_reduce(buf), -1)


def _apply_rwkv_time_tp(p, x, cfg: ArchConfig, tp, *, cache, return_cache):
    """RWKV-6's time mix on this rank's blocks of the compute layout, as
    the reference's compiled steps split it (read from their HLO): every
    weight a column weight, ``w_o`` too, so each projection's fan-out
    (``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o``, ``dd_w1``, ``w_a``,
    ``w_b``, ``dd_w2``) and ``mu``, ``mu_x`` and ``w0`` are this rank's
    block of columns, ``u`` whole. The residual ``x`` is whole on every
    rank, as the other families' under ``dist.tp``.

    - ``mu_x`` is gathered whole (with the decode's ``tm_x``), so the
      token shift's ``xbase`` is whole; ``dd_w1``'s columns, then
      ``mu + dd`` (``dd_w2``'s and ``mu``'s columns), then ``tanh(xw
      w_a)`` are gathered whole: the five mixed inputs are whole on
      every rank.
    - Train and prefill scan the heads of this rank's group (the heads
      over gcd(H, tp) groups of consecutive ranks, which repeat their
      group's scan): r, k, v and the decay gathered to the group's
      columns in one all-reduce, ``u`` cut to the group's heads. The
      normed output is cut back to this rank's columns for ``g``, and
      ``y * g`` gathered whole for ``w_o``. A prefill returns ``wkv`` in
      ``cache_specs``' layout, every head and this rank's block of value
      columns, and ``tm_x`` this rank's columns.
    - A decode updates its block of value columns of every head from r,
      k, w and g gathered whole (with v, which it cuts to the block),
      and gathers ``y`` whole for the group norm.
    - ``w_o``'s columns are gathered whole into the residual.
    - Where the decode's batch leaves dp axes idle (``tp.idle``), each
      projection with a fan-in of d (``dd_w1``, ``w_a``, ``w_r``,
      ``w_k``, ``w_v``, ``w_g``, ``w_o``) takes this rank's block of it
      over them (``dist.tp.fan_in_dot``) and its gather sums the partial
      products (the reference's HLO at a batch of one; ``dd_w2`` and
      ``w_b``, fan-ins of the LoRA widths, stay whole). A tp extent of
      one takes this form too, its gathers over tp none.

    Where tp does not divide ``dd_w1``'s or ``w_a``'s fan-out, that
    leaf is whole, as the reference's ``fit`` leaves it, and computes
    whole."""
    rw = cfg.rwkv
    b, s, d = x.shape
    h, hd = d // rw.head_dim, rw.head_dim
    decode = cache is not None and s == 1
    if cache is not None and not decode:
        raise NotImplementedError("a prefill over a given RWKV state runs "
                                  "whole (no tensor-parallel form)")
    groups = math.gcd(h, tp.size)
    cols = tp.block(d)

    if decode:
        mu_x, last = _gather_last(p["mu_x"][None], cache["tm_x"])
        mu_x = mu_x[0]
    else:
        mu_x, last = gather_from_tp(p["mu_x"], -1), None
    dx = _token_shift(x, last) - x
    xbase = x + dx * mu_x
    la = cfg.rwkv.ddlerp_lora
    dot = fan_in_dot if decode else torch.matmul
    if p["dd_w1"].shape[-1] * tp.size != 5 * la:        # whole
        dd = xbase @ p["dd_w1"]
    else:
        dd = gather_from_tp(dot(copy_to_tp(xbase), p["dd_w1"]), -1,
                            partial=decode)
    dd = copy_to_tp(torch.tanh(dd).reshape(b, s, 5, la))
    mix = gather_from_tp(p["mu"] + torch.einsum("bsfl,fld->bsfd", dd,
                                                p["dd_w2"]), -1)
    mixed = x[:, :, None] + dx[:, :, None] * mix       # (B, S, 5, d)
    cm = copy_to_tp(mixed)
    xw, xk, xv, xr, xg = (cm[:, :, i] for i in range(5))

    r, k, v, g = (dot(t, p[w]) for t, w in ((xr, "w_r"), (xk, "w_k"),
                                             (xv, "w_v"), (xg, "w_g")))
    if p["w_a"].shape[-1] * tp.size != rw.decay_lora:   # whole
        a = mixed[:, :, 0] @ p["w_a"]
        if decode:
            r, k, v, g = _gather_last(r, k, v, g, partial=True)
    elif decode:
        a, r, k, v, g = _gather_last(dot(xw, p["w_a"]), r, k, v, g,
                                     partial=True)
    else:
        a = gather_from_tp(xw @ p["w_a"], -1)
    g = F.silu(g.to(torch.float32)).to(x.dtype)        # (B, S, d/n)
    wdec = torch.exp(-torch.exp(
        p["w0"] + (copy_to_tp(torch.tanh(a)) @ p["w_b"]).to(torch.float32)))

    new_cache = None
    if decode:
        (wdec,) = _gather_last(wdec)
        vb = tp.block(hd)
        r, k, w = (t.reshape(b, h, hd).to(torch.float32)
                   for t in (r[:, 0], k[:, 0], wdec[:, 0]))
        v = v[:, 0].reshape(b, h, hd)[..., vb].to(torch.float32)
        kv = k[..., :, None] * v[..., None, :]          # (B, H, Dk, Dv/n)
        st = cache["wkv"]
        y = torch.einsum("bhk,bhkv->bhv", r,
                         st + p["u"][:, :, None] * kv)
        st.copy_(w[..., :, None] * st + kv)
        cache["tm_x"].copy_(x[:, -1, cols])
        new_cache = cache
        (y,) = _gather_last(y.to(x.dtype))               # (B, H, Dv)
        y = apply_group_norm(y[:, None])
        yg = y.reshape(b, 1, d) * g
        out = fan_in_dot(copy_to_tp(yg), p["w_o"])
    else:
        heads = tp.block(h, groups)
        grp = ((r, k, v, wdec) if groups == tp.size
               else _gather_last(r, k, v, wdec, groups=groups))
        r, k, v, wdec = (constrain(t.reshape(b, s, -1, hd), "heads4")
                         for t in grp)
        u = copy_to_tp(p["u"], groups)[heads]
        s0 = torch.zeros(b, r.shape[2], hd, hd, dtype=torch.float32,
                         device=x.device)
        f32 = [t.to(torch.float32) for t in (r, k, v)]
        ck = rw.chunk
        if ck and s > 1 and s % min(ck, s) == 0:
            y, s_last = _wkv_chunked(*f32, wdec, u, s0, chunk=ck)
        else:
            y, s_last = _wkv_scan(*f32, wdec, u, s0)
        y = apply_group_norm(y.to(x.dtype)).reshape(b, s, -1)
        if groups != tp.size:
            y = scatter_to_tp(y, -1, groups)               # (B, S, d/n)
        (yg,) = _gather_last(y * g)
        out = copy_to_tp(yg) @ p["w_o"]
        if return_cache:
            new_cache = {"wkv": _group_wkv_state(tp, s_last, h, groups),
                         "tm_x": x[:, -1, cols].detach().contiguous()}
    return gather_from_tp(out, -1, partial=decode), new_cache


def _apply_rwkv_channel_tp(p, x, tp, *, cache, return_cache):
    """RWKV-6's channel mix on this rank's columns of ``cm_wr``, ``cm_wk``
    and ``cm_wv`` (a column weight: its fan-in whole) and of ``cm_mu_k``
    and ``cm_mu_r``: the two mixes' weights gathered whole (with the
    decode's ``cm_x``), the squared-ReLU ``k`` gathered whole for
    ``cm_wv``, the gated output's columns gathered whole into the
    residual. The cache's ``cm_x`` is this rank's columns. Where the
    decode's batch leaves dp axes idle (``tp.idle``), the three dots take
    this rank's block of their fan-in over them: ``cm_wr``'s and
    ``cm_wk``'s partial products summed and gathered whole in one
    all-reduce (``r`` then cut to this rank's columns), ``cm_wv``'s with
    the output's."""
    cols = tp.block(x.shape[-1])
    split = bool(tp.idle) and cache is not None
    mus = torch.stack([p["cm_mu_k"], p["cm_mu_r"]])
    if cache is not None:
        mus, last = _gather_last(mus, cache["cm_x"])
    else:
        (mus,), last = _gather_last(mus), None
    dx = _token_shift(x, last) - x
    xkr = copy_to_tp(x[:, :, None] + dx[:, :, None] * mus)  # (B, S, 2, d)
    if split:
        r, k = _gather_last(fan_in_dot(xkr[:, :, 1], p["cm_wr"]),
                            fan_in_dot(xkr[:, :, 0], p["cm_wk"]),
                            partial=True)
        r = r[..., cols]
    else:
        r, k = xkr[:, :, 1] @ p["cm_wr"], xkr[:, :, 0] @ p["cm_wk"]
    k = constrain(k, "ffn")
    r = torch.sigmoid(r.to(torch.float32)).to(x.dtype)
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    if not split:
        (k,) = _gather_last(k)
    dot = fan_in_dot if split else torch.matmul
    out = gather_from_tp(r * dot(copy_to_tp(k), p["cm_wv"]), -1,
                         partial=split)
    new_cache = None
    if cache is not None:
        cache["cm_x"].copy_(x[:, -1, cols])
        new_cache = cache
    elif return_cache:
        new_cache = {"cm_x": x[:, -1, cols].detach().contiguous()}
    return out, new_cache
