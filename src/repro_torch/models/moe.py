"""Mixture-of-Experts: top-k token-choice routing with capacity binning
(counterpart of ``repro.models.moe``).

Tokens split into ``n_groups`` contiguous groups, and routing and
capacity are resolved within each group. Dispatch is sort-based binning
(a stable sort by expert id, rank within the expert, overflow past the
capacity dropped), memory O(E*C*d). The experts run as three batched
products over the ``(E, C, d)`` gather, as the reference computes them
outside any Pallas kernel.

No step reads a data-dependent size back to the host, so a decode
superstep runs without a sync. Two choices keep the result a function of
the inputs alone, on any device:

- top-k is a stable descending sort, so tied router scores pick the
  lower expert id first (``jax.lax.top_k``'s order);
- the combine gathers each token's k expert outputs from their
  ``(expert, rank)`` slots and adds them in ascending expert order, where
  the reference scatter-adds (``index_add_`` would use atomics on CUDA,
  a sum in a varying order).

Expert-parallel (:func:`apply_moe` under ``dist.tp``), as the
reference's compiled program splits the block over "model": every rank
computes the router's block of the logits, gathers them whole and routes
alike; it runs its E/n experts on their ``(E/n, C, d)`` slots and adds
its slots of each token in the same ascending order into a partial
``(T, d)``, which one all-reduce sums over tp. That sum is the one
process's up to the order of its terms (for top-2, whose two terms meet
in one addition either way, the same rounding).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.act_sharding import constrain
from repro_torch.dist.tp import (copy_to_tp, current_tp, gather_from_tp,
                                 reduce_from_tp)
from repro_torch.models.layers import (_normal, apply_mlp, dense_init,
                                       init_mlp, param_dtype)


def init_moe(gen, cfg: ArchConfig, moe: MoEConfig, device,
             experts: Optional[slice] = None):
    """Router (d, E) in f32; expert stacks (E, d_in, d_out) with std
    1/sqrt(d_in); shared experts fused into one SwiGLU of width
    n_shared * ff; arctic's dense residual MLP. With ``experts`` each
    stack keeps only those experts, cut from its draw (the same numbers,
    without the whole stack in its dtype)."""
    d, dt = cfg.d_model, param_dtype(cfg)
    e, ff = moe.num_experts, moe.d_ff_expert

    def stack(d_in, d_out):
        return _normal(gen, (e, d_in, d_out), d_in ** -0.5, dt, device,
                       rows=experts)

    p = {"router": dense_init(gen, d, e, torch.float32, device),
         "w_gate": stack(d, ff), "w_up": stack(d, ff),
         "w_down": stack(ff, d)}
    if moe.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=moe.num_shared_experts * ff)
    if moe.dense_residual:
        p["dense"] = init_mlp(gen, cfg, device, d_ff=cfg.d_ff)
    return p


def _capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor
            / moe.num_experts) + 1
    return max(c, 4)


def _route(router, xg, k: int, e: int = 0):
    """f32 router softmax and its top k: (probs (T, E), top_w (T, K)
    renormalised, top_i (T, K)); ties go to the lower expert id. A router
    narrower than ``e`` experts is this rank's block of a column-parallel
    router (``dist.tp``): its logits are gathered whole, bit for bit,
    before the softmax, so every rank routes alike."""
    logits = xg.to(torch.float32) @ router.to(torch.float32)
    if e and router.shape[-1] != e:
        logits = gather_from_tp(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _dispatch_indices(top_i, top_w, e: int, c: int):
    """top_i/top_w: (T, K). Returns token_map (E, C), weight_map (E, C),
    valid (E, C), and slot (T, K): the flat ``e * C + rank`` slot each
    choice landed in, or ``e * C`` where it overflowed the capacity."""
    t, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1).long()
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = _count(se, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[se]   # rank in expert
    valid = pos < c
    lin = torch.where(valid, se * c + pos, torch.full_like(se, e * c))
    # every overflow lands on the extra slot e*c, cut off below; the kept
    # slots are distinct, so the writes are deterministic
    token_map = torch.zeros(e * c + 1, dtype=torch.int32, device=dev)
    weight_map = torch.zeros(e * c + 1, dtype=flat_w.dtype, device=dev)
    valid_map = torch.zeros(e * c + 1, dtype=torch.bool, device=dev)
    token_map[lin] = st.to(torch.int32)
    weight_map[lin] = sw
    valid_map[lin] = True
    slot = torch.empty_like(lin)
    slot[order] = lin
    return (token_map[:-1].reshape(e, c), weight_map[:-1].reshape(e, c),
            valid_map[:-1].reshape(e, c), slot.reshape(t, k))


def _count(ids, n: int):
    """Occurrences of 0..n-1 in ``ids``: an integer scatter-add, which
    (unlike ``torch.bincount`` on CUDA) needs no sync with the host."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _moe_group(p, xg, moe: MoEConfig, c: int, tp=None):
    """xg: (T, d), one dispatch group -> (out (T, d), aux). With ``tp``
    (the expert stacks split over it, :func:`apply_moe`), this rank's
    experts: the routing whole and alike on every rank, this rank's
    ``(E/n, C, d)`` products, and its partial combine summed over tp."""
    t, d = xg.shape
    e, k = moe.num_experts, moe.top_k
    if tp is not None:
        xg = copy_to_tp(xg)          # the router's and the dispatch's dx
    probs, top_w, top_i = _route(p["router"], xg, k, e)
    if tp is not None:
        top_w = copy_to_tp(top_w)    # each rank weighs its experts' slots
    token_map, weight_map, valid, slot = _dispatch_indices(top_i, top_w,
                                                           e, c)
    mine = slice(0, e) if tp is None else tp.block(e)
    el = mine.stop - mine.start
    vmask = valid[mine, :, None].to(xg.dtype)
    xe = xg[token_map[mine].reshape(-1).long()].reshape(el, c, d) * vmask
    g = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(g.to(torch.float32)).to(xg.dtype) * u
    ye = torch.bmm(h, p["w_down"])
    ye = ye * (weight_map[mine, :, None].to(xg.dtype) * vmask)
    # combine: each token's slots in ascending expert order (ascending
    # slot), the overflow slot reading a zero row; under tp so does a
    # slot of another rank's expert, and the partial sums are summed
    ye = torch.cat([ye.reshape(el * c, d), ye.new_zeros(1, d)])
    slot = slot.sort(dim=-1).values
    if tp is not None:
        slot = slot - mine.start * c
        slot = torch.where((slot >= 0) & (slot < el * c), slot, el * c)
    out = ye[slot[:, 0]]
    for j in range(1, k):
        out = out + ye[slot[:, j]]
    if tp is not None:
        out = reduce_from_tp(out)
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = _count(top_i.reshape(-1), e).to(torch.float32) / (t * k)
    aux = e * torch.sum(me * probs.mean(0))
    return out, aux


def apply_moe(p, x, cfg: ArchConfig, moe: MoEConfig,
              n_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux loss scalar (mean over groups).

    Under a tensor-parallel context (``dist.tp``) whose compute layout
    splits the expert stacks (their local E short of ``num_experts``:
    the ep axes, equal to the tp axes, divide E), expert-parallel: the
    router's block of the logits gathered whole, so every rank routes
    alike and drops the same overflow; this rank's E/n experts on its
    slots; the combine summed over tp. The shared experts and arctic's
    dense residual take ``layers.apply_mlp``'s column/row forms where
    their hidden width is split. Where the stacks are whole (an extent
    that does not divide E), the block computes whole on every rank."""
    b, s, d = x.shape
    tokens = b * s
    if tokens % n_groups:
        n_groups = 1
    tpg = tokens // n_groups
    c = _capacity(tpg, moe)
    tp = current_tp()
    if tp is not None and p["w_gate"].shape[0] == moe.num_experts:
        tp = None
    xg = constrain(x.reshape(n_groups, tpg, d), "moe_tokens")
    outs, auxs = zip(*(_moe_group(p, g, moe, c, tp) for g in xg))
    out = constrain(torch.stack(outs), "moe_tokens").reshape(b, s, d)
    if moe.num_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg,
                              d_ff=moe.num_shared_experts
                              * moe.d_ff_expert)
    if moe.dense_residual:
        out = out + apply_mlp(p["dense"], x, cfg)
    return out, torch.stack(auxs).mean()
