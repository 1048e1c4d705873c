"""Model assembly: any ``ArchConfig`` -> init / train-forward / prefill /
decode (counterpart of ``repro.models.model``), and the losses.

Parameters and caches keep the reference's pytree: ``params["blocks"]``
and every cache are tuples over the layer pattern's positions (jamba:
8, every other arch: 1) whose leaves carry a leading ``n_periods`` axis,
with JAX's ``(d_in, d_out)`` weight layouts, so ``params_from_jax``
carries a JAX parameter tree over leaf for leaf and both packages
compute the same function. Where the reference scans the periods with
``lax.scan``, the port loops over them, each layer reading views of the
stacked leaves. A decode writes its cache in place (attention KV, MLA
latents, Mamba and RWKV state) and returns it.

Layer kinds: ``attn`` (GQA, or MLA where ``cfg.attention == "mla"``),
``mamba`` and ``rwkv``; FFNs: dense MLP, MoE (on the layers
``cfg.moe_on_layer`` picks) or RWKV's channel mix; encoder-decoder archs
(whisper) add a cross-attention block to each decoder layer and run the
encoder over ``enc_embed``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.dist.act_sharding import (constrain, constrain_tree,
                                           current_placement, strip_leading)
from repro_torch.dist.tp import (current_tp, gather_from_tp, reduce_from_tp,
                                 tp_context)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


# ---------------------------------------------------------------------------
# init


def _init_layer(gen, cfg: ArchConfig, kind: str, layer_idx: int, device,
                cross: bool = False, experts: Optional[slice] = None):
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, device),
                         "norm2": L.init_norm(cfg, device)}
    if kind == "attn":
        p["mixer"] = (A.init_mla(gen, cfg, device) if cfg.attention == "mla"
                      else A.init_gqa(gen, cfg, device))
    elif kind == "mamba":
        p["mixer"] = S.init_mamba(gen, cfg, device)
    elif kind == "rwkv":
        p["mixer"] = S.init_rwkv(gen, cfg, device)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "rwkv":
        p["ffn"] = S.init_rwkv_channel(gen, cfg, device)
    elif cfg.moe_on_layer(layer_idx):            # the global layer index
        p["ffn"] = M.init_moe(gen, cfg, cfg.moe, device, experts=experts)
    else:
        p["ffn"] = L.init_mlp(gen, cfg, device)
    if cross:
        p["norm_x"] = L.init_norm(cfg, device)
        p["cross"] = A.init_gqa(gen, cfg, device)
    return p


def _stack(per_layer):
    """[layer0_tree, layer1_tree, ...] (parameters or prefill caches) ->
    leaves stacked on axis 0. Empties the per-layer trees leaf by leaf as
    it goes, so at most one leaf is held twice (one layer: a view, no
    copy)."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([p.pop(k) for p in per_layer]) for k in list(first)}
    if len(per_layer) == 1:
        return first[None]
    if first.device.type == "meta":
        # the shape alone: a first stack on the meta device loads torch's
        # Python meta kernels, seconds in a fresh process
        return torch.empty((len(per_layer),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
    return torch.stack(per_layer)


def _unstack(tree, n: int):
    """The inverse of :func:`_stack`: n per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, 0)


def init_model(generator: Optional[torch.Generator], cfg: ArchConfig,
               device="cuda", max_pos: int = 32768,
               experts: Optional[slice] = None):
    """Random weights with the reference's distributions (normal weights
    scaled by 1/sqrt(d_in), embeddings by 0.02, unit norms, zero biases,
    the SSM and router leaves in f32), each leaf drawn in f32 on the
    generator's device, then cast to ``param_dtype`` and moved to
    ``device``. ``device="meta"`` builds the shapes only (no generator
    needed). ``experts`` keeps only those experts of each MoE stack,
    the same numbers as the whole draw's (``launch.serve.init_params``)."""
    device = resolve_device(device)
    dt = L.param_dtype(cfg)
    params: Dict[str, Any] = {"embed": L.init_embed(generator, cfg, device)}
    if cfg.rope == "learned":
        params["embed"]["pos"] = L._normal(generator, (max_pos, cfg.d_model),
                                           0.01, dt, device)
    period = cfg.period
    params["blocks"] = tuple(
        _stack([_init_layer(generator, cfg, kind, pi * period + pos, device,
                            cross=cfg.encoder_decoder, experts=experts)
                for pi in range(cfg.n_periods)])
        for pos, kind in enumerate(cfg.layer_pattern))
    params["norm_f"] = L.init_norm(cfg, device)
    if cfg.encoder_decoder:
        params["encoder"] = _stack([
            _init_layer(generator, cfg, "attn", li, device)
            for li in range(cfg.encoder_layers)])
        params["enc_norm_f"] = L.init_norm(cfg, device)
        params["enc_pos"] = L._normal(generator,
                                      (cfg.encoder_seq, cfg.d_model), 0.01,
                                      dt, device)
    return params


def params_from_jax(tree):
    """A JAX parameter pytree (dicts, tuples, array leaves) -> the same
    tree of CPU tensors, dtype kept (bf16 leaves stay bf16)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v) for v in tree)
    t = torch.from_numpy(np.array(tree, np.float32))
    return t.bfloat16() if str(tree.dtype) == "bfloat16" else t


def tree_to(tree, device):
    """Every tensor leaf of a parameter or cache tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to(v, device) for v in tree)
    return tree.to(device)


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """Dense decode cache, a tuple over the pattern's positions of
    {"mixer", "ffn"[, "cross"]}, each leaf with a leading n_periods axis:
    GQA k/v (P, B, max_len, Hkv, hd) and MLA ckv/kr (P, B, max_len,
    rank|rope) in the compute dtype; Mamba h (P, B, di, N) in f32 and
    conv (P, B, K-1, di); RWKV wkv (P, B, H, D, D) in f32, tm_x and the
    channel mix's cm_x (P, B, d); whisper's cross ck/cv over the
    encoder's frames."""
    device = resolve_device(device)
    dt = L.torch_dtype(cfg.compute_dtype)
    P = cfg.n_periods
    hd = cfg.resolved_head_dim

    def z(*shape, d=dt):
        return torch.zeros((P, batch) + shape, dtype=d, device=device)

    blocks = []
    for kind in cfg.layer_pattern:
        ffn = {}
        if kind == "attn" and cfg.attention == "mla":
            mix = {"ckv": z(max_len, cfg.mla.kv_lora_rank),
                   "kr": z(max_len, cfg.mla.qk_rope_head_dim)}
        elif kind == "attn":
            mix = {"k": z(max_len, cfg.n_kv_heads, hd),
                   "v": z(max_len, cfg.n_kv_heads, hd)}
        elif kind == "mamba":
            di = cfg.ssm.expand * cfg.d_model
            mix = {"h": z(di, cfg.ssm.d_state, d=torch.float32),
                   "conv": z(cfg.ssm.d_conv - 1, di)}
        elif kind == "rwkv":
            h, rd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
            mix = {"wkv": z(h, rd, rd, d=torch.float32),
                   "tm_x": z(cfg.d_model)}
            ffn = {"cm_x": z(cfg.d_model)}
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        blk = {"mixer": mix, "ffn": ffn}
        if cfg.encoder_decoder:
            blk["cross"] = {"ck": z(cfg.encoder_seq, cfg.n_kv_heads, hd),
                            "cv": z(cfg.encoder_seq, cfg.n_kv_heads, hd)}
        blocks.append(blk)
    return tuple(blocks)


# ---------------------------------------------------------------------------
# layer application


def _apply_mixer(p, x, kind, cfg, *, positions, rope, cache, cache_index,
                 return_cache, page_table, impl):
    if kind == "attn" and cfg.attention == "mla":
        return A.apply_mla(p, x, cfg, positions=positions, cache=cache,
                           cache_index=cache_index,
                           return_cache=return_cache, page_table=page_table)
    if kind == "attn":
        return A.apply_gqa(p, x, cfg, rope=rope, cache=cache,
                           cache_index=cache_index,
                           return_cache=return_cache, page_table=page_table,
                           impl=impl)
    if kind == "mamba":
        return S.apply_mamba(p, x, cfg, cache=cache,
                             return_cache=return_cache)
    if kind == "rwkv":
        return S.apply_rwkv_time(p, x, cfg, cache=cache,
                                 return_cache=return_cache)
    raise ValueError(f"unknown layer kind {kind!r}")


def _apply_layer(p, x, kind, cfg, *, layer_idx, positions, rope,
                 moe_groups, cache=None, cache_index=None,
                 return_cache=False, enc_out=None, page_table=None,
                 impl="auto"):
    """Returns (x, aux, new_cache); aux is the MoE load-balance loss, or
    None for a layer without MoE (the reference adds a zero). ``layer_idx``
    is the position in the pattern, as in the reference's forward (its
    init passes the global index: the two agree for every registered
    arch)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    y, new_mix = _apply_mixer(p["mixer"], h, kind, cfg, positions=positions,
                              rope=rope,
                              cache=cache["mixer"] if cache else None,
                              cache_index=cache_index,
                              return_cache=return_cache,
                              page_table=page_table, impl=impl)
    x = constrain(x + y, "act")

    new_cross = None
    if enc_out is not None or (cache and "cross" in cache
                               and cfg.encoder_decoder):
        hx = L.apply_norm(p["norm_x"], x, cfg)
        if cache is not None and cache_index is not None:
            y, new_cross = A.apply_gqa(p["cross"], hx, cfg,
                                       cache=cache["cross"], causal=False)
        else:
            y, new_cross = A.apply_gqa(p["cross"], hx, cfg, kv_x=enc_out,
                                       causal=False,
                                       return_cache=return_cache)
        x = constrain(x + y, "act")

    aux = None
    h = L.apply_norm(p["norm2"], x, cfg)
    new_ffn = {}
    if kind == "rwkv":
        y, new_ffn = S.apply_rwkv_channel(
            p["ffn"], h, cfg, cache=cache["ffn"] if cache else None,
            return_cache=return_cache)
    elif cfg.moe_on_layer(layer_idx):
        y, aux = M.apply_moe(p["ffn"], h, cfg, cfg.moe, n_groups=moe_groups)
    else:
        y = L.apply_mlp(p["ffn"], h, cfg)
    x = constrain(x + y, "act")

    new_cache = None
    if return_cache or (cache is not None and cache_index is not None):
        new_cache = {"mixer": new_mix or {}, "ffn": new_ffn or {}}
        if cfg.encoder_decoder:
            new_cache["cross"] = new_cross or (cache["cross"] if cache
                                               else {})
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# encoder (whisper)


def _apply_encoder(params, enc_embed, cfg: ArchConfig):
    """Bidirectional encoder over frame embeddings (B, T, d) with learned
    positions; the stacked encoder layers' cross leaves (none) unused.
    Under a tensor-parallel context each layer's attention and MLP run on
    the rank's blocks (``apply_gqa`` and ``apply_mlp`` read them from
    the leaves' shapes); ``enc_pos`` and the norms are whole, and so is
    the output, which every decoder layer's cross-attention reads."""
    x = enc_embed.to(L.torch_dtype(cfg.compute_dtype))
    x = x + params["enc_pos"][None, :x.shape[1]].to(x.dtype)
    for lp in _unstack(params["encoder"], cfg.encoder_layers):
        y, _ = A.apply_gqa(lp["mixer"], L.apply_norm(lp["norm1"], x, cfg),
                           cfg, causal=False)
        x = x + y
        x = x + L.apply_mlp(lp["ffn"], L.apply_norm(lp["norm2"], x, cfg),
                            cfg)
    return L.apply_norm(params["enc_norm_f"], x, cfg)


# ---------------------------------------------------------------------------
# forward


def _positions_for(cfg: ArchConfig, b: int, s: int, offset, device):
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    pos = torch.arange(s, dtype=torch.int32, device=device)[None]
    pos = pos + (off[:, None] if off.dim() else off)
    pos = pos.expand(b, s)
    if cfg.rope == "mrope":
        return pos[None].expand(3, b, s)
    return pos


def apply_model(params, tokens, cfg: ArchConfig, *, enc_embed=None,
                cache=None, cache_index=None, mode: str = "train",
                moe_groups: int = 1, logits_chunk: int = 0,
                page_table=None, impl: str = "auto",
                remat_policy: str = "none", param_specs=None):
    """Returns (logits, aux_loss, new_cache).

    mode: "train" (no cache), "prefill" (returns the populated dense
    cache), "decode" (tokens (B, 1), cache + cache_index required;
    cache_index is a scalar or the (B,) per-sequence lengths, and with a
    paged cache ``page_table`` (B, Pmax) routes attention through the page
    pools). A decode writes the cache in place and returns it.
    ``enc_embed`` (B, T, d) runs an encoder-decoder's encoder (train and
    prefill; decode reads the cached cross K/V). ``moe_groups`` splits
    the tokens into MoE dispatch groups. With ``logits_chunk``
    (prefill/train) the final normed hidden states come back in place of
    the logits, for a caller that unembeds only some positions. ``impl``
    picks the GQA paged-decode attention form (``kernels/ops.py``).
    ``remat_policy`` other than ``"none"`` recomputes each period's
    activations in the backward pass of a train forward
    (``torch.utils.checkpoint``, non-reentrant): the same numbers, less
    memory, as the reference's ``jax.checkpoint`` of its period body.

    ``param_specs`` (the storage specs of ``params``, ``dist.sharding.
    tree_specs``) brings each parameter from its storage layout to the
    compute layout through ``constrain_tree``, as the reference's manual
    ZeRO-3 does: the non-block parameters once, each period's block
    parameters just before the period runs (inside its checkpoint, so a
    recomputation gathers again). Under the placed train step's
    ``act_sharding.placement`` that is a gather of this rank's shards;
    with none active, the identity.
    """
    b, s = tokens.shape
    decode, prefill = mode == "decode", mode == "prefill"
    pattern = cfg.layer_pattern
    blk_specs = [None] * len(pattern)
    # a recomputation may run on another thread: resolve the contexts here
    gather, tp = current_placement(), current_tp()
    if param_specs is not None:
        params = dict(params)
        for key in ("embed", "norm_f", "enc_norm_f", "enc_pos", "encoder"):
            if key in params and key in param_specs:
                params[key] = constrain_tree(params[key], param_specs[key],
                                             gather)
        blk_specs = [strip_leading(ps) for ps in param_specs["blocks"]]
    positions = _positions_for(cfg, b, s, cache_index if decode else 0,
                               tokens.device)
    x = constrain(L.embed_tokens(params["embed"], tokens, cfg), "act")
    if cfg.rope == "learned":
        x = x + params["embed"]["pos"][positions].to(x.dtype)
    rope = None
    if cfg.rope in ("rope", "mrope"):
        rope = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta,
                              cfg.mrope_sections if cfg.rope == "mrope"
                              else None)
    enc_out = None
    if cfg.encoder_decoder and enc_embed is not None:
        enc_out = _apply_encoder(params, enc_embed, cfg)

    def period(x, aux, blk_params, blk_caches):
        """One period of the layer pattern: (x, aux, its new caches)."""
        x = constrain(x, "act")
        blk_params = [constrain_tree(bp, bs, gather)
                      for bp, bs in zip(blk_params, blk_specs)]
        ncs = []
        with tp_context.of(tp):
            for pos, kind in enumerate(pattern):
                x, a, nc = _apply_layer(
                    blk_params[pos], x, kind, cfg, layer_idx=pos,
                    positions=positions, rope=rope, moe_groups=moe_groups,
                    cache=blk_caches[pos] if blk_caches is not None
                    else None,
                    cache_index=cache_index if decode else None,
                    return_cache=prefill, enc_out=enc_out,
                    page_table=page_table if decode else None, impl=impl)
                if a is not None:
                    aux = aux + a
                ncs.append(nc)
        return x, aux, ncs

    run = period
    if (mode == "train" and remat_policy != "none"
            and torch.is_grad_enabled()):
        def run(*args):
            return torch.utils.checkpoint.checkpoint(
                period, *args, use_reentrant=False)
    blocks = [_unstack(bp, cfg.n_periods) for bp in params["blocks"]]
    caches = (None if cache is None
              else [_unstack(c, cfg.n_periods) for c in cache])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [[] for _ in pattern]
    # a span a period, named after the caller's phase: a trace's reader
    # names a gap of the device by the host range in flight, looking a
    # few hundred host events back at most, and a forward launches
    # thousands
    for pi in range(cfg.n_periods):
        with spans.span_under("period"):
            x, aux, ncs = run(
                x, aux, [bp[pi] for bp in blocks],
                None if caches is None else [c[pi] for c in caches])
        for pos, nc in enumerate(ncs):
            new_caches[pos].append(nc)
    new_cache = None
    if prefill:
        new_cache = tuple(_stack(ncs) for ncs in new_caches)
    elif decode:
        new_cache = cache
    x = constrain(L.apply_norm(params["norm_f"], x, cfg), "act")
    if logits_chunk and not decode:
        return x, aux, new_cache
    return (constrain(L.unembed(params["embed"], x, cfg), "logits"), aux,
            new_cache)


# ---------------------------------------------------------------------------
# losses


def lm_loss(logits, targets, weights, aux=0.0, aux_coef: float = 0.01,
            denom=None, vocab_size: Optional[int] = None):
    """Weighted token cross-entropy; weights carry padding and the
    Algorithm-1 agent mask (masked agents' tokens get weight 0). The
    weighted sum is divided by ``max(sum(weights), 1)``, or by ``denom``
    where given (a placed step's global weight sum over its ranks).

    Logits narrower than ``vocab_size`` are this rank's block of the
    vocabulary under a tensor-parallel context (``layers.unembed``): the
    loss is then vocab-parallel, the max, the sum of exponentials and the
    gold logit each joined over tp, and the same on every tp rank."""
    lf = logits.to(torch.float32)
    if vocab_size is not None and logits.shape[-1] != vocab_size:
        return _vocab_parallel_loss(lf, targets, weights, denom) \
            + aux_coef * aux
    m = lf.amax(-1, keepdim=True).detach()
    logz = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    w = weights.to(torch.float32)
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    loss = ((logz - gold) * w).sum() / denom
    return loss + aux_coef * aux


def _vocab_parallel_loss(lf, targets, weights, denom):
    """The weighted cross-entropy of :func:`lm_loss` over this rank's
    vocabulary block ``lf`` (f32): the max from every rank's (gathered,
    exact), the exponentials' sum and the gold logit summed over tp."""
    tp = current_tp()
    v = lf.shape[-1]
    v0 = tp.block(v * tp.size).start
    m = gather_from_tp(lf.amax(-1, keepdim=True).detach(), -1).amax(
        -1, keepdim=True)
    logz = torch.log(reduce_from_tp(torch.exp(lf - m).sum(-1))) + m[..., 0]
    t = targets.long() - v0
    mine = (t >= 0) & (t < v)
    gold = torch.gather(lf, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    gold = reduce_from_tp(torch.where(mine, gold, 0.0))
    w = weights.to(torch.float32)
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    return ((logz - gold) * w).sum() / denom


def classifier_loss(logits, labels, weights):
    """Weighted mean softmax cross-entropy; labels are integer classes."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    w = weights.to(torch.float32)
    return torch.sum((logz - gold) * w) / torch.clamp(torch.sum(w), min=1.0)


# ---------------------------------------------------------------------------
# parameter counting


def count_params(cfg: ArchConfig, active_only: bool = False,
                 max_pos: int = 32768) -> int:
    """Total parameters, embeddings included, from the shapes alone
    (``init_model`` on the meta device). ``active_only`` leaves out each
    MoE layer's experts a token does not route to (all but top_k)."""
    shapes = init_model(None, cfg, device="meta", max_pos=max_pos)

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (tuple, list)):
            return [x for v in t for x in leaves(v)]
        return [t]

    total = sum(math.prod(t.shape) for t in leaves(shapes))
    if active_only and cfg.moe is not None:
        moe = cfg.moe
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.moe_on_layer(i))
        per_expert = 3 * cfg.d_model * moe.d_ff_expert
        total -= n_moe * (moe.num_experts - moe.top_k) * per_expert
    return total
