"""Model assembly for dense decoders: init / train-forward / prefill /
decode (counterpart of the dense half of ``repro.models.model``), and the
losses.

Parameters and caches keep the reference's pytree: ``params["blocks"]``
and every cache are tuples over the layer pattern's positions whose
leaves carry a leading ``n_periods`` axis (one entry per layer here,
since a dense decoder's pattern is ``("attn",)``), with JAX's
``(d_in, d_out)`` weight layouts. ``params_from_jax`` therefore carries a
JAX parameter tree over leaf for leaf, and both packages compute the same
function. Where the reference scans the stack with ``lax.scan``, the
port loops over the layers, each reading views of the stacked leaves.

Ported so far: layer pattern ``("attn",)`` with GQA and a dense MLP
(qwen2, qwen1.5, yi). MoE, MLA, SSM/RWKV, hybrid and encoder-decoder
models raise ``NotImplementedError`` (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def check_supported(cfg: ArchConfig) -> None:
    """Raise for an architecture the port does not model yet."""
    if (cfg.layer_pattern != ("attn",) or cfg.attention != "gqa"
            or cfg.moe is not None or cfg.encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported; MoE, MLA, "
            "SSM/RWKV, hybrid and encoder-decoder models come with ROADMAP "
            "Queue 1 item 6")


# ---------------------------------------------------------------------------
# init


def _init_layer(gen, cfg: ArchConfig, device):
    return {"norm1": L.init_norm(cfg, device),
            "norm2": L.init_norm(cfg, device),
            "mixer": A.init_gqa(gen, cfg, device),
            "ffn": L.init_mlp(gen, cfg, device)}


def _stack(per_layer):
    """[layer0_params, layer1_params, ...] -> leaves stacked on axis 0."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in per_layer]) for k in first}
    return torch.stack(per_layer)


def _unstack(tree, n: int):
    """The inverse of :func:`_stack`: n per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, 0)


def init_model(generator: Optional[torch.Generator], cfg: ArchConfig,
               device="cuda", max_pos: int = 32768):
    """Random weights with the reference's distributions (normal weights
    scaled by 1/sqrt(d_in), embeddings by 0.02, unit norms, zero biases),
    drawn in f32 on the generator's device, then cast to ``param_dtype``
    and moved to ``device``. ``device="meta"`` builds the shapes only (no
    generator needed)."""
    check_supported(cfg)
    device = resolve_device(device)
    params: Dict[str, Any] = {"embed": L.init_embed(generator, cfg, device)}
    if cfg.rope == "learned":
        params["embed"]["pos"] = L._normal(generator, (max_pos, cfg.d_model),
                                           0.01, L.param_dtype(cfg), device)
    params["blocks"] = (_stack([_init_layer(generator, cfg, device)
                                for _ in range(cfg.n_periods)]),)
    params["norm_f"] = L.init_norm(cfg, device)
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
    """Dense decode cache: per pattern position {"mixer": {"k", "v"}:
    (n_periods, B, max_len, Hkv, hd), "ffn": {}} in the compute dtype."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dt = L.torch_dtype(cfg.compute_dtype)
    return ({"mixer": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)},
             "ffn": {}},)


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


def apply_model(params, tokens, cfg: ArchConfig, *, cache=None,
                cache_index=None, mode: str = "train", logits_chunk: int = 0,
                page_table=None, impl: str = "auto"):
    """Returns (logits, aux_loss, new_cache).

    mode: "train" (no cache), "prefill" (returns the populated dense
    cache), "decode" (tokens (B, 1), cache + cache_index required;
    cache_index is a scalar or the (B,) per-sequence lengths, and with a
    paged cache ``page_table`` (B, Pmax) routes attention through the page
    pools). A decode writes the cache in place and returns it. With
    ``logits_chunk`` (prefill/train) the final normed hidden states come
    back in place of the logits, for a caller that unembeds only some
    positions. ``impl`` picks the paged-decode attention form
    (``kernels/ops.py``).
    """
    check_supported(cfg)
    b, s = tokens.shape
    decode, prefill = mode == "decode", mode == "prefill"
    positions = _positions_for(cfg, b, s, cache_index if decode else 0,
                               tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.rope == "learned":
        x = x + params["embed"]["pos"][positions].to(x.dtype)
    rope = None
    if cfg.rope in ("rope", "mrope"):
        rope = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta,
                              cfg.mrope_sections if cfg.rope == "mrope"
                              else None)

    layers = _unstack(params["blocks"][0], cfg.n_periods)
    mix_cache = cache[0]["mixer"] if cache is not None else None
    new_k, new_v = [], []
    for i, lp in enumerate(layers):
        layer_cache = ({k: leaf[i] for k, leaf in mix_cache.items()}
                       if mix_cache is not None else None)
        h = L.apply_norm(lp["norm1"], x, cfg)
        y, nc = A.apply_gqa(lp["mixer"], h, cfg, rope=rope,
                            cache=layer_cache,
                            cache_index=cache_index if decode else None,
                            return_cache=prefill,
                            page_table=page_table if decode else None,
                            impl=impl)
        x = x + y
        x = x + L.apply_mlp(lp["ffn"], L.apply_norm(lp["norm2"], x, cfg),
                            cfg)
        if prefill:
            new_k.append(nc["k"])
            new_v.append(nc["v"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None
    if prefill:
        new_cache = ({"mixer": {"k": torch.stack(new_k),
                                "v": torch.stack(new_v)}, "ffn": {}},)
    elif decode:
        new_cache = cache
    x = L.apply_norm(params["norm_f"], x, cfg)
    if logits_chunk and not decode:
        return x, aux, new_cache
    return L.unembed(params["embed"], x, cfg), aux, new_cache


# ---------------------------------------------------------------------------
# losses


def lm_loss(logits, targets, weights, aux=0.0, aux_coef: float = 0.01):
    """Weighted token cross-entropy; weights carry padding and the
    Algorithm-1 agent mask (masked agents' tokens get weight 0)."""
    lf = logits.to(torch.float32)
    m = lf.amax(-1, keepdim=True).detach()
    logz = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    w = weights.to(torch.float32)
    loss = ((logz - gold) * w).sum() / torch.clamp(w.sum(), min=1.0)
    return loss + aux_coef * aux


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
    (``init_model`` on the meta device). ``active_only`` differs from the
    total only for MoE, which is not ported yet."""
    shapes = init_model(None, cfg, device="meta", max_pos=max_pos)

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (tuple, list)):
            return [x for v in t for x in leaves(v)]
        return [t]

    return sum(math.prod(t.shape) for t in leaves(shapes))
