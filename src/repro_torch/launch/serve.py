"""Serving steps: prefill (builds the dense cache) and decode (one token),
and greedy generation on the paged serving engine (counterpart of
``repro.launch.serve``).

The steps are what a dry run of ``prefill_32k`` / ``decode_32k`` reads:
``apply_model`` under the activation policy (``dist.act_sharding``) when
``dp`` is given, argmax in int32, no rematerialization. Given a
``mesh``, every registered family (the attention decoders, GQA or MLA,
the Mamba hybrid jamba, RWKV-6 and whisper's encoder-decoder, dense or
MoE: ``dist.tp.tp_compute``) runs tensor-parallel over the mesh's
"model" axis, as the reference's compute layout splits it: on this
rank's blocks of the parameters (:func:`place_params`, or
:func:`init_params` drawing them block by block), an MoE block's experts
included, and of a cache whose head_dim (whisper's cross-attention
``ck`` / ``cv`` too; MLA: its latent and rope-key columns; Mamba: its
state's d_state and its conv rows' di; RWKV: its state's value columns
and its token-shift rows' d) is split over tp (:func:`place_cache`). A
whisper prefill takes the frame embeddings as ``batch["enc_embed"]``;
its decode reads the encoder's K/V from the cache. A decode writes the
cache in place and returns it, where the reference returns an updated
copy. ``greedy_generate`` drives ``serve.ServeEngine``: one prefill,
then ``steps - 1`` decode iterations in supersteps of ``superstep_k``,
the GQA decode through ``paged_flash_decode`` on the card (decoder-only
families: the engine pages no encoder-decoder, as the reference's).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.act_sharding import act_policy
from repro_torch.dist.sharding import (MeshRules, _rebuild, _zip_specs,
                                       block_shape, block_slices,
                                       cache_specs, compute_rules,
                                       shard_tree, tree_specs)
from repro_torch.dist.tp import gather_from_tp, tp_context, tp_compute
from repro_torch.models.layers import vocab_split
from repro_torch.models.model import apply_model, init_model


def _ctx(dp, tp, sizes=None):
    return (act_policy(dp, tp, sizes) if dp is not None
            else contextlib.nullcontext())


def _tp_axes(cfg: ArchConfig, mesh) -> Tuple[str, ...]:
    """The tp axes a step on ``mesh`` computes ``cfg`` over: the compute
    rules' where the family has tensor-parallel compute
    (``dist.tp.tp_compute``, every registered one) and the mesh gives
    them more than one rank; none otherwise (whole parameters on every
    rank)."""
    if mesh is None or not tp_compute(cfg):
        return ()
    return tuple(a for a in compute_rules(mesh.shape).tp_axes
                 if mesh.shape.get(a, 1) > 1)


def _idle_axes(mesh, dp) -> Tuple[str, ...]:
    """The dp axes of ``mesh`` (the compute rules') of more than one rank
    that a step's batch leaves idle, given ``dp``, the axes it splits
    over; none where ``dp`` is None (the caller's ranks may hold
    different batches) or there is no mesh."""
    if mesh is None or dp is None:
        return ()
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    return tuple(a for a in compute_rules(mesh.shape).dp
                 if a not in dp and mesh.shape.get(a, 1) > 1)


def place_params(params, cfg: ArchConfig, mesh):
    """This rank's block of ``params`` in the compute layout the steps of
    a ``mesh`` run on: ``shard_tree`` under the reference's compute specs
    (``dist.sharding.compute_rules``) where ``cfg`` computes
    tensor-parallel over the mesh, ``params`` as they are otherwise."""
    if not _tp_axes(cfg, mesh):
        return params
    return shard_tree(params, tree_specs(params, compute_rules(mesh.shape)),
                      mesh)


def init_params(generator, cfg: ArchConfig, mesh, device="cuda",
                max_pos: int = 32768):
    """``place_params(init_model(generator, cfg, ...), cfg, mesh)``, the
    same numbers, without the whole model on ``device``: each MoE expert
    stack keeps this rank's experts as it is drawn (the whole draw freed
    before the next), then every other leaf is cut to its block. The
    whole parameters where ``cfg`` does not compute tensor-parallel over
    the mesh."""
    if not _tp_axes(cfg, mesh):
        return init_model(generator, cfg, device=device, max_pos=max_pos)
    rules = compute_rules(mesh.shape)
    whole = init_model(None, cfg, device="meta", max_pos=max_pos)
    specs = tree_specs(whole, rules)
    experts = None
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        experts = block_slices((rules.fit(rules.ep_axes, e),), (e,), mesh)[0]
    params = init_model(generator, cfg, device=device, max_pos=max_pos,
                        experts=experts)
    out = []
    for (leaf, sp), (w, _) in zip(_zip_specs(params, specs),
                                  _zip_specs(whole, specs)):
        if leaf.shape == w.shape:
            leaf = leaf[block_slices(sp, w.shape, mesh)].clone(
                memory_format=torch.contiguous_format)
        elif leaf.shape != block_shape(sp, w.shape, mesh):
            raise ValueError(f"a leaf of {tuple(leaf.shape)} is neither "
                             f"whole nor this rank's block of "
                             f"{tuple(w.shape)}")
        out.append(leaf)
    return _rebuild(params, iter(out))


def place_cache(cache, cfg: ArchConfig, mesh, dp=()):
    """This rank's block of a dense ``cache`` under ``cache_specs``: the
    batch over ``dp`` (the caller's dp axes; none by default), head_dim
    over tp where ``cfg`` computes tensor-parallel over the mesh."""
    rules = MeshRules(axis_sizes=dict(mesh.shape), dp_axes=tuple(dp),
                      tp_axes=_tp_axes(cfg, mesh))
    return shard_tree(cache, cache_specs(rules, cache,
                                         n_query_heads=cfg.n_heads), mesh)


def _next_token(logits, cfg: ArchConfig):
    """Greedy next token from the last position's logits, gathered whole
    over tp where they are this rank's vocabulary block."""
    last = logits[:, -1]
    if vocab_split(last, cfg):
        last = gather_from_tp(last, -1)
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, moe_groups: int = 1,
                      dp=None, tp=None, sizes=None, mesh=None) -> Callable:
    """``prefill(params, batch) -> (next token (B,) int32, cache)``, with
    ``batch["enc_embed"]`` (B, T, d) for an encoder-decoder. With
    ``mesh``, the model runs tensor-parallel over its tp axes on
    ``place_params``' blocks and returns the cache in ``place_cache``'s
    layout (every rank of the mesh calls it)."""
    tp_axes = _tp_axes(cfg, mesh)

    def prefill(params, batch):
        with _ctx(dp, tp, sizes), torch.no_grad(), tp_context(
                mesh if tp_axes else None, tp_axes):
            logits, _, cache = apply_model(
                params, batch["tokens"], cfg, mode="prefill",
                enc_embed=batch.get("enc_embed"), moe_groups=moe_groups,
                remat_policy="none")
            return _next_token(logits, cfg), cache

    return prefill


def make_decode_step(cfg: ArchConfig, moe_groups: int = 1,
                     temperature: float = 0.0, dp=None, tp=None,
                     sizes=None, mesh=None) -> Callable:
    """``decode(params, batch) -> (next token (B,) int32, cache)`` with
    ``batch`` = {"tokens" (B, 1), "cache", "pos"}: greedy, as the
    reference's (``temperature`` is accepted and unused there too). With
    ``mesh``, as :func:`make_prefill_step`: ``place_params``' blocks and
    ``place_cache``'s cache. With ``mesh`` and ``dp``, the axes the batch
    splits over, the mesh's other dp axes are idle (a batch of one on
    every data rank alike): ``dist.tp``'s context names them, and RWKV's
    decode splits its projections' fan-in over them, as the reference's
    compiled decode does (``models.ssm``)."""
    del temperature
    tp_axes = _tp_axes(cfg, mesh)
    idle = _idle_axes(mesh, dp)

    def decode(params, batch):
        with _ctx(dp, tp, sizes), torch.no_grad(), tp_context(
                mesh if tp_axes or idle else None, tp_axes, idle=idle):
            logits, _, cache = apply_model(
                params, batch["tokens"], cfg, mode="decode",
                cache=batch["cache"], cache_index=batch["pos"],
                moe_groups=moe_groups, remat_policy="none")
            return _next_token(logits, cfg), cache

    return decode


def greedy_generate(params, cfg: ArchConfig, prompt, max_len: int,
                    steps: int, page_size: int = 8, superstep_k: int = 8,
                    mesh=None, rules=None, device="cuda") -> torch.Tensor:
    """Generation on the paged serving engine.

    Returns ``prompt`` (B, S0) extended with exactly ``steps`` new tokens
    per row, as an int32 tensor on the prompt's device (the CPU for a
    numpy prompt). The first token comes from the prefill logits; equal
    prompts admit as one group, so the batch costs one prefill plus
    ``steps - 1`` decode iterations in ``ceil((steps - 1) /
    superstep_k)`` supersteps. ``params`` live on ``device``; a ``mesh``
    (with optional ``MeshRules``) runs the engine tensor-parallel, its
    token stream the replicated engine's.
    """
    from repro_torch.serve import PagedCacheConfig, ServeEngine

    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(torch.int32)
    b, s0 = prompt.shape
    total = s0 + steps
    if total > max_len:
        raise ValueError(f"prompt {s0} + steps {steps} > max_len {max_len}")
    per_seq = -(-total // page_size)
    ccfg = PagedCacheConfig(num_slots=b, page_size=page_size,
                            num_pages=b * per_seq + 1,
                            max_pages_per_seq=per_seq)
    engine = ServeEngine(params, cfg, ccfg, superstep_k=superstep_k,
                         mesh=mesh, rules=rules, device=device)
    host = prompt.cpu().numpy()
    rids = [engine.submit(host[i], steps) for i in range(b)]
    out = engine.run()
    new = torch.from_numpy(np.stack([out[rid] for rid in rids])).to(
        prompt.device)
    return torch.cat([prompt, new], dim=1)
