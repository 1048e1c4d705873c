"""Serving steps: prefill (builds the dense cache) and decode (one token),
and greedy generation on the paged serving engine (counterpart of
``repro.launch.serve``).

The steps are what a dry run of ``prefill_32k`` / ``decode_32k`` reads:
``apply_model`` under the activation policy (``dist.act_sharding``) when
``dp`` is given, argmax in int32, no rematerialization. A decode writes
the cache in place and returns it, where the reference returns an
updated copy. ``greedy_generate`` drives ``serve.ServeEngine``: one
prefill, then ``steps - 1`` decode iterations in supersteps of
``superstep_k``, the GQA decode through ``paged_flash_decode`` on the
card.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.act_sharding import act_policy
from repro_torch.models.model import apply_model


def _ctx(dp, tp, sizes=None):
    return (act_policy(dp, tp, sizes) if dp is not None
            else contextlib.nullcontext())


def make_prefill_step(cfg: ArchConfig, moe_groups: int = 1,
                      dp=None, tp=None, sizes=None) -> Callable:
    """``prefill(params, batch) -> (next token (B,) int32, cache)``."""
    def prefill(params, batch):
        with _ctx(dp, tp, sizes), torch.no_grad():
            logits, _, cache = apply_model(
                params, batch["tokens"], cfg, mode="prefill",
                enc_embed=batch.get("enc_embed"), moe_groups=moe_groups,
                remat_policy="none")
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill


def make_decode_step(cfg: ArchConfig, moe_groups: int = 1,
                     temperature: float = 0.0, dp=None, tp=None,
                     sizes=None) -> Callable:
    """``decode(params, batch) -> (next token (B,) int32, cache)`` with
    ``batch`` = {"tokens" (B, 1), "cache", "pos"}: greedy, as the
    reference's (``temperature`` is accepted and unused there too)."""
    del temperature

    def decode(params, batch):
        with _ctx(dp, tp, sizes), torch.no_grad():
            logits, _, cache = apply_model(
                params, batch["tokens"], cfg, mode="decode",
                cache=batch["cache"], cache_index=batch["pos"],
                moe_groups=moe_groups, remat_policy="none")
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

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
