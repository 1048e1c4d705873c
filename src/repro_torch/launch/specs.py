"""Abstract stand-ins for every model input and the train state
(counterpart of ``repro.launch.specs``).

The reference describes inputs with ``jax.ShapeDtypeStruct``; the port's
stand-in is a tensor on the **meta** device: the right shape and dtype,
no storage. A dry run, a per-rank memory report or a FLOP count reads
these without allocating anything.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.ledger import tree_map
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import init_cache, init_model

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def max_pos_for(shape: ShapeConfig) -> int:
    return max(32768, shape.seq_len + 1)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      n_agents: int) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _sds((b, s), torch.int32),
        "targets": _sds((b, s), torch.int32),
        # per-token loss weights: padding mask * Algorithm-1 agent mask
        "weights": _sds((b, s), torch.float32),
    }
    if cfg.encoder_decoder:
        batch["enc_embed"] = _sds((b, cfg.encoder_seq, cfg.d_model),
                                  torch_dtype(cfg.compute_dtype))
    if cfg.frontend == "vision":
        # stubbed patch embeddings prepended by the (stub) projector
        batch["vision_embed"] = _sds((b, 0, cfg.d_model),
                                     torch_dtype(cfg.compute_dtype))
    del n_agents
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _sds((b, 1), torch.int32),
        "cache": init_cache(cfg, b, s, device=META),
        "pos": _sds((), torch.int32),
    }


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((b, s), torch.int32)}
    if cfg.encoder_decoder:
        out["enc_embed"] = _sds((b, cfg.encoder_seq, cfg.d_model),
                                torch_dtype(cfg.compute_dtype))
    return out


def state_specs(cfg: ArchConfig, shape: ShapeConfig,
                optimizer: str = "adamw") -> Dict[str, Any]:
    """Abstract train state (parameters + optimizer moments + step)."""
    params = init_model(None, cfg, device=META, max_pos=max_pos_for(shape))
    state: Dict[str, Any] = {"params": params,
                             "step": _sds((), torch.int32)}
    if optimizer == "adamw":
        moments = tree_map(lambda l: _sds(l.shape, torch.float32), params)
        state["opt"] = {"m": moments, "v": moments}
    elif optimizer == "sgdm":
        state["opt"] = {"m": params}
    else:
        state["opt"] = {}
    return state


def input_specs(cfg: ArchConfig, shape: ShapeConfig, n_agents: int,
                kind: Optional[str] = None) -> Dict[str, Any]:
    kind = kind or shape.kind
    if kind == "train":
        return train_batch_specs(cfg, shape, n_agents)
    if kind == "prefill":
        return prefill_specs(cfg, shape)
    if kind == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(kind)
