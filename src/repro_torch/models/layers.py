"""Shared model layers: norms, RoPE/M-RoPE, MLPs, embeddings (counterpart
of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's keys and
layouts (dense weights ``(d_in, d_out)``, applied as ``x @ w``), so a JAX
parameter tree carries over leaf for leaf. Init draws from an explicit
``torch.Generator`` with the reference's distributions; the numbers
differ from ``jax.random``'s (the tests carry JAX weights over instead).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers: draws on the generator's device, then cast and moved


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    if torch.device(device).type == "meta":      # shapes only, no draw
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, scale: float = 1.0):
    return _normal(gen, (d_in, d_out), scale / d_in ** 0.5, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device):
    return _normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms


def init_norm(cfg: ArchConfig, device, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, dtype=param_dtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=param_dtype(cfg), device=device)
    return p


def apply_norm(p, x, cfg: ArchConfig, eps: float = 1e-6):
    """RMSNorm (or LayerNorm) computed in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions, head_dim: int, theta: float,
                 mrope_sections: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, 1, head_dim/2) f32, for positions (B, S),
    or (3, B, S) with M-RoPE: frequency i takes its position from the
    section row it falls in (sections past head_dim/2 are cut, a short
    list is padded with its last section, as ``jnp.repeat`` does)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    if positions.dim() == 3:
        if mrope_sections is None:
            raise ValueError("3-row positions need mrope_sections")
        sec = torch.repeat_interleave(
            torch.arange(len(mrope_sections), device=positions.device),
            torch.as_tensor(mrope_sections, device=positions.device))
        half = head_dim // 2
        sec = torch.cat([sec, sec[-1:].expand(max(half - sec.numel(), 0))]
                        )[:half]
        pos = positions.to(torch.float32)[sec].permute(1, 2, 0)
        freqs = pos * inv
    else:
        freqs = positions.to(torch.float32)[..., None] * inv
    return torch.cos(freqs)[:, :, None, :], torch.sin(freqs)[:, :, None, :]


def rotate(x, cos, sin):
    """Half-split rotation of x (B, S, H, D) in f32, cast back."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def apply_rope(x, positions, theta: float,
               mrope_sections: Optional[Sequence[int]] = None):
    """x: (B, S, H, D); positions: (B, S) int, or (3, B, S) for M-RoPE."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta,
                                   mrope_sections))


# ---------------------------------------------------------------------------
# MLP


def init_mlp(gen, cfg: ArchConfig, device, d_ff: Optional[int] = None):
    d, dt = cfg.d_model, param_dtype(cfg)
    ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, d, ff, dt, device),
                "w_up": dense_init(gen, d, ff, dt, device),
                "w_down": dense_init(gen, ff, d, dt, device)}
    return {"w_in": dense_init(gen, d, ff, dt, device),
            "b_in": torch.zeros(ff, dtype=dt, device=device),
            "w_out": dense_init(gen, ff, d, dt, device),
            "b_out": torch.zeros(d, dtype=dt, device=device)}


def apply_mlp(p, x, cfg: ArchConfig):
    if cfg.act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return h @ p["w_down"]
    h = x @ p["w_in"] + p["b_in"]
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return h @ p["w_out"] + p["b_out"]


# ---------------------------------------------------------------------------
# embeddings / unembedding


def init_embed(gen, cfg: ArchConfig, device):
    dt = param_dtype(cfg)
    p = {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                  device)
    if cfg.rope == "learned":
        p["pos"] = _normal(gen, (8192, cfg.d_model), 0.01, dt, device)
    return p


def embed_tokens(p, tokens, cfg: ArchConfig):
    """Token lookup, cast to the compute dtype (tied weights carry the
    reference's unit embedding scale, a no-op)."""
    return p["tok"][tokens].to(torch_dtype(cfg.compute_dtype))


def unembed(p, x, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["unembed"]
