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
from repro_torch.dist.act_sharding import constrain
from repro_torch.dist.tp import (copy_to_tp, current_tp, gather_from_tp,
                                 reduce_from_tp, scatter_to_tp)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers: draws on the generator's device, then cast and moved


def _normal(gen: torch.Generator, shape, std: float, dtype, device,
            rows: Optional[slice] = None):
    """A normal draw of ``shape`` scaled by ``std``, cast and moved; with
    ``rows`` only those rows of its first dimension are kept (cut from
    the f32 draw, which is freed on return)."""
    if torch.device(device).type == "meta":      # shapes only, no draw
        if rows is not None:
            shape = (len(range(shape[0])[rows]),) + tuple(shape[1:])
        return torch.empty(shape, dtype=dtype, device="meta")
    # scaled in place: one f32 draw alive at a time (an arctic expert
    # stack is 17.8 GB in f32)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(std)
    if rows is not None:
        x = x[rows]
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


def apply_group_norm(x, eps: float = 1e-6):
    """Head-wise group norm without learned parameters (RWKV-6's wkv
    output norm): x (B, T, H, D) normalised over D in f32, cast back (the
    reference's ``n_groups`` argument is unused there: the head axis
    already groups)."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


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
            torch.as_tensor(mrope_sections, device=positions.device),
            output_size=sum(mrope_sections))    # known here: no device read
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


def apply_mlp(p, x, cfg: ArchConfig, d_ff: Optional[int] = None):
    """The MLP of hidden width ``d_ff`` (``cfg.d_ff`` by default; an MoE
    block's fused shared experts are wider). Under a tensor-parallel
    context (``dist.tp``) whose compute layout splits the hidden width
    (the first matrix's local fan-out short of it): column- then
    row-parallel, this rank's hidden columns and the partial outputs
    summed over tp."""
    swiglu = cfg.act == "swiglu"
    split = (current_tp() is not None
             and p["w_gate" if swiglu else "w_in"].shape[-1]
             != (d_ff or cfg.d_ff))
    if split:
        x = copy_to_tp(x)
    if swiglu:
        g = constrain(x @ p["w_gate"], "ffn")
        u = constrain(x @ p["w_up"], "ffn")
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        y = h @ p["w_down"]
        return reduce_from_tp(y) if split else y
    b_in = scatter_to_tp(p["b_in"], -1) if split else p["b_in"]
    h = x @ p["w_in"] + b_in
    h = constrain(F.gelu(h.to(torch.float32), approximate="tanh")
                  .to(x.dtype), "ffn")
    y = h @ p["w_out"]
    return (reduce_from_tp(y) if split else y) + p["b_out"]


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
    reference's unit embedding scale, a no-op). Under a tensor-parallel
    context whose compute layout splits the embedding's model columns,
    each rank looks up its columns and they are gathered whole."""
    tok = p["tok"]
    x = tok[tokens]
    if current_tp() is not None and tok.shape[-1] != cfg.d_model:
        x = gather_from_tp(x, -1)
    return x.to(torch_dtype(cfg.compute_dtype))


def unembed(p, x, cfg: ArchConfig):
    """Logits. Under a tensor-parallel context the logits come back in
    the reference's ``logits`` layout, this rank's block of the vocabulary
    (:func:`vocab_split` says whether they are): an untied ``unembed``
    split over the vocabulary is column-parallel; tied weights split over
    the model columns go through :class:`_TiedUnembed`. An untied
    ``unembed`` left whole (a vocabulary tp does not divide) gives whole
    logits: computed whole on every rank, or under the general step's
    program (``dist.tp.TP``) row-parallel over the model columns, as the
    reference's general step computes them."""
    tp = current_tp()
    if not cfg.tie_embeddings:
        w = p["unembed"]
        if tp is not None and w.shape[-1] != cfg.vocab_size:
            return copy_to_tp(x) @ w
        if (tp is not None and tp.program == "general"
                and x.shape[-1] % tp.size == 0):
            # a whole unembedding (its vocabulary does not split) under
            # the general step's program: the contraction over this
            # rank's model columns, the partial logits summed over tp
            return reduce_from_tp(scatter_to_tp(x, -1)
                                  @ scatter_to_tp(w, 0))
        return x @ w
    tok = p["tok"]
    if tp is not None and tok.shape[-1] != cfg.d_model:
        return _TiedUnembed.apply(tp, x, tok, cfg.vocab_size)
    return x @ tok.T


def vocab_split(logits, cfg: ArchConfig) -> bool:
    """Whether ``logits`` hold this rank's block of the vocabulary."""
    return current_tp() is not None and logits.shape[-1] != cfg.vocab_size


class _TiedUnembed(torch.autograd.Function):
    """``x @ tok.T`` for tied weights whose model columns are split over
    tp, into this rank's block of the vocabulary. The forward moves the
    smaller of two payloads: the tokens' partial logits over this rank's
    columns, summed over tp (few tokens), or the weight's columns
    gathered whole, then this rank's vocabulary rows (many tokens). The
    backward gathers the logit gradient whole over the vocabulary and
    takes the weight's gradient for this rank's columns; the input
    gradient comes, with no further collective, from the whole weight
    where the forward gathered it (the reference's compiled masked step
    computes it so, whole on every rank), else, and always under the
    general step's program (``dist.tp.TP``, as the reference's general
    step computes it), from this rank's columns, gathered over tp (tokens
    times d_model, not the weight)."""

    @staticmethod
    def forward(ctx, tp, x, tok, vocab):
        cols, rows = tp.block(x.shape[-1]), tp.block(vocab)
        n_tok = x.numel() // x.shape[-1]
        full = None
        if n_tok * vocab < tok.numel() * tp.size:
            y = tp.all_reduce(x[..., cols] @ tok.T)[..., rows]
        else:
            full = tp.gather(tok, -1)
            y = x @ full[rows].T
        ctx.tp, ctx.cols, ctx.rows = tp, cols, rows
        if tp.program == "general":
            full = None
        ctx.save_for_backward(x, tok, full)
        return y

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        x, tok, full = ctx.saved_tensors
        gw = tp.gather(g, -1)
        dx = gw @ full if full is not None else tp.gather(gw @ tok, -1)
        dtok = (gw.reshape(-1, gw.shape[-1]).T
                @ x[..., ctx.cols].reshape(-1, tok.shape[-1]))
        return None, dx, dtok, None
