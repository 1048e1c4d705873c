"""Plain PyTorch reference of the benchmark's decoder models.

Follows the published architectures as the configuration file states
them (``arch``, ``rms_norm_eps``): pre-norm decoder layers of RMSNorm,
a mixer (grouped-query attention with half-split rotary embeddings, or a
Mamba-1 selective scan), a residual add, RMSNorm, a SwiGLU MLP or a
top-k mixture of SwiGLU experts, a residual add; a final RMSNorm and an
untied unembedding. It reads the weights from the tree the benchmark
made (dense weights ``(d_in, d_out)``, block leaves stacked over the
periods of the layer pattern) and imports nothing of the program.

Precision: the configuration states bfloat16 weights and compute, so
every matrix product takes bfloat16 inputs (``Matmul``); the residual
stream, norms, softmax, rotary embedding, the Mamba recurrence and the
loss are float32. ``Matmul("fp8")`` rounds both inputs of every product
to float8 e4m3 (one scale per tensor), the precision below: the control.
The MoE computes each expert on the tokens routed to it (no capacity, no
drops); the Mamba state is the per-token recurrence itself.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

F8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    s = xf.abs().amax().clamp(min=1e-12) / F8_MAX
    return ((xf / s).to(torch.float8_e4m3fn).float() * s).to(torch.bfloat16)


class Matmul:
    """``x @ w`` in the configuration's precision (``"bf16"``: bfloat16
    inputs, float32 out) or the control's (``"fp8"``)."""

    def __init__(self, precision: str = "bf16"):
        if precision not in ("bf16", "fp8", "f32"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x.float() @ w.float()
        if self.precision == "fp8":
            return (_fp8(x) @ _fp8(w)).float()
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


PRECISION = {"bfloat16": "bf16", "float32": "f32"}
BELOW = {"bf16": "fp8", "f32": "bf16"}


def precision(config: Dict) -> str:
    """The precision the configuration states for compute."""
    return PRECISION[config["arch"]["compute_dtype"]]


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope_tables(seq: int, head_dim: int, theta: float, device):
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=device) / half))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)            # (S, half)


def rotate(x, cos, sin):
    """x (B, S, H, D): the first and second halves of D rotated by the
    position's angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(p, h, a: Dict, mm: Matmul, rope):
    b, s, _ = h.shape
    H, hk = a["n_heads"], a["n_kv_heads"]
    hd = a.get("head_dim") or a["d_model"] // H
    q = mm(h, p["wq"]).view(b, s, H, hd)
    k = mm(h, p["wk"]).view(b, s, hk, hd)
    v = mm(h, p["wv"]).view(b, s, hk, hd)
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    # query head i reads KV head i // (H / hk)
    k = k.repeat_interleave(H // hk, dim=2).transpose(1, 2)
    v = v.repeat_interleave(H // hk, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)                              # (B, H, S, D)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)         # (B, H, S, D)
    return mm(out.transpose(1, 2).reshape(b, s, H * hd), p["wo"])


def mlp(p, h, mm: Matmul):
    return mm(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]), p["w_down"])


def moe(p, h, a: Dict, mm: Matmul):
    """Top-k routing over the softmax of float32 router logits, the k
    weights renormalised; each expert runs on its own tokens."""
    m = a["moe"]
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    w, idx = torch.topk(probs, m["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        ye = mm(F.silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]),
                p["w_down"][e])
        out[rows] += ye * w[rows, slot, None]    # a token picks e once
    return out.view(b, s, d)


def mamba(p, h, a: Dict, mm: Matmul):
    """Mamba-1: in-projection to (x, z); a causal depthwise convolution of
    width d_conv and SiLU on x; dt, B, C projected from x; delta =
    softplus(dt W + b); per channel and state, h_t = exp(delta_t A) h_{t-1}
    + delta_t x_t B_t with A = -exp(a_log); y_t = <h_t, C_t> + D x_t;
    out = (y * SiLU(z)) W_out."""
    ssm = a["ssm"]
    b, s, d = h.shape
    di, n = ssm["expand"] * d, ssm["d_state"]
    rank = ssm.get("dt_rank") or -(-d // 16)
    xz = mm(h, p["w_in"])
    x, z = xz[..., :di], xz[..., di:]
    kw = p["conv_w"].float()                             # (K, di)
    k = kw.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    x = sum(xp[:, i:i + s] * kw[i] for i in range(k)) + p["conv_b"].float()
    x = F.silu(x)
    dbc = mm(x, p["x_proj"])
    dt, bm, cm = dbc[..., :rank], dbc[..., rank:rank + n], dbc[..., rank + n:]
    delta = F.softplus(mm(dt, p["dt_w"]) + p["dt_b"].float())   # (B, S, di)
    A = -torch.exp(p["a_log"].float())                           # (di, N)
    state = torch.zeros(b, di, n, dtype=torch.float32, device=h.device)
    ys = []
    for t in range(s):
        dl = delta[:, t, :, None]
        state = torch.exp(dl * A) * state + (dl * x[:, t, :, None]) * bm[:, t, None, :]
        ys.append((state * cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + p["d"].float() * x
    return mm(y * F.silu(z), p["w_out"])


def _layer(x, lp, kind: str, moe_here: bool, a: Dict, eps: float,
           mm: Matmul, rope):
    h = rms_norm(x, lp["norm1"]["scale"], eps)
    x = x + (attention(lp["mixer"], h, a, mm, rope) if kind == "attn"
             else mamba(lp["mixer"], h, a, mm))
    h = rms_norm(x, lp["norm2"]["scale"], eps)
    return x + (moe(lp["ffn"], h, a, mm) if moe_here
                else mlp(lp["ffn"], h, mm))


def _moe_on(a: Dict, pos: int) -> bool:
    m = a.get("moe")
    return m is not None and pos % m["every_k_layers"] == m["every_k_layers"] - 1


def hidden(params, tokens: torch.Tensor, config: Dict, mm: Matmul,
           checkpoint: bool = False) -> torch.Tensor:
    """Final normed hidden states (B, S, d), float32. ``checkpoint``
    recomputes each layer in the backward pass (the same numbers, less
    memory)."""
    a, eps = config["arch"], config["rms_norm_eps"]
    pattern = a["layer_pattern"]
    x = params["embed"]["tok"][tokens].float()
    rope = None
    if a.get("rope", "rope") == "rope":
        rope = rope_tables(tokens.shape[1],
                           a.get("head_dim") or a["d_model"] // a["n_heads"],
                           a["rope_theta"], tokens.device)
    for pi in range(a["n_layers"] // len(pattern)):
        for pos, kind in enumerate(pattern):
            lp = _index(params["blocks"][pos], pi)
            args = (lp, kind, _moe_on(a, pos), a, eps, mm, rope)
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(
                    _layer, x, *args, use_reentrant=False)
            else:
                x = _layer(x, *args)
    return rms_norm(x, params["norm_f"]["scale"], eps)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def logits(params, x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(x, params["embed"]["unembed"])


def lm_loss(params, tokens, targets, config: Dict, mm: Matmul,
            checkpoint: bool = True) -> torch.Tensor:
    """Mean token cross-entropy over every row given (the rows of S^t)."""
    lg = logits(params, hidden(params, tokens, config, mm, checkpoint), mm)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())


@torch.no_grad()
def served_gaps(params, config: Dict, seqs, mm: Matmul,
                control: Optional[Matmul] = None) -> list:
    """For each (prompt, served tokens): the gap by which each served
    token's logit lies below the reference's best at its position, read
    over the prompt and the served tokens in one causal forward. With
    ``control``, at each position the gap of the token the control puts
    first instead. ``seqs`` are processed together (right-padded)."""
    dev = params["embed"]["tok"].device
    lens = [len(p) + len(g) - 1 for p, g in seqs]
    toks = torch.zeros(len(seqs), max(lens), dtype=torch.long, device=dev)
    for i, (p, g) in enumerate(seqs):
        full = list(p) + list(g[:-1])
        toks[i, :len(full)] = torch.as_tensor(full, device=dev)
    x = hidden(params, toks, config, mm)
    xc = hidden(params, toks, config, control) if control is not None else None
    out = []
    for i, (p, g) in enumerate(seqs):
        rows = slice(len(p) - 1, len(p) - 1 + len(g))
        ref = logits(params, x[i, rows], mm)
        if control is None:
            pick = torch.as_tensor(list(g), device=dev).long()
        else:
            pick = logits(params, xc[i, rows], control).argmax(-1)
        gap = ref.amax(-1) - ref.gather(-1, pick[:, None])[:, 0]
        out.append(gap.tolist())
    return out
