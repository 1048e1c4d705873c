"""Model FLOPs and kernel bytes, counted from a configuration's shapes.

Counts read only the configuration file's ``arch`` entry (the widths as
run) and never the program. A matrix product of an (m, k) by a (k, n)
is 2 m k n operations. Model FLOPs count what the model needs, not
what a path computes: an MoE layer counts its top-k experts (not the
drop-free capacity the serving engine computes), attention counts each
token's causal context, and recomputation in the backward pass is not
counted. The embedding lookup, norms, rotary embedding, softmax and the
Mamba scan's elementwise recurrence are not matrix products and are left
out.
"""
from __future__ import annotations

from typing import Dict


def _moe_on(arch: Dict, idx: int) -> bool:
    moe = arch.get("moe")
    return moe is not None and idx % moe["every_k_layers"] == moe["every_k_layers"] - 1


def _layers(arch: Dict):
    """(kind, position in the pattern) of every layer."""
    pat = arch["layer_pattern"]
    return [(pat[i % len(pat)], i % len(pat)) for i in range(arch["n_layers"])]


def _head_dim(arch: Dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def _dt_rank(arch: Dict) -> int:
    r = arch["ssm"].get("dt_rank", 0)
    return r or -(-arch["d_model"] // 16)


def _mixer_matmul(arch: Dict, kind: str) -> int:
    d = arch["d_model"]
    if kind == "attn":
        hd = _head_dim(arch)
        return 2 * d * arch["n_heads"] * hd + 2 * d * arch["n_kv_heads"] * hd
    ssm = arch["ssm"]
    di = ssm["expand"] * d
    rank = _dt_rank(arch)
    return d * 2 * di + di * (rank + 2 * ssm["d_state"]) + rank * di + di * d


def _mixer_other(arch: Dict, kind: str) -> int:
    """Parameters of a mixer that no matrix product reads."""
    if kind == "attn":
        return 0
    ssm = arch["ssm"]
    di = ssm["expand"] * arch["d_model"]
    return ssm["d_conv"] * di + di + di + di * ssm["d_state"] + di


def _ffn(arch: Dict, idx: int, active: bool) -> int:
    d = arch["d_model"]
    if not _moe_on(arch, idx):
        return 3 * d * arch["d_ff"]
    moe = arch["moe"]
    experts = moe["top_k"] if active else moe["num_experts"]
    return d * moe["num_experts"] + experts * 3 * d * moe["d_ff_expert"]


def matmul_params(arch: Dict, active: bool = True) -> int:
    """Weights a token's forward pass multiplies by: every projection and
    MLP (an MoE layer's router and its top-k experts where ``active``),
    and the unembedding; not the embedding lookup."""
    n = arch["d_model"] * arch["vocab_size"]
    for kind, p in _layers(arch):
        n += _mixer_matmul(arch, kind) + _ffn(arch, p, active)
    return n


def total_params(arch: Dict, active: bool = False) -> int:
    """Every parameter: embeddings, norms and the Mamba vectors too."""
    d, v = arch["d_model"], arch["vocab_size"]
    n = d * v * (1 if arch.get("tie_embeddings") else 2) + d
    for kind, p in _layers(arch):
        n += (_mixer_matmul(arch, kind) + _mixer_other(arch, kind)
              + _ffn(arch, p, active) + 2 * d)
    return n


def attn_layers(arch: Dict) -> int:
    return sum(1 for kind, _ in _layers(arch) if kind == "attn")


def attn_width(arch: Dict) -> int:
    return arch["n_heads"] * _head_dim(arch)


def train_flops_per_token(arch: Dict, seq: int) -> float:
    """Forward and backward of one token of a ``seq``-token causal
    sequence: 6 x the matmul parameters, plus 6 x seq x H x head_dim per
    attention layer (QK^T and PV over half the sequence on average,
    times three for the backward)."""
    return (6.0 * matmul_params(arch)
            + 6.0 * seq * attn_width(arch) * attn_layers(arch))


def prefill_flops(arch: Dict, s: int) -> float:
    """A causal forward over an ``s``-token prompt."""
    return (2.0 * matmul_params(arch) * s
            + 2.0 * attn_width(arch) * s * s * attn_layers(arch))


def decode_flops(arch: Dict, n: int, ctx_sum: float) -> float:
    """``n`` decoded tokens whose contexts (the tokens each attends to)
    sum to ``ctx_sum``."""
    return (2.0 * matmul_params(arch) * n
            + 4.0 * attn_width(arch) * ctx_sum * attn_layers(arch))


def decode_attn_bytes(arch: Dict, n: int, ctx_sum: float,
                      elt: int = 2) -> float:
    """Bytes the paged decode must move for ``n`` (slot, step) calls per
    attention layer whose contexts sum to ``ctx_sum``: each token's K and
    V rows read once, each query read and each output written once."""
    hd = _head_dim(arch)
    kv = ctx_sum * 2 * arch["n_kv_heads"] * hd * elt
    qo = n * 2 * arch["n_heads"] * hd * elt
    return (kv + qo) * attn_layers(arch)
