"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attention="gqa",
    # one attention layer per 8 (1:7 attn:mamba interleave)
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  every_k_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope="none",            # Jamba uses no positional encoding
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2403.19887",
))
