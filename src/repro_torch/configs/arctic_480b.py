"""Snowflake Arctic 480B — 128-expert top-2 MoE with a parallel dense
residual MLP on every layer. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    attention="gqa",
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
    rope="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="hf:Snowflake/snowflake-arctic-base",
))
