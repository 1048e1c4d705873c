"""Qwen1.5-4B — dense, QKV bias, kv=20 (full-head GQA).
[hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    attention="gqa",
    layer_pattern=("attn",),
    rope="rope",
    rope_theta=5_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="hf:Qwen/Qwen1.5-4B",
))
