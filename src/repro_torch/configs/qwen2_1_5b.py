"""Qwen2-1.5B — dense GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    attention="gqa",
    layer_pattern=("attn",),
    rope="rope",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    source="arXiv:2407.10671",
))
