"""Qwen2-0.5B — dense GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
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
