"""Qwen2-VL-2B — VLM backbone only (patch embeds stubbed via input_specs);
M-RoPE with (t,h,w) sections. [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
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
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    source="arXiv:2409.12191",
))
