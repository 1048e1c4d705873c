"""RWKV-6 'Finch' 3B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig, RWKVConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # d_model / head_dim(64)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    layer_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, ddlerp_lora=32),
    rope="none",
    norm="layernorm",
    act="gelu",                 # channel-mix uses squared-relu internally
    source="arXiv:2404.05892",
))
