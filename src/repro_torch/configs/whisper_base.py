"""Whisper base — encoder-decoder audio transformer; conv frontend stubbed
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                 # decoder layers
    encoder_layers=6,
    encoder_decoder=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    attention="gqa",
    layer_pattern=("attn",),
    rope="learned",
    encoder_seq=1500,
    frontend="audio",
    norm="layernorm",
    act="gelu",
    source="arXiv:2212.04356",
))
