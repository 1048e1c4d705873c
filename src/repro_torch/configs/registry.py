"""Registry of the ported architectures (``--arch <id>``): every
architecture of ``repro.configs.registry``, the same names and fields."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"arch {cfg.name!r} registered twice")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # importing each module registers its config (once: modules import once)
    from repro_torch.configs import (  # noqa: F401
        arctic_480b, deepseek_v2_236b, jamba_v0_1_52b, qwen1_5_4b,
        qwen2_0_5b, qwen2_1_5b, qwen2_vl_2b, rwkv6_3b, whisper_base, yi_6b)
