"""Registry of the ported architectures (``--arch <id>``).

The dense GQA decoders are ported (qwen2-0.5b, qwen2-1.5b, qwen1.5-4b,
yi-6b). The other families of ``repro.configs.registry`` (MoE, MLA,
SSM/RWKV, hybrid, encoder-decoder, vision) are not: asking for one of
them raises ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}

# archs of the reference whose model family the port does not have yet
NOT_PORTED = {
    "arctic-480b": "moe", "deepseek-v2-236b": "moe (MLA)",
    "jamba-v0.1-52b": "hybrid (SSM)", "rwkv6-3b": "ssm (RWKV)",
    "whisper-base": "audio (encoder-decoder)", "qwen2-vl-2b": "vlm",
}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"arch {cfg.name!r} registered twice")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _load_all()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} ({NOT_PORTED[name]}) is not ported yet: its "
            "model family comes with ROADMAP Queue 1 item 6")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # importing each module registers its config (once: modules import once)
    from repro_torch.configs import (  # noqa: F401
        qwen1_5_4b, qwen2_0_5b, qwen2_1_5b, yi_6b)
