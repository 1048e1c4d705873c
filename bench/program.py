"""The system under test: the port's package (``src/repro_torch``) and
the ``ArchConfig`` a configuration file describes."""
from __future__ import annotations

import sys
from typing import Dict

from spec import ROOT

SRC = ROOT / "src"


def import_port():
    """Put the port on the path; a checkout without it cannot run."""
    if not (SRC / "repro_torch" / "__init__.py").exists():
        raise FileNotFoundError(f"the port is not in this checkout "
                                f"({SRC / 'repro_torch'})")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def arch_config(config: Dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    import_port()
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    a = dict(config["arch"])
    a["layer_pattern"] = tuple(a["layer_pattern"])
    if a.get("moe") is not None:
        a["moe"] = MoEConfig(**a["moe"])
    if a.get("ssm") is not None:
        a["ssm"] = SSMConfig(**a["ssm"])
    return ArchConfig(**a)
