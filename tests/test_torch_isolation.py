"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` import with ``jax`` and ``repro`` made unimportable, no
source line imports either, and the entry points refuse to run on the
CPU unless asked: ``device="cuda"`` without CUDA raises, and
``chip_smoke.py`` exits non-zero with no result line."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = f"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {str(SRC)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 39        # every module imported


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b")
    files = [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    bad = [f"{p}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.async_engine import AsyncEngine, EngineConfig
    from repro_torch.models import lenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncEngine(lambda j, x, rng: x, np.zeros(3), EngineConfig(n_agents=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncEngine(lambda j, x, rng: x, np.zeros(3),
                    EngineConfig(n_agents=4, agg_backend="device"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lenet.make_agent_grad_fn([], 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lenet.init_lenet(torch.Generator().manual_seed(0))


def test_serving_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_cache, init_model
    from repro_torch.serve import PagedKVCache, PagedCacheConfig, ServeEngine
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(cfg, PagedCacheConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 2, 8)


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py runs there")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
