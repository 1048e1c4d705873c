"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` import with ``jax`` and ``repro`` made unimportable, no
source line imports either, and the entry points refuse to run on the
CPU unless asked: ``device="cuda"`` without CUDA raises (the engines,
the serving stack and the simulator's train runner and fleet), and
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
    assert int(out.stdout.split()[-1]) >= 50        # every module imported


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b")
    files = [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    bad = [f"{p}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad


@pytest.mark.parametrize("module", ["flash_attention", "cge_norms"])
def test_kernel_module_stands_alone_and_needs_a_card(module):
    """The flash-attention and CGE-norm kernel modules import with ``jax``
    and ``repro`` made unimportable, and their wrappers refuse a tensor
    that is not on a card (the plain forms run anywhere)."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {str(SRC)!r})
import torch
from repro_torch.kernels import {module} as mod
x = torch.zeros((2, 2, 8, 8))
calls = {{"flash_attention": lambda: mod.flash_attention(x, x, x),
         "cge_norms": lambda: mod.block_sq_norms(x[0, 0])}}
try:
    calls[{module!r}]()
except ValueError as e:
    assert "CUDA" in str(e), e
else:
    raise AssertionError("the wrapper ran on the CPU")
if {module!r} == "cge_norms":
    try:
        mod.masked_scale(x[0, 0], torch.ones(8))
    except ValueError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("the wrapper ran on the CPU")
assert not [k for k, v in sys.modules.items()
            if v is not None and k.split(".")[0] in ("jax", "jaxlib", "repro")]
print(sum(mod.LAUNCHES.values()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "0"


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


def test_simulator_entry_points_default_to_cuda(monkeypatch):
    """``run_train`` and ``EngineFleet`` run on the card unless asked for
    the CPU; ``run_serve`` is numpy and needs no device."""
    from repro_torch.sim.e2e import EngineFleet
    from repro_torch.sim.golden import build_trace
    from repro_torch.sim.scenario import get_scenario, run_serve, run_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = get_scenario("steady_state")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_train(sc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_train(sc, agg_backend="device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineFleet(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trace("steady_state")
    assert run_serve(sc).violations == []


def test_prefix_cache_and_fleet_entry_points_default_to_cuda(monkeypatch):
    """The prefix-cached engine and cache, and ``run_fleet_e2e`` without
    a fleet, run on the card unless asked for the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_model
    from repro_torch.serve import PagedCacheConfig, PagedKVCache, ServeEngine
    from repro_torch.sim.fleet_e2e import run_fleet_e2e
    from repro_torch.sim.scenario import get_scenario
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    ServeEngine(params, cfg, prefix_cache="on", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params, cfg, prefix_cache="on")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(cfg, PagedCacheConfig(), enable_prefix=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fleet_e2e(get_scenario("crash_cascade"), n_requests=2)


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
