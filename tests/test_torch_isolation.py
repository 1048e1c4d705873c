"""The port stands alone: every module of ``repro_torch``,
``chip_smoke.py`` and the ``examples/torch_*.py`` twins import with
``jax`` and ``repro`` made unimportable, no source line imports either,
the dry run (``launch.dryrun``, ``launch.hlo_analysis``) among them, a
meta-device dry run builds and launches no kernel, and the entry points
refuse to run on the CPU unless asked:
``device="cuda"`` without CUDA raises (the engines, the serving stack,
``launch.serve.greedy_generate``, the simulator's train runner and fleet,
and the examples' ``main``), and ``chip_smoke.py`` exits non-zero with no
result line."""
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
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

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
for path in [{str(ROOT / "chip_smoke.py")!r},
             *{[str(p) for p in EXAMPLES]!r}]:
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
assert {{"repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
         "repro_torch.dist.tp"}} <= set(names), names
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50        # every module imported


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b")
    files = [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             *EXAMPLES]
    assert len(EXAMPLES) == 4
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


def test_spmd_entry_points_default_to_cuda(monkeypatch):
    """The SPMD layer's entry points run on the card unless asked for the
    CPU (the train state, the loop, the mesh, the sharded ledger and the
    rank runner), and the runner names its backend: none is picked
    silently."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.ledger import ShardedGradLedger
    from repro_torch.launch.loop import TrainLoop
    from repro_torch.launch.mesh import Mesh, make_test_mesh, run_ranks
    from repro_torch.launch.train import TrainConfig, init_state
    cfg = get_config("qwen2-0.5b").reduced()
    one = Mesh((1, 1), ("data", "model"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(torch.Generator().manual_seed(0), cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainLoop(cfg, TrainConfig(), iter(()), n_agents=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh(data=1, model=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedGradLedger(2, 4, "cuda", mesh=one, axes=("data",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(print, 1, backend="gloo", device="cuda", timeout=5)
    with pytest.raises(ValueError, match="backend"):
        run_ranks(print, 1, backend="auto", device="cpu", timeout=5)


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launch_serve_and_examples_default_to_cuda(monkeypatch):
    """``greedy_generate`` and the three example twins run on the card
    unless asked for the CPU (``--device cpu``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.model import init_model
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(params, cfg, np.zeros((1, 4), np.int32), 16, 2)
    for name in ("torch_quickstart", "torch_byzantine_cge",
                 "torch_serve_lm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _example(name).main([])


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


def test_meta_dry_run_builds_no_kernel(monkeypatch, tmp_path):
    """A dry run on the meta device takes every kernel's plain form by
    the tensors' device: nothing is built, loaded or launched, and asking
    for the CUDA kernel on a meta tensor raises."""
    from repro_torch.kernels import _build, agg, cge_norms, ops
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch import dryrun
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise AssertionError("a dry run built a kernel")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    mods = (agg, cge_norms, decode_attention, flash_attention)
    before = [dict(m.LAUNCHES) for m in mods]
    for arch, shape in (("qwen2-0.5b", "decode_32k"),
                        ("qwen2-0.5b", "train_4k"),
                        ("deepseek-v2-236b", "prefill_32k")):
        rec = dryrun.run_cell(arch, shape, False, out_dir=str(tmp_path),
                              cfg_patch={"n_layers": 1})
        assert rec["ok"], rec.get("traceback")
    q = torch.empty((2, 4, 64), device="meta")
    pages = torch.empty((3, 8, 2, 64), device="meta")
    table = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    lens = torch.ones(2, dtype=torch.int32, device="meta")
    out = ops.paged_decode_attention(q, pages, pages, table, lens)
    assert out.shape == (2, 4, 64) and out.device.type == "meta"
    assert ops.block_sq_norms(torch.empty((5, 16), device="meta")).shape \
        == (5,)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(q, pages, pages, table, lens,
                                   impl="cuda")
    assert calls == []
    assert [dict(m.LAUNCHES) for m in mods] == before
