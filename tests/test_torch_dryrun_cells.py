"""Every live cell of ``repro_torch.launch.dryrun`` builds and traces on
the meta device: the 32 (arch x shape) cells of ``live_cells()`` on the
single-pod mesh at one period of depth (full width), a cell of each
layout on the multi-pod mesh, and the general train modes, which refuse
the production meshes' model axis of 16 (their training compute is not
tensor-parallel) and are recorded ``ok: False`` with that refusal.

The numbers are held against the reference in ``test_torch_dryrun.py``;
here every record must carry them: finite FLOPs above zero, HBM bytes,
argument, output and temporary bytes, and collectives only on the train
cells (the placed step's gathers and gradient reductions) and the
serving cells that run tensor-parallel (the dense decoders' all-reduces
over "model")."""
import math

import pytest

from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D


def _check(rec):
    assert rec["ok"], rec.get("traceback")
    h, m = rec["hlo"], rec["memory"]
    assert math.isfinite(h["flops"]) and h["flops"] > 0
    assert h["hbm_bytes"] > 0 and h["unknown_trip_counts"] == 0
    assert rec["cost"] == {"flops": h["flops"],
                           "bytes accessed": h["hbm_bytes"]}
    assert min(m.values()) > 0
    if rec["kind"] == "train" or "tensor-parallel" in rec["compute"]:
        assert h["collective_count"] > 0
        assert h["collectives"]["all-reduce"] == h["collective_bytes"]
    else:
        assert h["collective_count"] == 0


@pytest.mark.parametrize("arch,shape", D.live_cells())
def test_live_cell_builds_at_one_period(arch, shape, tmp_path):
    cfg = get_config(arch)
    rec = D.run_cell(arch, shape, False, out_dir=str(tmp_path),
                     cfg_patch={"n_layers": cfg.period})
    _check(rec)
    assert rec["chips"] == 256 and rec["n_agents"] == 16
    assert rec["dp"] == ["data"] or rec["uneven"]


@pytest.mark.parametrize("layout", sorted(D.LAYOUTS))
def test_multi_pod_cell_builds(layout, tmp_path):
    rec = D.run_cell("qwen2-0.5b", "train_4k", True, out_dir=str(tmp_path),
                     layout=layout, cfg_patch={"n_layers": 1})
    _check(rec)
    assert rec["chips"] == 512
    if layout == "baseline":
        assert rec["n_agents"] == 32 and rec["dp"] == ["pod", "data"]
        assert not rec["uneven"]
    else:   # 256 sequences do not split over 512 dp ranks
        assert rec["n_agents"] == 512 and rec["dp"] == ["pod", "data"]
        assert rec["uneven"]


@pytest.mark.parametrize("mode", D.GENERAL_MODES)
def test_general_modes_refuse_the_model_axis(mode, tmp_path):
    rec = D.run_cell("qwen2-0.5b", "train_4k", False, mode=mode,
                     out_dir=str(tmp_path), cfg_patch={"n_layers": 1})
    assert not rec["ok"]
    assert "want model = 1" in rec["error"]
    assert (tmp_path / "qwen2-0.5b__train_4k__single.json").exists()
