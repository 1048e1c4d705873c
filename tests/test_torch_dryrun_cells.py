"""Every live cell of ``repro_torch.launch.dryrun`` builds and traces on
the meta device: the 32 (arch x shape) cells of ``live_cells()`` on the
single-pod mesh at one period of depth (full width), a cell of each
layout on the multi-pod mesh, and the general train modes on the
production meshes' model axis of 16: tensor-parallel for every family
(a dense decoder each mode on one pod, cge on two; whisper's
encoder-decoder cge on one).

The numbers are held against the reference in ``test_torch_dryrun.py``;
here every record must carry them: finite FLOPs above zero, HBM bytes,
argument, output and temporary bytes, and collectives only on the train
cells (the placed step's gathers and gradient reductions) and the
serving cells that run tensor-parallel (the dense decoders' all-reduces
over "model")."""
import math

import pytest

from repro_torch.configs.base import get_shape
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import tree_flatten
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as T
from repro_torch.launch.specs import max_pos_for, train_batch_specs


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
def test_general_modes_build_at_one_period(mode, tmp_path):
    rec = D.run_cell("qwen2-0.5b", "train_4k", False, mode=mode,
                     out_dir=str(tmp_path), cfg_patch={"n_layers": 1})
    _check(rec)
    assert rec["mode"] == mode and rec["n_agents"] == 16
    assert "tensor-parallel" in rec["compute"]
    assert (tmp_path / "qwen2-0.5b__train_4k__single.json").exists()


def test_general_multi_pod_cell_builds(tmp_path):
    rec = D.run_cell("qwen2-0.5b", "train_4k", True, mode="cge",
                     out_dir=str(tmp_path), cfg_patch={"n_layers": 1})
    _check(rec)
    assert rec["chips"] == 512 and rec["n_agents"] == 32
    assert rec["dp"] == ["pod", "data"] and not rec["uneven"]
    assert "tensor-parallel" in rec["compute"]


def test_general_non_dense_cell_computes_whole(tmp_path):
    """whisper-base (the encoder-decoder, once computed whole on every rank;
    the name is kept from then) at one period: recorded ``ok`` and
    tensor-parallel, the rank's arguments short of the whole parameters
    and moments with the global batch."""
    cfg = get_config("whisper-base")
    patch = {"n_layers": cfg.period}
    rec = D.run_cell("whisper-base", "train_4k", False, mode="cge",
                     out_dir=str(tmp_path), cfg_patch=patch)
    _check(rec)
    assert "tensor-parallel" in rec["compute"]
    state = T.abstract_state(D._apply_cfg_patch(cfg, patch),
                             T.TrainConfig(mode="cge"),
                             max_pos=max_pos_for(get_shape("train_4k")))
    whole = sum(l.numel() * l.element_size() for k in ("params", "opt")
                for l in tree_flatten(state[k])[0])
    batch = sum(l.numel() * l.element_size() for l in train_batch_specs(
        cfg, get_shape("train_4k"), rec["n_agents"]).values())
    assert 0 < rec["memory"]["argument_size_in_bytes"] < whole + batch
