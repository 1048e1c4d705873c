"""``repro_torch.launch.dryrun`` held rank by rank against the reference's
dry run on the production mesh (16 x 16, one pod), at full width.

``scripts/reference_dryrun.py`` runs the reference's ``run_cell`` in a
subprocess: 512 forced host devices, its ``make_production_mesh``
replaced at run time by a mesh of ``Auto`` axes (jax 0.9.0's
``make_mesh`` makes ``Explicit`` ones, under which the reference's
``with_sharding_constraint`` refuses to lower), then ``compile``,
``hlo_analysis.analyze`` and ``memory_analysis`` per cell. Against it:

(a) dp_all FLOPs per rank within 5% for qwen2-0.5b train_4k, prefill_32k
    and decode_32k, and deepseek-v2-236b train_4k (the reference's MoE
    group size).
(b) ``argument_size_in_bytes`` exactly the reference's for qwen2-0.5b
    train_4k in both layouts.
(c) the baseline cells run tensor-parallel over "model" (``dist.tp``):
    each record's FLOPs within [0.90, 1.10] of the reference's, and the
    one-layer cell's equal to rank 0 of the TP step (placed train step,
    ``launch.serve``'s steps on ``place_params`` / ``place_cache``) on a
    recording mesh.
(e) the general train step's cells (cge, stale, trimmed, quantized) of
    qwen2-0.5b train_4k on one pod, tensor-parallel over "model": each
    record's argument bytes exactly the reference's general cell's (the
    agent's ledger and residual rows whole on every model rank) and its
    FLOPs within [0.90, 1.10] of it.
(g) arctic-480b (MoE: 128 experts, 8 a rank over "model", top-2, a
    dense residual) at full depth (35 layers) on one pod: its baseline
    train_4k, prefill_32k and decode_32k cells and its cge and quantized
    general cells tensor- and expert-parallel, each within [0.90, 1.10]
    of the reference's FLOPs a rank, the train cells' argument bytes
    exactly the reference's.
(h) deepseek-v2-236b (MLA over "model", 160 experts, 10 a rank, top-6,
    2 shared experts) at one period of depth on one pod (the full 60
    layers cost ~2 min more here; why one stands for 60 is in the
    test): its baseline train_4k, prefill_32k and decode_32k cells and
    its cge general cell, each within [0.90, 1.10] of the reference's
    FLOPs a rank and its argument bytes exactly the reference's.
(d) the placed step's collective bytes equal a count summed here from
    the storage specs, the compute specs the baseline gathers to and the
    TP layer's all-reduces per layer, and on 2 gloo ranks of the CPU the
    real mesh reports the collectives a recording mesh of the same shape
    does.
(f) the CLI writes a record per mesh with the reference's keys, and
    ``reanalyze`` rebuilds ``hlo`` from the saved op table unchanged.

Every live cell building is ``test_torch_dryrun_cells.py``. Also here,
the two repairs the dry run needed: ``make_decode_step`` runs on the meta
device for every family's reduced config, and M-RoPE's sections with
``output_size`` are bit-identical to the old form.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_shape
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.dist.sharding import (ALIGN, MeshRules, _zip_specs,
                                       compute_rules, shard_tree, tree_specs)
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import OpCounter, analyze
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.serve import (make_decode_step, make_prefill_step,
                                      place_cache, place_params)
from repro_torch.launch.specs import max_pos_for
from repro_torch.launch.train import (TrainConfig, abstract_state,
                                      make_train_step)
from repro_torch.models.layers import rope_cos_sin, rope_freqs
from repro_torch.models.model import init_cache, init_model

ROOT = Path(__file__).resolve().parents[1]
QWEN, DEEPSEEK, ARCTIC = "qwen2-0.5b", "deepseek-v2-236b", "arctic-480b"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CELLS = ([(QWEN, s, lay) for s in SHAPES for lay in ("baseline", "dp_all")]
         + [(DEEPSEEK, "train_4k", "dp_all")]
         + [(ARCTIC, s, "baseline") for s in SHAPES])
GENERAL = (QWEN, ARCTIC)
FLOPS_REL = 0.05
SIZES = {"data": 16, "model": 16}
META = torch.device("meta")

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records of ``CELLS``, by
    ``scripts/reference_dryrun.py`` (one process per layout)."""
    out = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    recs = {}
    for layout in ("baseline", "dp_all"):
        cells = [f"{a}:{s}" for a, s, lay in CELLS if lay == layout]
        run = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
             "--out", str(out), "--layout", layout, "--tag", layout, *cells],
            capture_output=True, text=True, timeout=600, env=env)
        assert run.returncode == 0, run.stderr[-3000:]
        for cell in cells:
            arch, shape = cell.split(":")
            rec = json.loads((out / f"{arch}__{shape}__single__{layout}"
                              ".json").read_text())
            assert rec["ok"], rec.get("error")
            recs["|".join((arch, shape, layout))] = rec
    run = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
         "--out", str(out), "--mode", ",".join(D.GENERAL_MODES),
         *(f"{a}:train_4k" for a in GENERAL)],
        capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    for arch in GENERAL:
        for mode in D.GENERAL_MODES:
            rec = json.loads((out / f"{arch}__train_4k__single__{mode}"
                                    ".json").read_text())
            assert rec["ok"] and rec["mode"] == mode, rec.get("error")
            recs[f"{arch}|train_4k|{mode}"] = rec
    # deepseek-v2 at one period of depth: its baseline cells, then cge
    for mode, cells in (("masked", SHAPES), ("cge", ("train_4k",))):
        run = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
             "--out", str(out), "--period", "--mode", mode,
             *(f"{DEEPSEEK}:{c}" for c in cells)],
            capture_output=True, text=True, timeout=600, env=env)
        assert run.returncode == 0, run.stderr[-3000:]
        for shape in cells:
            tag = D.record_tag(None, True, mode)
            rec = json.loads((out / f"{DEEPSEEK}__{shape}__single__{tag}"
                                    ".json").read_text())
            assert rec["ok"] and rec["mode"] == mode, rec.get("error")
            recs[f"{DEEPSEEK}|{shape}|{tag}"] = rec
    return recs


@pytest.fixture(scope="module")
def records(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for arch, shape, layout in CELLS:
        key = "|".join((arch, shape, layout))
        rec = D.run_cell(arch, shape, False, layout=layout, out_dir=str(out),
                         tag=layout, reference=reference[key])
        assert rec["ok"], rec.get("traceback")
        recs[key] = rec
    return recs


@pytest.mark.parametrize("arch,shape", [(QWEN, "train_4k"),
                                        (QWEN, "prefill_32k"),
                                        (QWEN, "decode_32k"),
                                        (DEEPSEEK, "train_4k")])
def test_dp_all_flops_within_five_percent(records, reference, arch, shape):
    key = f"{arch}|{shape}|dp_all"
    port, ref = records[key]["hlo"]["flops"], reference[key]["hlo"]["flops"]
    assert port == pytest.approx(ref, rel=FLOPS_REL)
    assert records[key]["cost"]["flops"] == port
    assert records[key]["flops_ratio"] == port / ref


@pytest.mark.parametrize("layout", ["baseline", "dp_all"])
def test_train_argument_bytes_exactly_the_references(records, reference,
                                                     layout):
    key = f"{QWEN}|train_4k|{layout}"
    assert records[key]["memory"]["argument_size_in_bytes"] == \
        reference[key]["memory"]["argument_size_in_bytes"]


# the reference's general cells' argument bytes a rank (jax 0.9.0 CPU,
# 512 forced devices): parameters and moments in TP blocks, replicated
# over dp, plus the stale ledger row (4 x 494,032,768 B) and its 4-byte
# timestamp, or the quantized residual row
GENERAL_ARG_BYTES = {"cge": 361_837_380, "stale": 2_337_968_456,
                     "trimmed": 361_837_380, "quantized": 2_337_968_452}


@pytest.mark.parametrize("mode", D.GENERAL_MODES)
def test_general_cell_against_the_reference(reference, mode, tmp_path):
    ref = reference[f"{QWEN}|train_4k|{mode}"]
    rec = D.run_cell(QWEN, "train_4k", False, mode=mode,
                     out_dir=str(tmp_path), tag=mode, reference=ref)
    assert rec["ok"], rec.get("traceback")
    assert "tensor-parallel" in rec["compute"]
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"] == GENERAL_ARG_BYTES[mode]
    assert rec["flops_ratio"] == rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= rec["flops_ratio"] <= 1.10


@pytest.mark.parametrize("shape", SHAPES)
def test_arctic_baseline_cells_within_the_band(records, reference, shape):
    """arctic's experts over "model" (8 of 128 a rank), its router's
    logits gathered, its GQA attention over gcd(56, 16) = 8 head groups,
    its dense residual and untied unembedding split: one rank's FLOPs
    within [0.90, 1.10] of the reference's, train arguments exact."""
    key = f"{ARCTIC}|{shape}|baseline"
    rec, ref = records[key], reference[key]
    assert "tensor-parallel" in rec["compute"]
    assert rec["flops_ratio"] == rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= rec["flops_ratio"] <= 1.10
    if shape == "train_4k":
        assert rec["memory"]["argument_size_in_bytes"] == \
            ref["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("mode", ["cge", "quantized"])
def test_arctic_general_cell_against_the_reference(reference, mode,
                                                   tmp_path):
    ref = reference[f"{ARCTIC}|train_4k|{mode}"]
    rec = D.run_cell(ARCTIC, "train_4k", False, mode=mode,
                     out_dir=str(tmp_path), tag=mode, reference=ref)
    assert rec["ok"], rec.get("traceback")
    assert "tensor-parallel" in rec["compute"]
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert 0.90 <= rec["flops_ratio"] <= 1.10


@pytest.mark.parametrize("shape,mode", [(s, "masked") for s in SHAPES]
                         + [("train_4k", "cge")])
def test_deepseek_cells_within_the_band(reference, shape, mode, tmp_path):
    """deepseek-v2's MLA over "model" (its latents projected on a rank's
    columns, normed by block sums of squares summed over tp and gathered;
    ``w_uk`` / ``w_uv`` re-laid to 8 whole heads a rank; ``wo`` a row
    block) and its 160 experts, 10 a rank, at one period of depth (one
    layer): one rank's FLOPs within [0.90, 1.10] of the reference's
    (train 0.974, prefill and decode 1.000, cge 0.974) and the argument
    bytes exactly the reference's, the decode's cache in
    ``cache_specs``' latent blocks included. One layer stands for the
    full 60: a cell's FLOPs are E + L x (one layer's), and by the CLI's
    records at 1 and 60 layers both the layer's ratio (0.955) and the
    rest's (1.001) lie in the band, so every depth's does (60 layers:
    0.956, 1.000, 1.000, cge 0.956; ROADMAP item 11d)."""
    tag = D.record_tag(None, True, mode)
    ref = reference[f"{DEEPSEEK}|{shape}|{tag}"]
    rec = D.run_cell(DEEPSEEK, shape, False, mode=mode,
                     out_dir=str(tmp_path), tag=tag, reference=ref,
                     cfg_patch={"n_layers": get_config(DEEPSEEK).period})
    assert rec["ok"], rec.get("traceback")
    assert "tensor-parallel" in rec["compute"]
    assert rec["flops_ratio"] == rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= rec["flops_ratio"] <= 1.10
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


def _period_flops(step, *args):
    with OpCounter() as cnt:
        step(*args)
    return analyze(cnt)["flops"]


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_baseline_equals_unplaced_step_and_states_its_ratio(
        records, reference, shape, tmp_path):
    """The baseline cell is the tensor-parallel step: one rank's FLOPs
    within 10% of the reference's, and the one-layer cell's equal to rank
    0 of the TP step built here on a recording mesh of the same shape."""
    key = f"{QWEN}|{shape}|baseline"
    rec = records[key]
    assert rec["flops_ratio"] == \
        rec["hlo"]["flops"] / reference[key]["hlo"]["flops"]
    assert 0.90 <= rec["flops_ratio"] <= 1.10
    assert rec["dp"] == ["data"] and not rec["uneven"]
    assert "tensor-parallel" in rec["compute"]

    # one layer: the cell against rank 0 of the TP step on its dp block
    cfg = dataclasses.replace(get_config(QWEN), n_layers=1)
    one = D.run_cell(QWEN, shape, False, out_dir=str(tmp_path),
                     cfg_patch={"n_layers": 1})
    s = get_shape(shape)
    rows = s.global_batch // SIZES["data"]
    mesh = RecordingMesh((16, 16), ("data", "model"))
    if shape == "train_4k":
        tc = TrainConfig()
        state = abstract_state(cfg, tc, max_pos=max_pos_for(s))
        state["step"] = torch.tensor(0, dtype=torch.int32)
        specs = tree_specs(state, MeshRules(axis_sizes=SIZES))
        n = s.global_batch
        batch = {"tokens": _meta((n, s.seq_len)),
                 "targets": _meta((n, s.seq_len)),
                 "weights": _meta((n, s.seq_len), torch.float32)}
        step = make_train_step(cfg, tc, moe_groups=SIZES["data"],
                               tp="model", param_specs=specs["params"],
                               mesh=mesh)
        assert step.placement.tp == ("model",)
        flops = _period_flops(step, shard_tree(state, specs, mesh), batch)
    else:
        params = place_params(init_model(None, cfg, device=META,
                                         max_pos=max_pos_for(s)), cfg, mesh)
        assert params["embed"]["tok"].shape[-1] == cfg.d_model // 16
        if shape == "prefill_32k":
            flops = _period_flops(make_prefill_step(cfg, mesh=mesh), params,
                                  {"tokens": _meta((rows, s.seq_len))})
        else:
            cache = place_cache(init_cache(cfg, rows, s.seq_len,
                                           device=META), cfg, mesh)
            assert cache[0]["mixer"]["k"].shape[-1] == \
                cfg.resolved_head_dim // 16
            flops = _period_flops(make_decode_step(cfg, mesh=mesh), params, {
                "tokens": _meta((rows, 1)), "cache": cache,
                "pos": s.seq_len - 1})
    assert one["hlo"]["flops"] == flops


def _splits(spec) -> bool:
    axes = [a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    return any(SIZES[a] > 1 for a in axes)


def _block(leaf, spec):
    n = leaf.numel()
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n //= SIZES[a]
    return n


def _gather_call(pairs, gathers, cspecs=None):
    """(payload bytes, all-reduces) of one gather call and its backward
    over (leaf, storage spec) ``pairs``, gathered to ``cspecs`` (the
    compute specs; None: whole): the leaves whose layout changes in one
    byte buffer per gather (each leaf's offset aligned), and every leaf's
    gradient, in its compute block, in f32."""
    cspecs = cspecs or [()] * len(pairs)
    moved = [(leaf, cs) for (leaf, sp), cs in zip(pairs, cspecs)
             if _splits(sp) and tuple(sp) != tuple(cs)]
    buf = sum(-(-_block(leaf, cs) * leaf.element_size() // ALIGN) * ALIGN
              for leaf, cs in moved)
    grads = 4 * sum(_block(leaf, cs) for (leaf, _), cs in zip(pairs, cspecs))
    return gathers * buf + grads, (gathers if moved else 0) + 1


def _tp_collectives(cfg, tokens):
    """(payload bytes, all-reduces) over "model" of the TP train step of
    qwen2-0.5b (tied, QKV bias; H = 14 over model = 16: the query gathered
    to gcd(14, 16) = 2 head groups, K/V whole) with remat, bf16
    activations. Per layer: the query's gather and ``wo``'s reduce in the
    forward and again in the recomputation, the MLP's reduce once (the
    recomputation stops at the last activation the backward needs); in
    the backward the MLP's and the attention's ``copy_to_tp``, the
    attention output's gather, K's and V's group copies and ``bq``'s
    gather. Once: the embedding's gather, the tied unembedding's weight
    gather and logit-gradient gather, the loss's max (gathered, f32), sum
    of exponentials and gold logit, the norm's split sum."""
    n, d, v = 16, cfg.d_model, cfg.vocab_size
    qd = cfg.n_heads * cfg.resolved_head_dim
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    per_layer = [tokens * qd * 2] * 2 + [tokens * d * 2] * 2 \
        + [tokens * d * 2] + [tokens * d * 2, tokens * qd * 2,
                              tokens * d * 2, tokens * kvd * 2,
                              tokens * kvd * 2, qd * 2]
    once = [tokens * d * 2, v * d * 2, tokens * v * 2, tokens * n * 4,
            tokens * 4, tokens * 4, 4]
    return (sum(per_layer) * cfg.n_layers + sum(once),
            len(per_layer) * cfg.n_layers + len(once))


@pytest.mark.parametrize("layout", ["baseline", "dp_all"])
def test_collective_bytes_equal_the_spec_count(records, layout):
    cfg, tc = get_config(QWEN), TrainConfig()
    rules = (MeshRules(axis_sizes=SIZES) if layout == "baseline" else
             MeshRules(axis_sizes=SIZES, tp_axes=(),
                       fsdp_axes=("data", "model"),
                       dp_axes=("data", "model")))
    params = abstract_state(cfg, tc, max_pos=max_pos_for(
        get_shape("train_4k")))["params"]
    specs = tree_specs(params, rules)
    # the gather's targets: the compute specs in the baseline (TP over
    # model), whole leaves in dp_all
    cspecs = (tree_specs(params, compute_rules(SIZES))
              if layout == "baseline" else None)

    def targets(key):
        return ([cs for _, cs in _zip_specs(params[key], cspecs[key])]
                if cspecs else None)

    payload, count = 2 * 4, 2            # the weight sum and the loss
    for key in ("embed", "norm_f"):      # gathered once, outside remat
        p, c = _gather_call(list(_zip_specs(params[key], specs[key])), 1,
                            targets(key))
        payload, count = payload + p, count + c
    gathers = 2 if tc.remat_policy != "none" else 1   # forward, recompute
    for pos, (blk, sp) in enumerate(zip(params["blocks"], specs["blocks"])):
        pairs = list(_zip_specs(blk, sp))
        cs = ([c[1:] for _, c in _zip_specs(blk, cspecs["blocks"][pos])]
              if cspecs else None)
        for i in range(cfg.n_periods):       # each period's layer slice
            p, c = _gather_call([(leaf[i], spec[1:]) for leaf, spec in pairs],
                                gathers, cs)
            payload, count = payload + p, count + c
    if layout == "baseline":
        s = get_shape("train_4k")
        p, c = _tp_collectives(cfg, s.global_batch // SIZES["data"]
                               * s.seq_len)
        payload, count = payload + p, count + c
    coll = records[f"{QWEN}|train_4k|{layout}"]["collectives"]
    assert coll["all-reduce"] == 2 * payload
    assert coll["count"] == count
    assert all(coll[k] == 0 for k in ("all-gather", "reduce-scatter",
                                      "all-to-all", "collective-permute"))


def _placed(mesh, cfg):
    """A reduced placed step (remat, 2 agents) on ``mesh``: its
    collectives as ``OpCounter`` records them."""
    from repro_torch.launch.train import place_state
    tc = TrainConfig(optimizer="sgdm", lr=1e-2)
    if mesh.device.type == "meta":
        state = abstract_state(cfg, tc, max_pos=17)
        batch = {"tokens": _meta((4, 16)), "targets": _meta((4, 16)),
                 "weights": _meta((4, 16), torch.float32)}
    else:
        from repro_torch.launch.train import init_state
        state = init_state(torch.Generator().manual_seed(0), cfg, tc,
                           max_pos=17, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 17)).astype(np.int32))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "weights": torch.ones(4, 16)}
    state, specs = place_state(state, mesh)
    step = make_train_step(cfg, tc, moe_groups=2, dp="data", tp="model",
                           param_specs=specs["params"], sizes=mesh.shape,
                           mesh=mesh)
    with OpCounter() as cnt:
        step(state, batch)
    return cnt.table()


def _placed_rank(rank, world):
    from repro_torch.launch.mesh import make_test_mesh
    cfg = dataclasses.replace(get_config(QWEN).reduced(), n_layers=2)
    return _placed(make_test_mesh(data=world, model=1, device="cpu"), cfg)


def test_real_mesh_reports_what_the_recording_mesh_does(tmp_path):
    from repro_torch.launch.mesh import RecordingMesh, run_ranks
    cfg = dataclasses.replace(get_config(QWEN).reduced(), n_layers=2)
    dry = _placed(RecordingMesh((2, 1), ("data", "model")), cfg)
    real = run_ranks(_placed_rank, 2, backend="gloo", device="cpu",
                     timeout=120, threads=1, store_dir=str(tmp_path))
    # the weight sum and the loss; the embedding's gather and gradient;
    # norm_f's gradient (nothing of it splits); per layer two gathers
    # (forward, recomputation) and the gradient
    assert analyze(dry)["collective_count"] == 2 + 2 + 1 + 2 * 3
    for table in real:
        assert table["collectives"] == dry["collectives"]
        assert analyze(table)["flops"] == analyze(dry)["flops"]
    # rank 1's blocks are rank 0's size: the same record
    assert _placed(RecordingMesh((2, 1), ("data", "model"), rank=1),
                   cfg)["collectives"] == dry["collectives"]


REFERENCE_KEYS = {"arch", "shape", "mesh", "mode", "tag", "layout",
                  "cfg_patch", "kind", "n_agents", "chips", "cost",
                  "memory", "hlo", "collectives", "ok"}


def test_cli_writes_both_meshes_and_reanalyze_keeps_hlo(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", QWEN,
         "--shape", "decode_32k", "--mesh", "both", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[OK ]") == 2, out.stdout
    recs = {}
    for mesh, chips in (("single", 256), ("multi", 512)):
        path = tmp_path / f"{QWEN}__decode_32k__{mesh}.json"
        rec = json.loads(path.read_text())
        assert REFERENCE_KEYS <= set(rec) and rec["ok"]
        assert rec["chips"] == chips and rec["trace_s"] >= 0
        assert (tmp_path / f"{QWEN}__decode_32k__{mesh}.ops.json").exists()
        recs[mesh] = rec
    assert recs["multi"]["n_agents"] == 32 and recs["multi"]["dp"] == \
        ["pod", "data"]
    for rec in recs.values():            # corrupt, then rebuild from tables
        path = tmp_path / f"{QWEN}__decode_32k__{rec['mesh']}.json"
        path.write_text(json.dumps({**rec, "hlo": {}}))
    D.reanalyze(str(tmp_path))
    for mesh, rec in recs.items():
        again = json.loads((tmp_path / f"{QWEN}__decode_32k__{mesh}.json")
                           .read_text())
        assert again["hlo"] == rec["hlo"]

    # --layout, --period and --reference: a reference record of the same
    # cell name (tag "period")
    ref_dir, out_dir = tmp_path / "ref", tmp_path / "dp_all"
    ref_dir.mkdir()
    (ref_dir / f"{QWEN}__decode_32k__single__period.json").write_text(
        json.dumps({"ok": True, "hlo": {"flops": 1e10}}))
    D.main(["--arch", QWEN, "--shape", "decode_32k", "--layout", "dp_all",
            "--period", "--reference", str(ref_dir), "--out", str(out_dir)])
    rec = json.loads((out_dir / f"{QWEN}__decode_32k__single__period.json")
                     .read_text())
    assert rec["layout"] == "dp_all" and rec["uneven"]
    assert rec["cfg_patch"] == {"n_layers": 1} and rec["tag"] == "period"
    assert rec["n_agents"] == 256 and rec["dp"] == ["data"]
    assert rec["reference_flops"] == 1e10
    assert rec["flops_ratio"] == rec["hlo"]["flops"] / 1e10


@pytest.mark.parametrize("name", sorted(n for n in list_configs()
                                        if n != "paper-lenet"))
def test_decode_step_runs_on_meta(name):
    """A scalar position, given as an int or a host tensor, is read on the
    host: every family's decode step runs on meta tensors."""
    cfg = get_config(name).reduced()
    params = init_model(None, cfg, device=META, max_pos=64)
    for pos in (5, torch.tensor(5, dtype=torch.int32)):
        tok, cache = make_decode_step(cfg)(params, {
            "tokens": _meta((2, 1)),
            "cache": init_cache(cfg, 2, 32, device=META), "pos": pos})
        assert tok.shape == (2,) and tok.device == META
        assert tok.dtype == torch.int32


def _old_rope_cos_sin(positions, head_dim, theta, mrope_sections):
    """The M-RoPE form before ``output_size`` (the host read of the
    sections' sum from the device)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    sec = torch.repeat_interleave(
        torch.arange(len(mrope_sections), device=positions.device),
        torch.as_tensor(mrope_sections, device=positions.device))
    half = head_dim // 2
    sec = torch.cat([sec, sec[-1:].expand(max(half - sec.numel(), 0))]
                    )[:half]
    freqs = positions.to(torch.float32)[sec].permute(1, 2, 0) * inv
    return torch.cos(freqs)[:, :, None, :], torch.sin(freqs)[:, :, None, :]


@pytest.mark.parametrize("sections", ["config", (4, 2), (64, 64)])
def test_mrope_sections_bit_identical_to_old_form(sections):
    cfg = get_config("qwen2-vl-2b")
    secs = cfg.mrope_sections if sections == "config" else sections
    hd = cfg.resolved_head_dim
    pos = torch.from_numpy(np.random.default_rng(0).integers(
        0, 40_000, (3, 2, 9)).astype(np.int32))
    new = rope_cos_sin(pos, hd, cfg.rope_theta, secs)
    old = _old_rope_cos_sin(pos, hd, cfg.rope_theta, secs)
    for a, b in zip(new, old):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    meta = rope_cos_sin(pos.to(META), hd, cfg.rope_theta, secs)
    assert [t.shape for t in meta] == [t.shape for t in new]
    assert math.prod(new[0].shape) == 2 * 9 * hd // 2
