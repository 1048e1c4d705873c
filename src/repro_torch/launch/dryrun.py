"""Dry run: one rank's step of every (arch x shape) cell on the production
meshes, on the meta device, with its FLOPs, HBM bytes, collectives and
memory (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled HLO. The port's program is what it
dispatches, so here one rank's step runs on ``meta`` tensors (shapes
only: nothing is allocated and no card is needed) over a
``launch.mesh.RecordingMesh`` of rank 0, under
``launch.hlo_analysis.OpCounter``. What each kind runs, per rank:

- train, ``mode="masked"``: the placed (FSDP) step,
  ``make_train_step(..., param_specs=, mesh=)``, on this rank's blocks
  of the state (``shard_tree`` under the layout's storage rules) and the
  global batch it slices itself. Each period's blocks are gathered to
  the compute layout (``dist.sharding.compute_rules``, the reference's
  ``param_cspecs``): every registered family, the attention decoders
  (GQA or MLA), the Mamba hybrid (jamba), RWKV-6 and whisper's
  encoder-decoder, dense or MoE (``dist.tp.tp_compute``), computes
  tensor-parallel over "model" (``dist.tp``; an MoE block's experts over
  the ep axes, the layouts' tp axes); a layout without tp axes
  (``dp_all``) gathers whole leaves and computes whole on every rank.
- train, the general modes (cge, stale, trimmed, quantized):
  ``make_general_step`` on ``place_general_state``'s share of the state,
  the reference's general layout: parameters and moments in the compute
  layout (TP blocks over "model", replicated over dp; whole without tp
  axes), this agent's ledger and error rows whole, the global batch it
  slices itself and a host ``fresh_mask`` of ones (the reference's
  ``(n_agents,)`` f32 argument).
- prefill and decode: ``launch.serve``'s steps on this rank's dp block
  of the batch and cache. Each family runs tensor-parallel on the
  compute layout (``place_params``) and a cache with ``cache_specs``' tp
  entries (head_dim, whisper's cross-attention ``ck`` / ``cv`` too,
  MLA's latent and rope-key columns, Mamba's state over d_state and conv
  rows over di, RWKV's state over its value columns and token-shift rows
  over d, over "model", ``place_cache``), as the reference's cells place
  them; without tp axes, whole parameters and the cache's dp entries
  only.

MoE dispatch groups keep the reference's size: the reference runs
``n_agents`` groups over the global batch, so a rank's block of it runs
``n_agents`` over the number of ranks the batch splits over (one where
the reference itself falls back to one group). Where the batch does not
split over every dp axis (a batch smaller than the dp ranks), the ranks
along the rest hold the same block and compute it again, the reference's
replication; the record says ``uneven: true`` and names the axes it
splits over.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k --mesh both [--layout dp_all] [--period] \\
        [--reference DIR]

``--reference DIR`` reads the reference's records of the same cells
(``scripts/reference_dryrun.py --out DIR``, the same ``--tag`` and
``--mode``), and each record states its FLOPs against them
(``flops_ratio``). ``--mode cge`` (stale, trimmed, quantized) builds the
train cells on the general step, and the record's tag names the mode.

Records land in ``results/dryrun/<arch>__<shape>__<mesh>[__tag].json``
under the repository root, each beside its per-op table
(``<name>.ops.json``), from which :func:`reanalyze` recomputes ``hlo``.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, get_shape
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.core.ledger import tree_flatten
from repro_torch.dist.sharding import (MeshRules, _split_axes, batch_specs,
                                       bytes_per_rank, cache_specs,
                                       shard_tree, tree_specs)
from repro_torch.dist.tp import tp_compute
from repro_torch.launch import serve as V
from repro_torch.launch import train as T
from repro_torch.launch.hlo_analysis import OpCounter, analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, max_pos_for
from repro_torch.models.model import init_model

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results" / "dryrun")

GENERAL_MODES = ("cge", "stale", "trimmed", "quantized")

# named layout experiments, the reference's
LAYOUTS = {
    "baseline": {},
    # full data-parallel: no TP; "model" becomes a second DP/ZeRO axis
    "dp_all": {"tp_axes": (), "fsdp_axes": ("data", "model"),
               "dp_axes_single": ("data", "model"),
               "dp_axes_multi": ("pod", "data", "model")},
}

COMPUTE = {
    "train": "placed (FSDP) storage, parameters gathered whole per period",
    "prefill": "whole parameters, this rank's dp block of the batch",
    "decode": "whole parameters, this rank's dp block of the batch and "
              "cache",
}
COMPUTE_TP = {
    "train": "placed (FSDP) storage, each period gathered to the compute "
             "layout, tensor-parallel over model",
    "prefill": "compute-layout parameters, tensor-parallel over model, "
               "this rank's dp block of the batch",
    "decode": "compute-layout parameters, tensor-parallel over model, "
              "this rank's dp block of the batch and the cache's head_dim "
              "block",
}

COMPUTE_GENERAL = {
    False: "general step: whole parameters on every rank, one agent per "
           "dp rank",
    True: "general step: compute-layout parameters, tensor-parallel over "
          "model, one agent per dp rank",
}


def _apply_cfg_patch(cfg, patch):
    if not patch:
        return cfg
    sub: Dict[str, Dict[str, Any]] = {}
    top: Dict[str, Any] = {}
    for k, v in patch.items():
        if "." in k:
            o, f = k.split(".", 1)
            sub.setdefault(o, {})[f] = v
        else:
            top[k] = v
    for o, fields in sub.items():
        top[o] = dataclasses.replace(getattr(cfg, o), **fields)
    return dataclasses.replace(cfg, **top)


@dataclasses.dataclass
class Cell:
    """One rank's step and its inputs: ``step(*args)``; the bytes of this
    rank's inputs (``args`` may hold the global batch the step slices)."""
    step: Callable
    args: tuple
    argument_bytes: int


def _host_scalar(value: int = 0) -> torch.Tensor:
    # a step or position the host reads, as the reference's abstract
    # scalar is only a shape
    return torch.tensor(value, dtype=torch.int32)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def block_groups(n_agents: int, n_split: int, global_tokens: int) -> int:
    """MoE dispatch groups on one rank's block of the batch: the
    reference's ``n_agents`` groups over the global batch, of which the
    block holds ``n_agents / n_split``; one where the reference falls
    back to one group (its tokens do not split into ``n_agents``)."""
    if global_tokens % n_agents:
        return 1
    return max(n_agents // n_split, 1)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               mode: str = "masked", overrides=None, tc_kw=None,
               cfg_patch=None, layout: str = "baseline"
               ) -> Tuple[Cell, Dict[str, Any]]:
    """(cell, meta) for one dry-run cell: every tensor on the meta device
    but the host step or position scalar."""
    cfg = _apply_cfg_patch(get_config(arch), cfg_patch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, record=True)
    sizes = dict(mesh.shape)
    lay = LAYOUTS[layout]
    tp_axes = lay.get("tp_axes", ("model",))
    rules = MeshRules(
        axis_sizes=sizes, multi_pod=multi_pod, overrides=overrides or {},
        fsdp_axes=lay.get("fsdp_axes", ("data",)), tp_axes=tp_axes,
        ep_axes=lay.get("ep_axes", tp_axes),
        dp_axes=lay.get("dp_axes_multi" if multi_pod else "dp_axes_single"))
    n_ag = math.prod(sizes[a] for a in rules.dp)
    tc = T.TrainConfig(mode=mode, **(tc_kw or {}))
    kind = shape.kind
    tp = tp_axes[0] if tp_axes else None
    meta = dict(arch=arch, shape=shape_name,
                mesh="multi" if multi_pod else "single", kind=kind,
                n_agents=n_ag, mode=mode, chips=mesh.size)

    batch = input_specs(cfg, shape, n_ag, kind)
    lead = batch_specs(rules, {"tokens": batch["tokens"]})["tokens"][0]
    split = _split_axes(lead, mesh)
    n_split = math.prod(sizes[a] for a in split)
    tensor_parallel = bool(tp_axes) and tp_compute(cfg) and \
        mesh.axis_size(tp_axes) > 1
    meta.update(dp=list(split),
                uneven=set(split) != set(_split_axes(rules.dp, mesh)),
                compute=(COMPUTE_TP if tensor_parallel else COMPUTE)[kind])

    if kind == "train" and mode in GENERAL_MODES:
        meta["compute"] = COMPUTE_GENERAL[tensor_parallel]
        state = T.init_state(None, cfg, tc, max_pos=max_pos_for(shape),
                             n_agents=n_ag, device="meta", mesh=mesh)
        state["step"] = _host_scalar()
        local = T.place_general_state(state, mesh, cfg)
        fresh = np.ones(n_ag, np.float32)
        step = T.make_general_step(cfg, tc, mesh, moe_groups=n_ag)
        arg_bytes = (_tree_bytes(local) + fresh.nbytes
                     + bytes_per_rank(batch, batch_specs(rules, batch),
                                      sizes))
        return Cell(step, (local, batch, fresh), arg_bytes), meta
    if kind == "train":
        state = T.abstract_state(cfg, tc, max_pos=max_pos_for(shape))
        state["step"] = _host_scalar()
        specs = tree_specs(state, rules)
        local = shard_tree(state, specs, mesh)
        step = T.make_train_step(cfg, tc, moe_groups=n_ag, dp=split, tp=tp,
                                 param_specs=specs["params"], sizes=sizes,
                                 mesh=mesh)
        arg_bytes = (bytes_per_rank(state, specs, sizes)
                     + bytes_per_rank(batch, batch_specs(rules, batch),
                                      sizes))
        return Cell(step, (local, batch), arg_bytes), meta

    params = init_model(None, cfg, device="meta", max_pos=max_pos_for(shape))
    groups = block_groups(n_ag, n_split,
                          shape.global_batch * batch["tokens"].shape[1])
    step_mesh = mesh if tensor_parallel else None
    if tensor_parallel:
        params = V.place_params(params, cfg, mesh)
    if kind == "prefill":
        local = shard_tree(batch, batch_specs(rules, batch), mesh)
        step = V.make_prefill_step(cfg, moe_groups=groups, dp=split, tp=tp,
                                   sizes=sizes, mesh=step_mesh)
    else:
        local = {"tokens": shard_tree(batch["tokens"],
                                      batch_specs(rules, batch["tokens"]),
                                      mesh),
                 # the cache's dp entries, and its tp entries where the
                 # step is tensor-parallel
                 "cache": (V.place_cache(batch["cache"], cfg, mesh,
                                         dp=rules.dp) if tensor_parallel
                           else shard_tree(batch["cache"], cache_specs(
                               MeshRules(axis_sizes=sizes, tp_axes=(),
                                         dp_axes=rules.dp), batch["cache"]),
                               mesh)),
                 "pos": _host_scalar(shape.seq_len - 1)}
        step = V.make_decode_step(cfg, moe_groups=groups, dp=split, tp=tp,
                                  sizes=sizes, mesh=step_mesh)
    meta["moe_groups"] = groups
    return (Cell(step, (params, local), _tree_bytes((params, local))),
            meta)


def _name(arch, shape_name, mesh, tag) -> str:
    return f"{arch}__{shape_name}__{mesh}" + (f"__{tag}" if tag else "")


def run_cell(arch, shape_name, multi_pod, mode="masked", overrides=None,
             tc_kw=None, out_dir=RESULTS_DIR, tag="", cfg_patch=None,
             layout="baseline", reference: Optional[dict] = None):
    """Trace one cell, write its record and per-op table to ``out_dir``
    and return the record. ``reference``: the reference's record of the
    same cell, whose FLOPs the record states its own against."""
    t0 = time.time()
    rec: Dict[str, Any] = dict(
        arch=arch, shape=shape_name, mesh="multi" if multi_pod else "single",
        mode=mode, tag=tag, layout=layout, cfg_patch=cfg_patch)
    name = _name(arch, shape_name, rec["mesh"], tag)
    os.makedirs(out_dir, exist_ok=True)
    try:
        cell, meta = build_cell(arch, shape_name, multi_pod, mode, overrides,
                                tc_kw, cfg_patch, layout)
        rec.update(meta)
        with OpCounter() as counter:
            out = cell.step(*cell.args)
        table = counter.table()
        hlo = analyze(table)
        rec["cost"] = {"flops": hlo["flops"],
                       "bytes accessed": hlo["hbm_bytes"]}
        rec["memory"] = {"argument_size_in_bytes": cell.argument_bytes,
                         "output_size_in_bytes": _tree_bytes(out),
                         "temp_size_in_bytes": counter.peak_temp_bytes}
        rec["hlo"] = hlo
        rec["collectives"] = {**hlo["collectives"],
                              "count": int(hlo["collective_count"])}
        if reference is not None:
            ref = reference["hlo"]["flops"]
            rec["reference_flops"] = ref
            rec["flops_ratio"] = hlo["flops"] / ref
        with open(os.path.join(out_dir, name + ".ops.json"), "w") as f:
            json.dump(table, f, indent=1)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def live_cells():
    """The 32 live (arch x shape) cells (long_500k only for sub-quadratic
    archs)."""
    cells = []
    for arch in list_configs():
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells


def _reference_record(ref_dir, arch, shape, mesh, tag):
    path = os.path.join(ref_dir, _name(arch, shape, mesh, tag) + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return rec if rec.get("ok") else None


def record_tag(tag: Optional[str], period: bool, mode: str) -> str:
    """A record's tag: ``tag`` (``period`` for one period of depth where
    none is given), and a general mode's name after it, as
    ``scripts/reference_dryrun.py`` names the reference's records."""
    base = tag if tag is not None else ("period" if period else "")
    return "_".join(t for t in (base, "" if mode == "masked" else mode)
                    if t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="masked",
                    choices=("masked",) + GENERAL_MODES,
                    help="the train cells' step; a general mode's records "
                         "carry it in their tag")
    ap.add_argument("--layout", default="baseline", choices=sorted(LAYOUTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--period", action="store_true",
                    help="one period of the layer pattern in depth (tag "
                         "'period' unless --tag says otherwise)")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--reference", default="",
                    help="a directory of the reference's dry-run records "
                         "(scripts/reference_dryrun.py --out DIR): each "
                         "record states its FLOPs against the same cell's")
    args = ap.parse_args(argv)

    cells = live_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    tag = record_tag(args.tag, args.period, args.mode)
    for arch, shape in cells:
        patch = ({"n_layers": get_config(arch).period} if args.period
                 else None)
        for mesh in meshes:
            ref = (_reference_record(args.reference, arch, shape, mesh, tag)
                   if args.reference else None)
            rec = run_cell(arch, shape, mesh == "multi", args.mode,
                           out_dir=args.out, tag=tag, cfg_patch=patch,
                           layout=args.layout, reference=ref)
            status = "OK " if rec.get("ok") else "FAIL"
            print(f"[{status}] {arch:18s} {shape:12s} {mesh:6s} "
                  f"trace={rec.get('trace_s', '-')}s "
                  f"flops={rec.get('cost', {}).get('flops', '-')} "
                  f"coll={rec.get('collectives', {}).get('count', '-')}"
                  + (f" x{rec['flops_ratio']:.3f} of the reference"
                     if "flops_ratio" in rec else "")
                  + ("" if rec.get("ok") else f"  {rec.get('error')}"),
                  flush=True)


def reanalyze(results_dir=RESULTS_DIR):
    """Recompute ``hlo`` of every saved record from its ``.ops.json``
    table (no step runs again)."""
    for tp in sorted(glob.glob(os.path.join(results_dir, "*.ops.json"))):
        jp = tp[:-len(".ops.json")] + ".json"
        if not os.path.exists(jp):
            continue
        with open(tp) as f:
            table = json.load(f)
        with open(jp) as f:
            rec = json.load(f)
        rec["hlo"] = analyze(table)
        with open(jp, "w") as f:
            json.dump(rec, f, indent=1)
        print("reanalyzed", os.path.basename(jp), flush=True)


if __name__ == "__main__":
    main()
