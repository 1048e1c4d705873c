"""The placed train step's dry-run cell with microbatch accumulation
(``TrainConfig.accum_steps = 2``), held rank by rank against the
reference's, at full width on the production mesh (16 x 16, one pod),
baseline layout, one layer: qwen2-0.5b train_4k (dense) and arctic-480b
train_4k (MoE, expert-parallel over "model").

The reference's compiled program (``repro.launch.dryrun.run_cell`` with
``scripts/reference_dryrun.py``'s ``auto_mesh``, one subprocess for both
cells) scans its k microbatches in one ``while`` of k trips. Every FSDP
all-gather of the parameters over "data" lies outside that loop, before
it; the loop body holds one all-reduce over "data" of the microbatch's
gradient blocks, a tuple of them. The port follows that: the parameters
are gathered once (one all-reduce of bytes over "data") and each
microbatch's gradient is reduced over "data" in one all-reduce of its f32
compute blocks. Its collectives over "model" are those of the
one-microbatch step on a batch of B/k rows, k times over; its gradient
norm is one scalar all-reduce over the whole mesh.

Against the reference, each cell's FLOPs a rank lie within [0.90, 1.10]
of the reference's and within 1% of the port's own k = 1 cell's, and its
argument bytes are exactly the reference's. qwen2-0.5b's temporaries are
at most 0.6 of its k = 1 cell's (the reference's fall to 0.503 of
theirs). arctic-480b's dry-run peak of both cells is set by the first
step's layout check, whose whole-leaf meta tensors (three f32 expert
stacks of 17.85 GB) the counter tracks at every k, so its temporaries are
not compared.
"""
import collections
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import zstandard

from repro_torch.configs.base import get_shape
from repro_torch.configs.registry import get_config
from repro_torch.dist.sharding import (ALIGN, MeshRules, _spec_axes,
                                       _zip_specs, block_shape,
                                       compute_rules, tree_specs)
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.specs import max_pos_for
from repro_torch.launch.train import TrainConfig, abstract_state

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-0.5b", "arctic-480b")
K = 2
PATCH = {"n_layers": 1}
SIZES = {"data": 16, "model": 16}
TEMP_SHARE = 0.6
TIMEOUT = 600

REFERENCE = """
import sys
sys.path.insert(0, {scripts!r})
import reference_dryrun as R
import repro.launch.dryrun as D
D.make_production_mesh = R.auto_mesh
for arch in {archs!r}:
    rec = D.run_cell(arch, "train_4k", False, tc_kw={{"accum_steps": {k}}},
                     cfg_patch={patch!r}, out_dir={out!r}, tag="accum")
    assert rec["ok"], rec.get("error")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{arch: (the reference's record of the accumulating cell, its HLO
    text)}, from one subprocess started before the port's cells run."""
    out = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            scripts=str(ROOT / "scripts"), archs=ARCHS, k=K, patch=PATCH,
            out=str(out))],
        capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    recs = {}
    for arch in ARCHS:
        name = f"{arch}__train_4k__single__accum"
        hlo = zstandard.ZstdDecompressor().decompress(
            (out / f"{name}.hlo.zst").read_bytes()).decode()
        recs[arch] = (json.loads((out / f"{name}.json").read_text()), hlo)
    return recs


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{arch: {k: (record, its collectives)}} for k = 1 and K, and under
    "micro" the k = 1 step's collectives on the first B/K rows."""
    out = tmp_path_factory.mktemp("port")
    recs = {}
    for arch in ARCHS:
        recs[arch] = {}
        for k in (1, K):
            tag = f"k{k}"
            rec = D.run_cell(arch, "train_4k", False, out_dir=str(out),
                             tag=tag, cfg_patch=PATCH,
                             tc_kw={"accum_steps": k})
            assert rec["ok"], rec.get("traceback")
            table = json.loads((out / f"{arch}__train_4k__single__{tag}"
                                      ".ops.json").read_text())
            recs[arch][k] = (rec, table["collectives"])
        cell, _ = D.build_cell(arch, "train_4k", False, cfg_patch=PATCH)
        state, batch = cell.args
        micro = {key: x[:x.shape[0] // K] for key, x in batch.items()}
        with OpCounter() as cnt:
            cell.step(state, micro)
        recs[arch]["micro"] = cnt.table()["collectives"]
    return recs


def _over(colls, axes):
    """{payload bytes: count} of the all-reduces over exactly ``axes``."""
    out = collections.Counter()
    for c in colls:
        if tuple(c["axes"]) == axes:
            out[c["bytes"]] += c["count"]
    return out


def _payloads(arch):
    """(bytes of the one gather: every leaf whose storage block is not its
    compute block, each aligned in the byte buffer; bytes of one
    microbatch's gradient: every leaf's compute block in f32)."""
    cfg = dataclasses.replace(get_config(arch), **PATCH)
    params = abstract_state(cfg, TrainConfig(), max_pos=max_pos_for(
        get_shape("train_4k")))["params"]
    mesh = RecordingMesh((16, 16), ("data", "model"))
    specs = tree_specs(params, MeshRules(axis_sizes=SIZES))
    cspecs = tree_specs(params, compute_rules(SIZES))
    gather = grads = 0
    for (leaf, sp), (_, cs) in zip(_zip_specs(params, specs),
                                   _zip_specs(params, cspecs)):
        n = math.prod(block_shape(cs, leaf.shape, mesh))
        grads += 4 * n
        if _spec_axes(sp, mesh) != _spec_axes(cs, mesh):
            gather += -(-n * leaf.element_size() // ALIGN) * ALIGN
    return gather, grads


def _compute_blocks(arch):
    """The shapes of one rank's compute blocks of ``arch``'s parameters."""
    cfg = dataclasses.replace(get_config(arch), **PATCH)
    params = abstract_state(cfg, TrainConfig(), max_pos=max_pos_for(
        get_shape("train_4k")))["params"]
    mesh = RecordingMesh((16, 16), ("data", "model"))
    return {block_shape(cs, leaf.shape, mesh) for leaf, cs in _zip_specs(
        params, tree_specs(params, compute_rules(SIZES)))}


def _loop_collectives(hlo, blocks):
    """(the outer microbatch loop's trip count, Counter of (what, inside
    the loop) of the reference's HLO's collectives), what being "gather"
    for an all-gather over "data" of a parameter (its result one of the
    compute-block shapes ``blocks``) and "reduce" for an all-reduce over
    "data"."""
    comps, entry, cur = {}, None, None
    for line in hlo.splitlines():
        m = re.match(r"^(ENTRY )?%(\S+) .*\{$", line)
        if m:
            cur = m.group(2)
            comps[cur] = []
            entry = cur if m.group(1) else entry
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line)
    calls = {c: set(re.findall(r"(?:body|condition|calls|to_apply)="
                               r"%([\w.\-]+)", "\n".join(ls)))
             for c, ls in comps.items()}
    (loop,) = [l for l in comps[entry]
               if " while(" in l and 'op_name="jit(step)/while"' in l]
    trips = int(re.search(r'"known_trip_count":\{"n":"(\d+)"',
                          loop).group(1))
    inside, todo = set(), [re.search(r"body=%([\w.\-]+)", loop).group(1)]
    while todo:
        c = todo.pop()
        if c not in inside:
            inside.add(c)
            todo.extend(calls.get(c, ()))
    out = collections.Counter()
    for c, lines in comps.items():
        for l in lines:
            op = re.search(r"= (.*?) (all-gather|all-reduce)\(", l)
            if not op:
                continue
            groups = re.search(r"replica_groups=(\S+)", l).group(1)
            if not (groups.startswith("{{0,16,")
                    or groups.startswith("[16,16]<=[16,16]T(1,0)")):
                continue                                # not over data
            dims = re.fullmatch(r"\w+\[([\d,]*)\]\S*", op.group(1))
            if op.group(2) == "all-reduce":
                out["reduce", c in inside] += 1
            elif dims and tuple(int(d) for d in dims.group(1).split(",")
                                if d) in blocks:
                out["gather", c in inside] += 1
    return trips, out


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_gathers_before_its_loop_and_reduces_in_it(reference,
                                                             arch):
    """The HLO reading the port follows."""
    trips, colls = _loop_collectives(reference[arch][1],
                                     _compute_blocks(arch))
    assert trips == K
    # the FSDP gathers of the parameters: all before the loop
    assert colls["gather", True] == 0 and colls["gather", False] > 0
    # in the loop, over data: the gradient tuple's all-reduce and the
    # loss's
    assert colls["reduce", True] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_accum_cell_flops_and_argument_bytes(reference, port, arch):
    ref, _ = reference[arch]
    one, acc = port[arch][1][0], port[arch][K][0]
    ratio = acc["hlo"]["flops"] / ref["hlo"]["flops"]
    print(f"{arch} accum_steps={K}: FLOPs {acc['hlo']['flops']:.6e} a rank,"
          f" {ratio:.4f} of the reference's {ref['hlo']['flops']:.6e}, "
          f"{acc['hlo']['flops'] / one['hlo']['flops']:.6f} of k = 1's")
    assert 0.90 <= ratio <= 1.10
    assert acc["hlo"]["flops"] == pytest.approx(one["hlo"]["flops"],
                                                rel=0.01)
    assert acc["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_accum_cell_collectives_follow_the_reference_loop(port, arch):
    (one, one_c), (acc, acc_c) = port[arch][1], port[arch][K]
    gather, grads = _payloads(arch)
    # over data: each microbatch's weight sum and loss, the one gather,
    # each microbatch's gradient
    assert _over(acc_c, ("data",)) == collections.Counter(
        {4: 2 * K, gather: 1, grads: K})
    # the norm: one scalar over the whole mesh (at k = 1, the split
    # leaves' sum over model)
    assert _over(acc_c, ("data", "model")) == {4: 1}
    assert _over(one_c, ("model",))[4] == 1
    micro = _over(port[arch]["micro"], ("model",))
    micro[4] -= 1
    assert _over(acc_c, ("model",)) == collections.Counter(
        {b: K * n for b, n in micro.items() if n})
    assert acc["collectives"]["count"] == \
        2 * K + 1 + K + 1 + K * sum(micro.values())
    # at k = 1 remat gathers each period again in its recomputation; the
    # accumulating step gathers once
    gathered_one = sum(b * n for b, n in _over(one_c, ("data",)).items()
                       if b != 4) - grads
    assert gathered_one > gather
    print(f"{arch} accum_steps={K}: {acc['collectives']['count']} "
          f"all-reduces, {acc['collectives']['all-reduce']:.6e} wire bytes "
          f"a rank (k = 1: {one['collectives']['count']}, "
          f"{one['collectives']['all-reduce']:.6e}); gather {gather} B once,"
          f" gradient {grads} B a microbatch")


def test_accum_cell_temporaries_fall(reference, port):
    arch = "qwen2-0.5b"
    one, acc = port[arch][1][0], port[arch][K][0]
    ref = reference[arch][0]
    share = (acc["memory"]["temp_size_in_bytes"]
             / one["memory"]["temp_size_in_bytes"])
    print(f"{arch}: temporaries {acc['memory']['temp_size_in_bytes']} B at "
          f"accum_steps={K}, {share:.4f} of k = 1's; the reference's "
          f"{ref['memory']['temp_size_in_bytes']} B")
    assert share <= TEMP_SHARE
