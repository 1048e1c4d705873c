"""rwkv6-3b's dry-run cells (``repro_torch.launch.dryrun``) held rank by
rank against the reference's, at full width on the production mesh (16
x 16, one pod), baseline layout: decode_32k and long_500k at full depth
(32 layers), train_4k at one period (one layer: the port's per-token WKV
scan costs about a minute a layer on the meta device). The general cells
(cge, stale, trimmed, quantized) and prefill_32k at one period come from
the CLI, recorded in ROADMAP's table, to keep the file's time down.

The port computes rwkv6 tensor-parallel over "model": every weight's
columns a rank (160 of d's 2560), the WKV scan on a head group's heads
(40 heads over gcd(40, 16) = 8 groups of 5), the decode on a block of
every head's value columns. long_500k's batch of one leaves "data"
idle, and there, as the reference's compiled decode does, every
projection with a fan-in of d or d_ff takes this rank's block of it
over "data" and sums the partial products over it (``dist.tp.
fan_in_dot``; 8.090 of the reference's FLOPs a rank before). Each cell
is within [0.90, 1.10] of the reference's FLOPs a rank (train 1.000,
decode 1.000, long_500k 1.000).

The train cells' argument bytes are exactly the reference's. The
serving cells' are the reference's plus the position scalar's 4 bytes:
RWKV reads no position, and the reference's compiled program drops the
unused argument, so their caches (``wkv`` a block of value columns,
``tm_x`` and ``cm_x`` a block of d) are exactly the reference's.

The reference's cells compile in seconds (its layers are one
``lax.scan``): both of its runs start at once, and the port's cells are
traced while they compile.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
# (shape, mode, one period of depth or the whole)
CELLS = [("decode_32k", "masked", False), ("long_500k", "masked", False),
         ("train_4k", "masked", True)]
POSITION = 4                          # the serving step's int32 position
TIMEOUT = 900


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """``scripts/reference_dryrun.py`` started on the full-depth serving
    cells and, in a second process, on the train cell at one period;
    the fixture ``reference`` collects them."""
    out = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    script = [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
              "--out", str(out)]
    procs = [subprocess.Popen(script + [f"{ARCH}:decode_32k",
                                        f"{ARCH}:long_500k"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env),
             subprocess.Popen(script + ["--period", f"{ARCH}:train_4k"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _tag(mode, period):
    return D.record_tag(None, period, mode)


@pytest.fixture(scope="module")
def records(reference_runs, tmp_path_factory):
    """The port's records of ``CELLS``, traced while the reference
    compiles."""
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for shape, mode, period in CELLS:
        rec = D.run_cell(ARCH, shape, False, mode=mode, out_dir=str(out),
                         tag=_tag(mode, period),
                         cfg_patch={"n_layers": 1} if period else None)
        assert rec["ok"], rec.get("traceback")
        recs[shape, mode] = rec
    return recs


@pytest.fixture(scope="module")
def reference(reference_runs, records):
    out, procs = reference_runs
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    recs = {}
    for shape, mode, period in CELLS:
        tag = _tag(mode, period)
        name = f"{ARCH}__{shape}__single" + (f"__{tag}" if tag else "")
        rec = json.loads((out / f"{name}.json").read_text())
        assert rec["ok"] and rec["mode"] == mode, rec.get("error")
        recs[shape, mode] = rec
    return recs


@pytest.mark.parametrize("shape,mode", [c[:2] for c in CELLS])
def test_rwkv_cells_within_the_band(records, reference, shape, mode):
    """One rank's FLOPs within [0.90, 1.10] of the reference's, and the
    argument bytes exactly the reference's: the parameters and moments of
    the train cell; the parameters, tokens and caches of the serving
    cells, with the position the reference's program drops."""
    rec, ref = records[shape, mode], reference[shape, mode]
    assert "tensor-parallel" in rec["compute"]
    ratio = rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= ratio <= 1.10, ratio
    extra = 0 if rec["kind"] == "train" else POSITION
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"] + extra
