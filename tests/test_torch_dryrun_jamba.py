"""jamba-v0.1-52b's dry-run cells (``repro_torch.launch.dryrun``) held
rank by rank against the reference's, at full depth (32 layers: 28
Mamba mixers, 4 GQA layers, 16 MoE blocks of 16 experts) and full width
on the production mesh (16 x 16, one pod), baseline layout.

The port computes jamba tensor- and expert-parallel over "model": its
Mamba mixers on a block of their inner width (``a_log`` re-laid to it,
the decode's state on a block of d_state), its attention heads over
gcd(32, 16) head groups, its experts one a rank. Its train_4k,
prefill_32k, decode_32k and long_500k cells and its cge general cell
each reach within [0.90, 1.10] of the reference's FLOPs a rank (train
0.990, prefill 1.000, decode 1.000, long 1.000, cge 0.999), with the
argument bytes exactly the reference's: the train state's blocks, and
the decode cells' caches in ``cache_specs``' layout (Mamba's ``h`` split
over d_state, its ``conv`` rows over di).

The reference compiles its periods as one ``lax.scan``, so a cell costs
it the same at any depth (train ~1 min, cge ~1.5 min on this CPU): both
of its runs start at once, and the port's cells (~35 s on the meta
device) are traced while they compile.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
ARCH = "jamba-v0.1-52b"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# (shape, mode) of every cell held here
CELLS = [(s, "masked") for s in SHAPES] + [("train_4k", "cge")]
TIMEOUT = 900


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """``scripts/reference_dryrun.py`` started on the baseline cells and,
    in a second process, on the cge cell; the fixture ``reference``
    collects them."""
    out = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    script = [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
              "--out", str(out)]
    procs = [subprocess.Popen(script + [f"{ARCH}:{s}" for s in SHAPES],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env),
             subprocess.Popen(script + ["--mode", "cge", f"{ARCH}:train_4k"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def records(reference_runs, tmp_path_factory):
    """The port's records of ``CELLS``, traced while the reference
    compiles."""
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for shape, mode in CELLS:
        tag = D.record_tag(None, False, mode)
        rec = D.run_cell(ARCH, shape, False, mode=mode, out_dir=str(out),
                         tag=tag)
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
    for shape, mode in CELLS:
        tag = D.record_tag(None, False, mode)
        name = f"{ARCH}__{shape}__single" + (f"__{tag}" if tag else "")
        rec = json.loads((out / f"{name}.json").read_text())
        assert rec["ok"] and rec["mode"] == mode, rec.get("error")
        recs[shape, mode] = rec
    return recs


@pytest.mark.parametrize("shape,mode", CELLS)
def test_jamba_cells_within_the_band(records, reference, shape, mode):
    """One rank's FLOPs within [0.90, 1.10] of the reference's, and the
    argument bytes exactly the reference's: the parameters, moments and
    (cge) rows of the train cells, the parameters and the Mamba and
    attention caches of the serving cells."""
    rec, ref = records[shape, mode], reference[shape, mode]
    assert "tensor-parallel" in rec["compute"]
    ratio = rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= ratio <= 1.10, ratio
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
