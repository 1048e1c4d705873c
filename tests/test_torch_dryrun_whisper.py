"""whisper-base's dry-run cells (``repro_torch.launch.dryrun``) held rank by
rank against the reference's, at full width and full depth (6 encoder
and 6 decoder layers) on the production mesh (16 x 16, one pod),
baseline layout: train_4k, prefill_32k, decode_32k and the general
step's four train_4k cells (cge, stale, trimmed, quantized).

The port computes whisper tensor-parallel over "model": its 8 heads at
model 16 are one head over 2 ranks each, a rank's 32 of the head's 64
columns (the values and ``wo``'s fan-in; under the general step's
program the query and K too, the partial scores summed over the head's
2 ranks), the MLPs' 128 of 2048 columns, the embedding's 32 model
columns. The unembedding (51,865 rows, which 16 does not divide) stays
whole: the masked and serving cells compute the logits whole on every
rank, the general cell row-parallel over the model columns, as the
reference's compiled steps do. Each cell's FLOPs a rank are within
[0.90, 1.10] of the reference's.

The train, general and prefill cells' argument bytes are exactly the
reference's. The decode cell's are the reference's plus the leaves its
compiled program drops as unread: the encoder's (its layers,
``enc_pos``, ``enc_norm_f``) and every decoder layer's cross-attention
``wk`` / ``wv`` (a decode reads the encoder's K/V from the cache).

The reference's two runs start at once, and the port's cells are traced
while they compile.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-base"
GENERAL = ("cge", "stale", "trimmed", "quantized")
CELLS = ([("train_4k", "masked"), ("prefill_32k", "masked"),
          ("decode_32k", "masked")] + [("train_4k", m) for m in GENERAL])
TIMEOUT = 900


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """``scripts/reference_dryrun.py`` started on the baseline cells and,
    in a second process, on the general cells; the fixture ``reference``
    collects them."""
    out = tmp_path_factory.mktemp("reference")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    script = [sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
              "--out", str(out)]
    procs = [subprocess.Popen(script + [f"{ARCH}:{s}" for s in
                                        ("train_4k", "prefill_32k",
                                         "decode_32k")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env),
             subprocess.Popen(script + ["--mode", ",".join(GENERAL),
                                        f"{ARCH}:train_4k"],
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
        rec = D.run_cell(ARCH, shape, False, mode=mode, out_dir=str(out),
                         tag=D.record_tag(None, False, mode))
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


def _unread_by_decode():
    """Bytes of one rank's decode arguments that the reference's compiled
    decode drops: the encoder's leaves and the cross-attention ``wk`` /
    ``wv``, in ``launch.serve.init_params``' blocks on rank 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.serve import init_params

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return math.prod(t.shape) * t.element_size()

    p = init_params(None, get_config(ARCH),
                    make_production_mesh(record=True), device="meta")
    return (nbytes({k: p[k] for k in ("encoder", "enc_pos", "enc_norm_f")})
            + sum(nbytes({w: b["cross"][w] for w in ("wk", "wv")})
                  for b in p["blocks"]))


@pytest.mark.parametrize("shape,mode", CELLS)
def test_whisper_cells_within_the_band(records, reference, shape, mode):
    """One rank's FLOPs within [0.90, 1.10] of the reference's; argument
    bytes exactly the reference's, the decode's but for the leaves the
    reference's compiled decode drops."""
    rec, ref = records[shape, mode], reference[shape, mode]
    assert "tensor-parallel" in rec["compute"]
    ratio = rec["hlo"]["flops"] / ref["hlo"]["flops"]
    assert 0.90 <= ratio <= 1.10, ratio
    extra = _unread_by_decode() if shape == "decode_32k" else 0
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"] + extra
