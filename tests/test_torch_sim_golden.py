"""Port parity for golden traces: ``repro_torch.sim.golden.build_trace(
name, device="cpu")`` against a live ``repro.sim.golden.build_trace(
name)`` for every registered scenario. The serve half is numpy end to
end: identical, digest included. The train half's stored steps are
decoded from ``float.hex`` and compared as ``tests/test_torch_sim_
scenarios.py`` compares traces (discrete fields exact, ``loss`` rtol 1e-4
/ atol 1e-5, ``dist`` rtol 1e-3 / atol 1e-5); its other fields are
identical, apart from the digest and the final iterate's hash, which
hash those floats. Then ``diff_traces`` must name a tampered step and a
tampered digest, and ``--record`` must refuse to run without ``--out``
and never write into ``tests/golden/``."""
import json

import numpy as np
import pytest

from repro.sim import golden as jg
from repro.sim.scenario import SCENARIOS
from repro_torch.sim import golden as tg

ALL = sorted(SCENARIOS)
FLOATS = ("loss", "dist")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
DIST_TOL = dict(rtol=1e-3, atol=1e-5)


def _decode(steps):
    return [{k: float.fromhex(v) if k in tg._FLOAT_KEYS else v
             for k, v in s.items()} for s in steps]


@pytest.mark.parametrize("name", ALL)
def test_build_trace_matches_reference(name):
    ref, ours = jg.build_trace(name), tg.build_trace(name, device="cpu")
    assert ours["serve"] == ref["serve"]
    assert {k: ours[k] for k in ("scenario", "seed", "iters")} == \
        {k: ref[k] for k in ("scenario", "seed", "iters")}
    rt, ot = ref["train"], ours["train"]
    assert sorted(ot) == sorted(rt)
    for key in ("bytes_tx", "violations", "drops", "dups"):
        assert ot[key] == rt[key], key
    assert ot["violations"] == 0 and ours["serve"]["violations"] == 0
    rs, os_ = _decode(rt["steps"]), _decode(ot["steps"])
    assert len(os_) == len(rs)
    assert [sorted(s) for s in os_] == [sorted(s) for s in rs]
    for key in rs[0]:
        if key not in FLOATS:
            assert [s[key] for s in os_] == [s[key] for s in rs], key
    np.testing.assert_allclose([s["loss"] for s in os_],
                               [s["loss"] for s in rs], **LOSS_TOL)
    np.testing.assert_allclose([s["dist"] for s in os_],
                               [s["dist"] for s in rs], **DIST_TOL)


def test_diff_traces_catches_tampered_step_and_digest():
    trace = tg.build_trace("steady_state", device="cpu")
    assert tg.diff_traces(trace, trace) == []
    bad = json.loads(json.dumps(trace))
    bad["train"]["steps"][3]["n_rx"] += 1
    bad["serve"]["digest"] = "0" * 64
    got = tg.diff_traces(trace, bad)
    assert got == jg.diff_traces(trace, bad)
    assert any("train stored step 3" in m and "n_rx" in m for m in got)
    assert any(m.startswith("serve.digest") for m in got)


def test_golden_dir_and_smoke_set_match_reference():
    assert tg.GOLDEN_DIR == jg.GOLDEN_DIR
    assert tg.SMOKE_SCENARIOS == jg.SMOKE_SCENARIOS
    assert (tg.STORE_PREFIX, tg.STORE_STRIDE) == (jg.STORE_PREFIX,
                                                  jg.STORE_STRIDE)
    assert tg.load_trace("steady_state") == jg.load_trace("steady_state")
    assert tg.verify(["no_such_scenario"], device="cpu") == {
        "no_such_scenario": [f"no committed golden trace at "
                             f"{tg.trace_path('no_such_scenario')}"]}


def test_record_needs_out_and_never_writes_golden_dir(tmp_path, capsys):
    before = {p.name: p.stat().st_mtime_ns for p in tg.GOLDEN_DIR.iterdir()}
    with pytest.raises(SystemExit) as info:
        tg.main(["--record", "--device", "cpu", "e2e_steady"])
    assert info.value.code == 2
    assert "--out" in capsys.readouterr().err
    assert tg.main(["--record", "--out", str(tmp_path), "--device", "cpu",
                    "e2e_steady"]) == 0
    written = json.loads((tmp_path / "e2e_steady.json").read_text())
    assert written == json.loads(json.dumps(
        tg.build_trace("e2e_steady", device="cpu")))
    with pytest.raises(ValueError, match="reference"):
        tg.save_trace(written, tg.GOLDEN_DIR)
    assert {p.name: p.stat().st_mtime_ns
            for p in tg.GOLDEN_DIR.iterdir()} == before
