"""The example twins on the CPU against the reference scripts, in
process, at the reference scripts' seeds:

- ``torch_quickstart`` vs ``quickstart``, ``torch_byzantine_cge`` vs
  ``byzantine_cge`` (every rule x attack run): each ``AsyncEngine.run``'s
  history is caught from both packages; event counts (``n_rx``,
  ``max_age``, ``bytes_tx``) and ``comm_time`` are exact, loss within
  rtol 1e-4 and ||x - x*|| within rtol 1e-3 (atol 1e-6): the f32 rules
  reduce in another order over thousands of rounds
  (test_torch_engine.py); the printed lines equal the reference's but
  for those floats, which agree to the printed digits here;
- ``torch_serve_lm`` vs ``serve_lm`` on the reference's weights
  (``params_from_jax``), f32 reduced configs: every request's stream,
  the engine stats, peak slots and pages free equal (the printed lines
  but the timing)."""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.core import async_engine as jeng
from repro.models import model as jmodel
from repro_torch.core import async_engine as teng
from repro_torch.models.model import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
DIST_TOL = dict(rtol=1e-3, atol=1e-6)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _catch_runs(monkeypatch, cls):
    """Every history ``cls.run`` returns, in call order."""
    runs, run = [], cls.run

    def caught(self, iters):
        h = run(self, iters)
        runs.append(h)
        return h
    monkeypatch.setattr(cls, "run", caught)
    return runs


def _ref_lines(capsys, fn):
    fn()
    out = capsys.readouterr().out
    return [l for l in out.split("\n") if l] if out else []


def _split_lines(lines):
    return [l for line in lines for l in line.split("\n") if l]


def _same_history(got, want):
    assert got.n_rx == want.n_rx
    assert got.max_age == want.max_age
    assert got.bytes_tx == want.bytes_tx
    assert got.comm_time == want.comm_time
    np.testing.assert_allclose(got.loss, want.loss, **LOSS_TOL)
    np.testing.assert_allclose(got.dist, want.dist, **DIST_TOL)


@pytest.mark.parametrize("name", ["quickstart", "byzantine_cge"])
def test_engine_example_matches_reference(name, monkeypatch, capsys):
    ref_runs = _catch_runs(monkeypatch, jeng.AsyncEngine)
    ref = _ref_lines(capsys, _load(name).main)
    port_runs = _catch_runs(monkeypatch, teng.AsyncEngine)
    ours = _split_lines(_load(f"torch_{name}").main(["--device", "cpu"]))
    capsys.readouterr()
    assert len(port_runs) == len(ref_runs) == \
        {"quickstart": 1, "byzantine_cge": 9}[name]
    for got, want in zip(port_runs, ref_runs):
        _same_history(got, want)
    assert ours == ref


def test_byzantine_device_backend_on_the_cpu(monkeypatch):
    """``--agg-backend device`` (the resident ledger and the rules'
    kernel-backed twins; their plain forms on a CPU tensor) runs the same
    events as the host backend, the filtered distances within rtol 1e-3."""
    mod = _load("torch_byzantine_cge")
    runs = _catch_runs(monkeypatch, teng.AsyncEngine)
    for rule, attack in (("cge", "sign_flip"), ("trimmed_mean", "large_norm"),
                         ("sum", "random_gaussian")):
        mod.run(rule, attack, "cpu", "host")
        mod.run(rule, attack, "cpu", "device")
        host, dev = runs[-2:]
        assert dev.n_rx == host.n_rx and dev.comm_time == host.comm_time
        np.testing.assert_allclose(dev.dist, host.dist, **DIST_TOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-3b"])
def test_serve_lm_matches_reference(arch, monkeypatch, capsys):
    argv = ["--arch", arch]
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", *argv])
    ref = _ref_lines(capsys, _load("serve_lm").main)
    jcfg = jax_config(arch).reduced()
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg, max_pos=256)
    ours = _load("torch_serve_lm").main(
        [*argv, "--device", "cpu"],
        params=params_from_jax(jax.tree.map(np.asarray, jp)))
    capsys.readouterr()
    timing = re.compile(r" in [0-9.]+s \([0-9.]+ tok/s\)")
    assert len(ours) == len(ref) == 2 + 6
    assert [timing.sub("", l) for l in ours] == \
        [timing.sub("", l) for l in ref]
