"""The harness on the CPU: names resolve, counts match hand counts, the
reference matches the port, imports stay clean, and the check says
``correct`` for a sound run and not for a broken one or the control."""
import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import flops
import spec
import tiny
import weights
from program import arch_config
from reference import model as R
from reference import train as RT

BENCH = Path(__file__).resolve().parents[1]
BJ = spec.benchmark()
CELLS = [w["name"] for w in BJ["workloads"]]
SEED = 2**31 + 977


def test_every_name_resolves():
    files = {c["name"]: c["file"] for c in BJ["configs"]}
    for c in BJ["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        arch_config(cfg)
    for name in CELLS:
        cell = spec.cell(name)
        assert cell.config == spec.load_json(
            spec.ROOT / files[next(w["config"] for w in BJ["workloads"]
                                   if w["name"] == name)])
        assert hasattr(spec.driver(cell.traffic), "run")
        assert cell.check["limits"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in BJ["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def _arch(name):
    return spec.load_json(BENCH / "configs" / f"{name}.json")["arch"]


def test_counts_match_hand_counts():
    yi = spec.cell("train.yi-6b.alg1").config["arch"]
    jb = _arch("jamba-v0.1-52b-p2")
    assert flops.total_params(yi) == 6_061_035_520
    assert flops.total_params(jb) == 26_053_595_136
    assert flops.total_params(jb, active=True) == 6_323_589_120
    # matrix products: all but the embedding (64000 x 4096) and the norms
    assert flops.matmul_params(yi) == 6_061_035_520 - 262_144_000 - 65 * 4096
    # 14 Mamba layers' w_in, x_proj, dt_w, w_out; 2 attention; 8 MLPs;
    # 8 MoE layers' routers and top-2 experts; the unembedding
    mamba = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    mlp = 3 * 4096 * 14336
    assert flops.matmul_params(jb) == (14 * mamba + 2 * attn + 8 * mlp
                                       + 8 * (4096 * 16 + 2 * mlp)
                                       + 4096 * 65536)
    # the port's own count agrees on every configuration
    from repro_torch.models.model import count_params
    for a in (yi, jb):
        arch = arch_config({"arch": a})
        assert count_params(arch) == flops.total_params(a)
        assert count_params(arch, active_only=True) == flops.total_params(
            a, active=True)
    assert flops.prefill_flops(yi, 10) == (2 * flops.matmul_params(yi) * 10
                                           + 2 * 4096 * 100 * 32)
    assert flops.decode_attn_bytes(yi, 1, 100) == (100 * 2 * 4 * 128 * 2
                                                   + 2 * 32 * 128 * 2) * 32


def _top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    for path in BENCH.rglob("*.py"):
        names = set(_top_names(path))
        assert not names & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path


def _forward_port(arch, params, tokens):
    """The port's forward; an MoE drop-free, as the serving engine runs
    it (the reference drops no token)."""
    import dataclasses
    from repro_torch.models.model import apply_model
    if arch.moe is not None:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=arch.moe.num_experts / arch.moe.top_k))
    with torch.no_grad():
        logits, _, _ = apply_model(params, tokens, arch, mode="train")
    return logits.float()


@pytest.mark.parametrize("name", ["yi-6b", "jamba-v0.1-52b-p2"])
def test_reference_matches_port_logits(name):
    config = tiny.config(name)
    arch = arch_config(config)
    params = weights.make_params(arch, SEED, "cpu")
    # 768 tokens: three chunks of the port's Mamba scan
    tokens = torch.randint(0, arch.vocab_size, (2, 768),
                           generator=torch.Generator().manual_seed(3))
    want = _forward_port(arch, params, tokens)
    got = R.logits(params, R.hidden(params, tokens, config,
                                    R.Matmul("f32")), R.Matmul("f32"))
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), \
        float((got - want).abs().max())


def test_reference_step_matches_port_step():
    from repro_torch.launch.train import TrainConfig, make_train_step
    cell = tiny.cell("train.yi-6b.alg1")
    arch = arch_config(cell.config)
    tc = TrainConfig(mode="masked", optimizer="sgd", lr=4.0, clip_norm=1.0,
                     remat_policy="full")
    params = weights.make_params(arch, SEED, "cpu")
    x = torch.randint(0, arch.vocab_size, (4, 32),
                      generator=torch.Generator().manual_seed(4))
    y = torch.roll(x, -1, 1)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, 32).contiguous()
    state = {"params": params, "opt": {}, "step": torch.zeros((), dtype=torch.int32)}
    new, m = make_train_step(arch, tc, moe_groups=4)(state, {
        "tokens": x, "targets": y, "weights": w})
    ref = weights.make_params(arch, SEED, "cpu")
    keep = torch.tensor([0, 2, 3])
    loss, _ = RT.sgd_step(ref, x[keep], y[keep], cell.config, 4.0, 1.0,
                          R.Matmul("f32"))
    assert abs(loss - float(m["loss"])) < 1e-5
    want = dict(weights.leaves(ref))
    for p, a in weights.leaves(new["params"]):
        assert torch.allclose(a, want[p], atol=1e-5), p


def _run(cell, seed=SEED):
    drv = spec.driver(cell.traffic)
    return drv.run(cell, seed, 1.0, False, time.monotonic(), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(tiny.cell(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["e2e"]) >= {m["name"] for m in spec.cell(name).end_to_end}


def _unchanged_step(real):
    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return broken
    return make


def _half_batch_step(real):
    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, batch):
            b = dict(batch)
            w = b["weights"].clone()
            w[w.shape[0] // 2:] = 0.0
            b["weights"] = w
            return step(state, b)
        return broken
    return make


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    import repro_torch.launch.loop as loop_mod
    wrap = _unchanged_step if fault == "unchanged_state" else _half_batch_step
    monkeypatch.setattr(loop_mod, "make_train_step",
                        wrap(loop_mod.make_train_step))
    out = _run(tiny.cell("train.yi-6b.alg1"))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ["altered_token", "unchanged_cache"])
def test_broken_serving_is_not_correct(fault, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    cell = tiny.cell("serve.yi-6b.rag")
    vocab = cell.config["arch"]["vocab_size"]
    if fault == "altered_token":
        real = ServeEngine._superstep

        def superstep(self, *a, **k):
            out, lens = real(self, *a, **k)
            out = out.clone()
            out[-1] = (out[-1] + 1) % vocab
            return out, lens
        monkeypatch.setattr(ServeEngine, "_superstep", superstep)
    else:
        import repro_torch.models.attention as attn
        monkeypatch.setattr(attn, "_paged_append", lambda *a, **k: None)
    cell.traffic["output_len"] = {"min": 6, "max": 8}
    out = _run(cell)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in float8 e4m3, the precision below the cell's
    bfloat16, in the program's place, fails the cell's limits (at the
    cell's dtype, cut to a size the CPU runs)."""
    import judge
    cell = tiny.cell(name, bf16=True)
    if cell.traffic["driver"] == "serve_closed":
        # the control drifts with depth and length, as at full size:
        # 8 layers, prompts of 256-512 tokens
        cell.config["arch"].update(n_layers=8, vocab_size=4096)
        cell.traffic.update(prompt_len={"min": 256, "max": 512},
                            output_len={"min": 6, "max": 8})
    drv = spec.driver(cell.traffic)
    if cell.traffic["driver"] == "train_alg1":
        import tokens
        arch = arch_config(cell.config)
        tr = cell.traffic
        stream = tokens.stream(SEED, tr["seq_len"], arch.vocab_size)
        rows = tokens.TrainRows(SEED, stream, tr["agents"], tr["seq_len"])
        times = tokens.AgentTimes(SEED, tr["agents"], tr["stragglers"],
                                  tr["straggler_factor"], tr["latency_sigma"])
        n = cell.check["ref_steps"]
        ref = drv.reference_readings(cell, arch, SEED, n, rows, times, "cpu")
        low = drv.reference_readings(cell, arch, SEED, n, rows, times, "cpu",
                                     mm="fp8")
        ok, compared = judge.decide(judge.train_numbers(low, ref),
                                    cell.check["limits"])
    else:
        params, eng, loop = drv.build(cell, SEED, "cpu")
        drv.warm(loop)
        while len(loop.done) < 8:
            loop.step()
        gaps = drv.check(params, cell.config, loop.done, cell.check["ref_batch"],
                         control="fp8")
        nums = drv.gap_numbers(gaps)
        ok, compared = judge.decide({k: (nums[k], "") for k in
                                     cell.check["limits"]}, cell.check["limits"])
    assert not ok, compared


# -- faults of the program that the cells stay clear of ----------------


@pytest.mark.xfail(strict=True, raises=ValueError,
                   reason="prefill over 2048 tokens goes to chunked_attention, "
                          "which needs a multiple of 1024 (models/attention.py)")
def test_prefill_past_2048_tokens_of_any_length():
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedCacheConfig
    cell = tiny.cell("serve.yi-6b.rag")
    arch = arch_config(cell.config)
    params = weights.make_params(arch, SEED, "cpu")
    eng = ServeEngine(params, arch, PagedCacheConfig(
        num_slots=1, page_size=16, num_pages=140, max_pages_per_seq=139),
        device="cpu")
    eng.submit(np.arange(2064, dtype=np.int32) % arch.vocab_size, 1)
    eng.step()


@pytest.mark.xfail(strict=True, raises=ValueError,
                   reason="a Mamba prefill needs at most 256 tokens or a "
                          "multiple of 256 (models/ssm.py chunked_linear_scan)")
def test_mamba_prefill_of_any_length():
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedCacheConfig
    arch = arch_config(tiny.config("jamba-v0.1-52b-p2"))
    params = weights.make_params(arch, SEED, "cpu")
    eng = ServeEngine(params, arch, PagedCacheConfig(
        num_slots=1, page_size=16, num_pages=40, max_pages_per_seq=39),
        device="cpu")
    eng.submit(np.arange(300, dtype=np.int32) % arch.vocab_size, 1)
    eng.step()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_one_short_run_on_the_card(name, card):
    import subprocess
    import sys
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        name, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=BENCH.parent, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
