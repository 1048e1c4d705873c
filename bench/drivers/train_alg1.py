"""Algorithm 1 training through the port's ``TrainLoop``.

Set-up builds one ``TrainLoop`` (the masked step with its model and
optimizer state), puts the seed's weights in it, and drives its first
``check.ref_steps`` steps through the window's own call (``run(1)``, the
straggler oracle fed that step's per-agent times through its
``observe`` hook) on rows that all differ. The window then steps the same
object until a step ends past ``--seconds``. After the window the
program's state is freed and the plain reference follows the first steps
from the same weights, rows and times; the two are compared by
``judge.train_numbers``.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

import flops
import judge
import tokens
import weights
from program import arch_config
from reference import train as ref_train
from reference.model import Matmul, precision
from devtrace import TRACE_SECONDS, Tracer, log


def _norms_from_p0(params, seed: int, scale: float = 1.0) -> Dict[str, float]:
    """Each layer leaf's ||params - p0|| * scale, p0 the seed's weights
    drawn again leaf by leaf."""
    out = {}
    for path, t in weights.leaves(params):
        p0 = weights.make_leaf(seed, path, t.shape, t.dtype, t.device)
        if path.startswith("blocks."):
            for i in range(t.shape[0]):
                out[f"{path}[{i}]"] = float(
                    (t[i].float() - p0[i].float()).norm()) * scale
        else:
            out[path] = float((t.float() - p0.float()).norm()) * scale
        del p0
    return out


def _named(params, norms) -> Dict[str, float]:
    out = {}
    for (path, _), v in zip(weights.leaves(params), norms):
        if path.startswith("blocks."):
            out.update({f"{path}[{i}]": float(x) for i, x in enumerate(v)})
        else:
            out[path] = float(v)
    return out


def reference_readings(cell, arch, seed: int, steps: int, rows, times,
                       device, mm: str = None) -> Dict:
    """The plain reference's readings over the first ``steps`` steps: the
    loss of each, the first gradient as the update applied it (from the
    parameters after step 1) and the clipped first gradient by leaf, and
    the parameters' change after the last."""
    tr = cell.traffic
    r, lr = tr["r"], tr["lr"]
    params = weights.make_params(arch, seed, device)
    split = [p.startswith("blocks.") for p, _ in weights.leaves(params)]
    out = {"loss": []}

    def on_step(t, loss, norms):
        out["loss"].append(loss)
        if t == 1:
            out["ref_grad1"] = _named(params, norms)
            out["grad1"] = _norms_from_p0(params, seed, 1.0 / lr)

    batches = []
    for t in range(1, steps + 1):
        x, y = rows.step(t)
        keep = times.kept(t, r)
        batches.append((torch.as_tensor(x[keep], device=device),
                        torch.as_tensor(y[keep], device=device)))
    ref_train.run_steps(params, batches, cell.config, lr, tr["clip_norm"],
                        Matmul(mm or precision(cell.config)), on_step, split)
    out["change"] = _norms_from_p0(params, seed)
    return out


def build(cell, seed: int, device):
    """The program's ``TrainLoop`` holding the seed's weights, and the
    traffic it is fed."""
    from repro_torch.launch.loop import StragglerOracle, TrainLoop
    from repro_torch.launch.train import TrainConfig
    tr = cell.traffic
    arch = arch_config(cell.config)
    n, r = tr["agents"], tr["r"]
    stream = tokens.stream(seed, tr["seq_len"], arch.vocab_size)
    rows = tokens.TrainRows(seed, stream, n, tr["seq_len"])
    times = tokens.AgentTimes(seed, n, tr["stragglers"],
                              tr["straggler_factor"], tr["latency_sigma"])
    tc = TrainConfig(mode="masked", optimizer=tr["optimizer"], lr=tr["lr"],
                     clip_norm=tr["clip_norm"],
                     remat_policy=tr["remat_policy"])
    oracle = StragglerOracle(n, r, seed=seed)
    loop = TrainLoop(arch, tc, rows.iterate(), n_agents=n, r=r,
                     oracle=oracle, seed=seed % (1 << 63), device=device)
    loop.state["params"] = weights.make_params(arch, seed, device)

    def step(t: int) -> None:
        oracle.observe(times.step(t))
        loop.run(1)

    return arch, loop, rows, times, step


def program_readings(loop, step, seed: int, steps: int, lr: float) -> Dict:
    out = {}
    for t in range(1, steps + 1):
        step(t)
        if t == 1:
            out["grad1"] = _norms_from_p0(loop.state["params"], seed, 1.0 / lr)
    out["change"] = _norms_from_p0(loop.state["params"], seed)
    out["loss"] = list(loop.hist.loss[:steps])
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> Dict:
    tr, chk = cell.traffic, cell.check
    cuda = torch.device(device).type == "cuda"
    arch, loop, rows, times, step = build(cell, seed, device)
    log("built the TrainLoop")
    n_ref = chk["ref_steps"]
    prog = program_readings(loop, step, seed, n_ref, tr["lr"])
    log(f"{n_ref} steps read: losses {prog['loss']}")
    tracer = Tracer() if trace else None
    if tracer:
        tracer.warm()
    _sync(device)
    setup_s = time.monotonic() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    log("set-up done; the window opens")
    t0 = time.perf_counter()
    t, steps = n_ref + 1, 0
    while True:
        now = time.perf_counter() - t0
        if tracer and not (tracer.active or tracer.done) and now >= 0.2 * seconds:
            tracer.start()
            t_tr = now
        step(t)
        t, steps = t + 1, steps + 1
        now = time.perf_counter() - t0
        if tracer and tracer.active and now - t_tr >= TRACE_SECONDS:
            tracer.stop()
        if now >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if tracer and tracer.active:
        tracer.stop()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = loop.hist.loss[n_ref:]
    failed = sum(1 for x in losses if not math.isfinite(x))
    kept_tokens = steps * (tr["agents"] - tr["r"]) * tr["seq_len"]
    if tracer:
        tracer.reduce()

    del loop, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"the window closed: {elapsed:.3f} s, {steps} steps; the reference "
        "follows the first steps")
    ref = reference_readings(cell, arch, seed, n_ref, rows, times, device)
    log(f"reference losses {ref['loss']}")
    numbers = judge.train_numbers(prog, ref)
    log("numbers: " + ", ".join(f"{k} {v[0]!r} ({v[1]})"
                                for k, v in numbers.items()))
    correct, compared = judge.decide(numbers, chk["limits"])
    a = cell.config["arch"]
    return {
        "correct": correct and failed == 0, "compared": compared,
        "attempted": steps, "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "e2e": {"train_tokens_per_s": kept_tokens / elapsed,
                "setup_s": setup_s},
        "ctx": {"kind": "train", "steps": steps,
                "window_s": elapsed - (tracer.overhead_s if tracer else 0),
                "train_flops": kept_tokens * flops.train_flops_per_token(
                    a, tr["seq_len"]),
                "peak_window_bytes": window_peak, "tracer": tracer},
    }
