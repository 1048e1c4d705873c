#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA
   versions.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one nvcc per source, all started together, sm_90a)
   and print the build time and each kernel's registers, shared memory
   and spills (among them the bf16 flash kernel's wgmma builds and the
   decode's split and combine kernels).
3. Hold each kernel against its plain torch form on the card. The
   aggregation kernels at the paper's shape (n=20 agents, P=431,080
   LeNet parameters), at ragged P, at a shape whose CGE share does not
   fit on chip (P=1,000,003, every agent received), with 64 agents (f=2)
   and with 4097 (held to f64 references, thousands of rows per sum),
   from a misaligned base (the int8 payload 1 and 8 bytes off too), and
   on the edge cases (every agent crashed, with exact zeros, m - f <= 0,
   exact norm ties, duplicate values), each output bit-identical on a
   repeated call; the plan of each shape (grid, bytes held per block,
   columns re-read, the dequant's load width) is printed; the paged
   flash-decode at the decode shapes of qwen2-0.5b, qwen2-1.5b, yi-6b and
   phase 11's jamba (G = 4 over 8 KV heads), qwen2-vl-2b (G = 6) and
   arctic (G = 7 over 8), Dv != D, PS = 128 and Pmax = 1, in f32 and
   bf16, ragged and full (each run to run identical), and
   on kv_len = 0 (exact zeros), -1 and stale table entries and
   page-boundary lengths, then over a 4096-token table walked by many
   splits (lengths on and past a split boundary), run to run identical;
   the split plan of each shape is printed. Then time each kernel, its
   plain form and one library call for the same function, each with a
   cold L2, beside the least time the card could take, and each kernel's
   per-launch device time with its inputs warm in L2; for scale, a
   torch.sum over the aggregation kernels' received rows in the same
   timing window; and the aggregation kernels with 4097 and 16,384
   agents (P = 20,000), cold, beside their bounds.
   3c. Flash attention, the CGE squared norms and the masked scaling
   against their plain forms on the cases of ``kernels/cases.py``: flash
   attention on the shapes of the JAX tests, ragged S = T = 100, T = 2 S
   under the top-left causal mask, Dv != D, inputs scaled x8, 4096
   tokens, D = 192, D = Dv = 256, D = 72 with Dv = 40, S > T, causal and
   not, f32 (CUDA cores) and bf16 (tensor cores); the norms and the
   scaling on the JAX sweep and ragged widths, with zero and one scales.
   Then each timed at phase 8's shapes (flash attention also at yi-6b's
   head shape, with its achieved TFLOP/s beside SDPA's) beside its bound
   and a library call (SDPA, ``vector_norm``, ``torch.mul`` into x's
   dtype).
4. The main path: ``AsyncDGDServer`` with the §5 LeNet agents (n=20,
   data partitioned with overlap 2) on the device backend, for the
   mean, cge (one sign-flip agent), trimmed_mean (stale) and quantized
   rules. Kernel launch counts are zeroed just before and read just
   after. Every run must give finite losses, match the host conformance
   pipeline (the reference rule op by op) on the card, and replay
   snapshot -> restore -> run bit for bit.
5. Where the time goes: a few cge iterations under torch.profiler (host
   ms per iteration, device busy time and idle share, copies, kernels),
   then a few quantized iterations: device us per iteration of the int8
   quantization's PyTorch operations beside ``dequant_accum``'s.
6. The serving path: ``ServeEngine`` at the full width of qwen2-0.5b
   (24 layers, d=896, 14 query heads over 2 KV heads, vocab 151,936,
   bf16, weights from seed 0) serves 24 requests (prompts of 64-512
   tokens, 16-64 new tokens each) on 8 slots of a paged cache with
   superstep_k=8. The decode kernel's launch count is zeroed just before
   and read just after. Every request must finish with exactly its
   budget, every page must come back, the kernel must run at least once
   per layer and decode step, the token streams must equal a
   superstep_k=1 run's, and teacher-forced decode logits through the
   kernel must match the plain form's. Prints decode tokens/s, ms per
   superstep, mean TTFT, prefill ms and the kernel's share of device
   time.
7. Where the serving time goes: a few supersteps under torch.profiler
   (host ms per step, device busy time and idle share, device
   activities per decode step).
8. The kernels API at full width (``kernels/ops.py``), launch counts
   zeroed just before and read just after: flash attention on layer 0's
   q, k, v of qwen2-0.5b (phase 6's weights) over a 4096-token prompt,
   against its plain form and the model's chunked attention; the CGE
   squared norms and masked scaling over the whole qwen2-0.5b parameter
   tree bucketed as bf16 (241,227 rows of 2048), against the plain forms
   and an f64 sum of squares; and the CGE keep-set of one cge iteration
   of the §5 LeNet agents from bucketed norms, against the plain form's
   on the same buckets and the f32 ledger's.
9. The simulator (``repro_torch.sim``): ``run_train`` of all 13
   registered scenarios (n = 8 agents, dim = 4) on the card with the host
   backend, each against the same run on the CPU in this process (zero
   conformance violations, the discrete trace fields identical, loss and
   dist within rtol 1e-4 / 1e-3), and ``run_serve`` of each; then
   ``byzantine_flip_midrun`` (cge, f = 2, two attack switches, an (8, 4)
   ledger through ``masked_cge_reduce``) and ``rolling_restart`` (stale,
   tau = 3, a crash/recover wave) on the device backend, held the same
   way. The aggregation kernels' counts are zeroed just before and read
   just after; CGE's kernel must launch at every iteration of its run.
   Prints per run wall seconds, iterations per second, the final
   ||x - x*|| against the envelope radius, drops and duplicates.
10. The e2e harness (``repro_torch.sim.e2e``): one ``EngineFleet`` of 8
   replicas of qwen2-0.5b at full width over phase 6's weights (2 slots,
   8-token pages, superstep_k = 4, 8 new tokens a request) replays
   ``e2e_steady`` and ``crash_cascade``, each cut to its first 16
   requests (of 32 and 40; printed as ``reduced``), on the same warm
   fleet, drained between them. The decode kernel's count is
   zeroed just before each run and read just after. Both runs must have
   zero violations, and every delivered stream of ``e2e_steady`` must be
   the plain attention form's greedy argmax (teacher forced, on the
   fleet's page size) wherever the top-2 margin exceeds the logit
   tolerance. Prints per run the native quorum row and each row of the
   r-sweep (goodput, p50/p99 latency and TTFT in virtual time), wall
   seconds, and decode steps and supersteps per replica.
11. The other model families at full width, one config at a time,
   bf16 weights from seed 0 made on the card and freed before the next:
   ``ServeEngine`` (4 slots, 16-token pages, superstep_k = 4) serves 8
   requests (prompts of 16-256 tokens, 8-16 new tokens each) on
   jamba-v0.1-52b (one period: 8 layers, 7 Mamba, 1 GQA, 4 MoE),
   deepseek-v2-236b (2 layers: MLA latent pages, 160 experts top-6, 2
   shared), arctic-480b (1 layer: 128 experts and the dense residual),
   rwkv6-3b (all 32 layers) and qwen2-vl-2b (all 28, M-RoPE); the cuts in
   depth are printed as ``reduced``. Each must finish every request with
   its budget and bring back every page, give the streams of a
   superstep_k = 1 run, and launch the decode kernel exactly once per
   GQA layer and decode step (zero for rwkv6 and deepseek-v2), its count
   zeroed just before and read just after; the GQA configs' teacher-
   forced decode logits through the kernel must match the plain form's
   within the logit tolerance. Prints per config the parameter GB, the
   seconds to make them, decode tok/s, ms per decode step, ms per
   prefill and the launches, and where two profiled supersteps' time
   goes (host ms and device busy ms per decode step, idle share, the
   top device activities). Then whisper-base (full, f32) through
   ``apply_model``: a prefill over 1,500 frame embeddings and 16
   dense-cache decode steps on the card against the CPU (rtol = atol =
   1e-4); and the reduced config of each new family in f32 on the card
   against the CPU: prefill and decode logits within 1e-4, served
   streams equal wherever the CPU's top-2 margin exceeds it.
   Phase 6's weights and phase 10's fleet stay on the card for:
12. The prefix cache at full width: ``ServeEngine(prefix_cache="on")``
   on phase 6's weights (8 slots, 16-token pages, superstep_k = 8)
   serves 24 requests (16-32 new tokens): 16 on a 256-token system
   prompt with tails of 1-40, 4 identical 200-token prompts (full hits,
   COW forks), 4 cold prompts of 64-128; run A on a pool that never
   evicts, then again with the cache off; run B under ``sla`` on a
   60-page pool, half the requests at priority 0 first and the rest at
   priority 1 two steps later, so the LRU evicts and requests are
   preempted and resumed. The books are checked after every step; every
   budget met; every page back; the hit, COW and suffix counters; the
   decode kernel exactly once per layer and decode-program iteration
   (superstep iterations plus suffix steps). Every stream of run A (on
   and off) and of run B is teacher forced through the plain form and
   the kernel: it must be the plain greedy argmax wherever the top-2
   margin exceeds the logit tolerance, and the kernel's logits within
   that tolerance of the plain form's. Then reduced qwen2-0.5b in f32 on
   the CPU test's mix and on a one-slot 12-page ``sla`` run (the LRU
   evicts, a preemption, a resume that re-shares resident blocks):
   streams with the cache on equal the cache-off run's and the CPU's
   exactly, and the stats equal the CPU's. Prints TTFT, prefill and
   suffix-step ms, hit and miss tokens, decode tok/s, forks, evictions
   and each admission's time to its first token.
13. Fleet control and checkpoint rejoin on phase 10's fleet: engine 0's
   snapshot through the ``Checkpointer`` into ``restart(image)`` (the
   rid counter monotone, the same stream after, a busy engine's
   snapshot refused), then ``run_fleet_e2e`` of ``crash_cascade`` cut to
   16 requests, and of the same scenario with its three crashes moved
   onto requests in flight: zero violations, nothing lost, every death
   rejoined after probation, delivered streams the plain form's greedy
   argmax where the margin allows; in the second, copies lost to the
   crashes, the controller's hedges or retries, and a restarted replica
   serving again. Prints the ``FleetMetrics`` rows, the quorum
   rows, wall seconds and launches.
14. Wall-clock chaos: 4 of the fleet's engines as ``EngineReplica``s
   under ``RealClock`` through ``kill_rejoin`` cut to 12 requests, on the
   timescale of one request served by 3 replicas at once: nothing lost,
   no violation, drained, the killed replica declared dead, restarted
   and rejoined, one restart for each kill and no exception from any
   replica's engine (the fleet would count one as a crash and restart
   the replica), the decode kernel launched. Prints the report.
15. A JSON line with every kernel's launches (summed over the phases
   that drive a path: 4, 6, 8, 9, 10, 11, 12, 13 and 14), error and
   times, the ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is not available or the
repository's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import gradagg  # noqa: E402
from repro_torch.core.async_engine import (EngineConfig,  # noqa: E402
                                           default_latency)
from repro_torch.core.ledger import tree_flatten  # noqa: E402
from repro_torch.core.server import AsyncDGDServer  # noqa: E402
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402
from repro_torch.kernels import _build, agg, ops  # noqa: E402
from repro_torch.kernels import cge_norms as cgen  # noqa: E402
from repro_torch.kernels import decode_attention as dattn  # noqa: E402
from repro_torch.kernels import flash_attention as fattn  # noqa: E402
from repro_torch.kernels.cases import (CGE_SHAPES, FLASH_CASES,  # noqa: E402
                                       FLASH_TOL, NORM_TOL)
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import layers as mlayers  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models import model as mmodel  # noqa: E402
from repro_torch.models.model import classifier_loss  # noqa: E402
from repro_torch.models.model import apply_model, init_model  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.serve import (EngineReplica, FleetConfig,  # noqa: E402
                               PagedCacheConfig, RealClock, ReplicaKilled,
                               ServeEngine, SnapshotInFlightError)
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.sim.conformance import summarize  # noqa: E402
from repro_torch.sim.e2e import LOST, EngineFleet, run_e2e  # noqa: E402
from repro_torch.sim.faults import CrashWindow  # noqa: E402
from repro_torch.sim.fleet_e2e import run_fleet_e2e  # noqa: E402
from repro_torch.sim.realtime_chaos import (PLANS,  # noqa: E402
                                            run_realtime_chaos)
from repro_torch.sim.scenario import (SCENARIOS, get_scenario,  # noqa: E402
                                      run_serve, run_train)

N_AGENTS, P_LENET = 20, 431_080
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # agent-order sum vs torch's order
EDGE_TOL = dict(rtol=1e-6, atol=1e-6)     # edge cases: exact or near-exact
REPLACES = {
    "masked_cge_reduce": "src/repro/kernels/agg.py:58",
    "trimmed_mean_tiled": "src/repro/kernels/agg.py:154",
    "dequant_accum": "src/repro/kernels/agg.py:247",
    "paged_flash_decode": "src/repro/kernels/decode_attention.py:154",
    "flash_attention": "src/repro/kernels/flash_attention.py:73",
    "block_sq_norms": "src/repro/kernels/cge_norms.py:32",
    "masked_scale": "src/repro/kernels/cge_norms.py:69",
}
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = {k: f"{CSRC}/agg.cu" for k in REPLACES}
SOURCE["paged_flash_decode"] = f"{CSRC}/decode_attention.cu"
SOURCE["flash_attention"] = f"{CSRC}/flash_attention.cu"
SOURCE["block_sq_norms"] = SOURCE["masked_scale"] = f"{CSRC}/cge_norms.cu"
BUILDS = ("agg", "decode_attention", "flash_attention", "cge_norms")


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# 1. the card


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 dense
    tensor-core FLOP/s) of an H100 SXM from NVIDIA's data sheet: 3.35
    TB/s, 67 and 989 TFLOP/s. Another card has other peaks, which this
    script does not guess."""
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return 3.35e12, 67e12, 989e12
    raise RuntimeError(f"no data-sheet peaks for {name!r}: the bounds are "
                       "stated for an H100 SXM")


# ---------------------------------------------------------------------------
# 3. kernels against their plain forms, and their times


def ledger(n, p, n_received, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    rx = np.zeros(n, bool)
    rx[rng.choice(n, size=n_received, replace=False)] = True
    return (torch.from_numpy(g).to(device), torch.from_numpy(rx).to(device))


def edge_cases():
    """(name, g, received, f) on the card."""
    g, _ = ledger(6, 3001, 6, seed=4)
    # four rows of one norm with different contents (sign flips of one
    # row), and m - f = 4 keeping the smaller row and three of the four:
    # the id tie-break decides which tied row goes
    row = g[0]
    s1, s2 = torch.where(g[1:3] < 0, -1.0, 1.0)
    ties = torch.stack([row * 0.5, row, -row, row * 2.0, row * s1,
                        row * 3.0, row * s2])
    dups = torch.tensor([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                        device="cuda").repeat(1, 3001)

    def mask(*v):
        return torch.tensor(v, dtype=torch.bool, device="cuda")

    return [
        ("all_crashed", g, mask(*[False] * 6), 1),
        ("m_minus_f_nonpositive", g, mask(True, True, *[False] * 4), 3),
        ("ties", ties, mask(*[True] * 7), 3),
        ("duplicates", dups, mask(True, True, True, True, False, True), 1),
    ]


def check(name, out, ref, tol, errs):
    out, ref = out.cpu(), ref.cpu()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    errs.append(err)
    torch.testing.assert_close(out, ref, **tol, msg=lambda m: f"{name}: {m}")
    return err


def log_plans(n, p, m, q):
    """The aggregation kernels' plans for n agents, P columns, m received
    rows and the int8 payload ``q`` on this card (``agg.cge_plan``,
    ``agg.trimmed_plan``, ``agg.dequant_plan``)."""
    sms, smem = agg.card_limits(torch.device("cuda"))
    cp, tp = agg.cge_plan(n, p, sms, smem), agg.trimmed_plan(n, p, sms, smem)
    dp = agg.dequant_plan(n, p, q.data_ptr() % 16, sms)
    held = cp.held[m]
    widths = [min(cp.share, p - b * cp.share) for b in range(cp.grid)]
    reread = sum(max(0, w - held) for w in widths)
    log(f"    plan masked_cge_reduce : grid {cp.grid}, share {cp.share} "
        f"columns, {min(held, cp.share)} held x {m} rows = "
        f"{m * min(held, cp.share) * 4} B of rows per block "
        f"({cp.smem_bytes} B of shared memory asked), {reread} columns "
        "re-read" + (", per-agent lists in a device workspace"
                     if cp.workspace else ""))
    ring = (f"{tp.stages} stages of {n} rows ({tp.smem_bytes} B of shared "
            "memory)" if tp.stages else "no ring: rows read from device "
            "memory in agent order")
    log(f"    plan trimmed_mean_tiled: grid {tp.grid}, share {tp.share} "
        f"columns in chunks of {tp.chunk}, {ring}, 0 columns re-read")
    log(f"    plan dequant_accum     : base {q.data_ptr() % 16} mod 16, "
        f"{dp.vec}-byte loads, {dp.cols} columns a thread, grid {dp.grid} x "
        f"{agg.DQ_THREADS} threads, share {dp.share} columns, the mask "
        f"walked in {-(-n // agg.DQ_THREADS)} batch(es) per block")


def misaligned(g, elems=1):
    """g as a contiguous view ``elems`` elements past its storage's start:
    with one float, every row starts off its 16-byte line."""
    buf = torch.empty(g.numel() + elems, dtype=g.dtype, device=g.device)
    buf[elems:] = g.reshape(-1)
    return buf[elems:].view(g.shape)


def f64_references(g, rx, f, q, s):
    """For thousands of received rows: each kernel's f64 reference and the
    bound on its f32 error. A sum of m f32 terms in any order is off by
    about sqrt(m) roundings of the sum of their magnitudes (16x margin);
    a row kept or dropped wrongly moves a column by a whole |g|."""
    m = int(rx.sum())

    def bound(w, x):
        return 16 * m ** 0.5 * 2.0 ** -24 * (w.abs() @ x.abs())

    g64 = g.double()
    keep = gradagg.cge_mask_from_norms(agg.row_norms(g), rx, f).double()
    rows = g64[rx]
    cnt = m - 2 * f
    srt = torch.sort(rows, dim=0).values
    ones = torch.ones(m, dtype=torch.float64, device=g.device)
    w = (s * rx).double()
    q64 = q.double()
    return {"masked_cge_reduce": (keep @ g64, bound(keep, g64)),
            "trimmed_mean_tiled": (srt[f:m - f].sum(0) / cnt,
                                   bound(ones, rows) / cnt),
            "dequant_accum": (w @ q64, bound(w, q64))}


def check_f64(name, out, ref, bound):
    """Returns the largest error relative to its bound; raises above 1."""
    out = out.double()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    worst = float(((out - ref).abs() / bound.clamp(min=1e-300)).max())
    if worst > 1:
        raise AssertionError(f"{name}: {worst:.2f}x its f64 error bound")
    return worst


def check_kernels():
    errs = {k: [] for k in ("masked_cge_reduce", "trimmed_mean_tiled",
                            "dequant_accum")}
    shapes = [(N_AGENTS, P_LENET, N_AGENTS - 3, 1), (7, 4097, 5, 1),
              (N_AGENTS, 1_000_003, N_AGENTS, 2), (3, 1, 3, 0),
              (64, P_LENET, 45, 2), (4097, 20_000, 2868, 1)]
    for i, (n, p, m, f) in enumerate(shapes + [shapes[0]]):
        g, rx = ledger(n, p, m, seed=i)
        mis = i == len(shapes)
        if mis:
            g = misaligned(g)
        log(f"  n={n} P={p} m={m} f={f}" + (", misaligned base" if mis
                                           else ""))
        q, s = gradagg.quantize_int8_parts(g)
        s = s[:, 0].contiguous()
        log_plans(n, p, m, q)
        refs = f64_references(g, rx, f, q, s) if n > 1000 else None
        # the payload also 1 and 8 bytes past a 16-byte line
        payloads = [q] + ([misaligned(q, 1), misaligned(q, 8)] if mis else [])
        for k, kern, plain, args in (
                ("masked_cge_reduce", agg.masked_cge_reduce,
                 agg.masked_cge_dot, [(g, rx, f)]),
                ("trimmed_mean_tiled", agg.trimmed_mean_tiled,
                 agg.trimmed_mean_running, [(g, rx, f)]),
                ("dequant_accum", agg.dequant_accum, agg.dequant_dot,
                 [(qq, s, rx) for qq in payloads])):
            for a in args:
                out = kern(*a)
                what = f"{k} n={n} P={p} f={f}"
                if refs is None:
                    res = (f"max_abs_err="
                           f"{check(what, out, plain(*a), KERNEL_TOL, errs[k]):.3e}")
                else:
                    res = (f"{check_f64(what, out, *refs[k]):.3f} of its f64 "
                           "error bound")
                if not torch.equal(kern(*a), out):
                    raise AssertionError(f"{what}: not bit-identical on a "
                                         "repeated call")
                base = (f" payload base {a[0].data_ptr() % 16} mod 16"
                        if k == "dequant_accum" else "")
                log(f"  {k:20s} n={n:<4d} P={p:<9d} m={m:<4d} f={f} {res}, "
                    f"run to run identical{base}")
    for case, g, rx, f in edge_cases():
        q, s = gradagg.quantize_int8_parts(g)
        for k, kern, plain in (
                ("masked_cge_reduce", agg.masked_cge_reduce,
                 agg.masked_cge_dot),
                ("trimmed_mean_tiled", agg.trimmed_mean_tiled,
                 agg.trimmed_mean_running)):
            check(f"{k} {case}", kern(g, rx, f), plain(g, rx, f), EDGE_TOL,
                  errs[k])
        check(f"dequant_accum {case}", agg.dequant_accum(q, s[:, 0], rx),
              agg.dequant_dot(q, s[:, 0], rx), EDGE_TOL,
              errs["dequant_accum"])
        if case == "all_crashed":
            if agg.masked_cge_reduce(g, rx, f).abs().max() != 0 or \
                    agg.trimmed_mean_tiled(g, rx, f).abs().max() != 0 or \
                    agg.dequant_accum(q, s[:, 0], rx).abs().max() != 0:
                raise AssertionError("all_crashed must give exact zeros")
        log(f"  edge case {case}: ok")
    # every agent crashed at the paper's shape: the dequant writes zeros
    g, rx = ledger(N_AGENTS, P_LENET, 0, seed=0)
    q, s = gradagg.quantize_int8_parts(g)
    if agg.dequant_accum(q, s[:, 0], rx).abs().max() != 0:
        raise AssertionError("dequant_accum: all crashed must give zeros")
    log(f"  dequant_accum n={N_AGENTS} P={P_LENET}, every agent crashed: "
        "exact zeros")
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def time_ms(fn, flush=None, reps=30, warmup=3):
    """Median device ms of one call, timed alone with CUDA events. A spin
    kernel queued first lets the host enqueue the call ahead of the card,
    so host launch overhead stays out of the time; with ``flush`` (a
    buffer larger than the 50 MB L2) a read of it first evicts the inputs
    and leaves no dirty lines behind."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def library_cge(g, rx, k):
    norms = torch.where(rx, torch.linalg.norm(g, dim=1), float("inf"))
    keep = torch.zeros(g.shape[0], device=g.device)
    keep[torch.argsort(norms, stable=True)[:k]] = 1.0
    return keep @ g


def library_trimmed(g, rx, m, f):
    srt = torch.sort(torch.where(rx[:, None], g, float("inf")), dim=0).values
    return srt[f:m - f].sum(0) / max(m - 2 * f, 1)


def timing_row(kern, plain, lib, nbytes, nops, mem_rate, op_rate, flush):
    """Cold times of a kernel, its plain form and a library call for the
    same function (None where there is none), beside the bound: the
    larger of the bytes over the memory rate and the operations over
    ``op_rate``."""
    byte_ms = nbytes / mem_rate * 1e3
    op_ms = nops / op_rate * 1e3
    return dict(ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                library_ms=None if lib is None else time_ms(lib, flush),
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations")


def time_kernels(mem_rate: float, f32_rate: float):
    n, p, f = N_AGENTS, P_LENET, 1
    m = N_AGENTS - 3
    g, rx = ledger(n, p, m, seed=0)
    q, s = gradagg.quantize_int8_parts(g)
    s = s[:, 0].contiguous()
    w = s * rx.float()
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    # bytes the function must move: the received rows read once, the (P,)
    # f32 output written once (mask, scales and weights are O(n));
    # operations: f32 multiply-adds and compares per received element
    jobs = {
        "masked_cge_reduce": (
            lambda: agg.masked_cge_reduce(g, rx, f),
            lambda: agg.masked_cge_dot(g, rx, f),
            lambda: library_cge(g, rx, m - f),
            m * p * 4 + p * 4, 2 * m * p + (m - f) * p),
        "trimmed_mean_tiled": (
            lambda: agg.trimmed_mean_tiled(g, rx, f),
            lambda: agg.trimmed_mean_running(g, rx, f),
            lambda: library_trimmed(g, rx, m, f),
            m * p * 4 + p * 4, (m + 2 * f * m) * p),
        "dequant_accum": (
            lambda: agg.dequant_accum(q, s, rx),
            lambda: agg.dequant_dot(q, s, rx),
            lambda: w @ q.float(),
            m * p * 1 + p * 4, 2 * m * p),
    }
    rows = {}
    for k, (kern, plain, lib, nbytes, nops) in jobs.items():
        rows[k] = r = timing_row(kern, plain, lib, nbytes, nops, mem_rate,
                                 f32_rate, flush)
        warm = time_ms(kern)
        log(f"  {k:20s} kernel {r['ms']*1e3:7.2f} us (L2 warm "
            f"{warm*1e3:6.2f})  plain {r['plain_ms']*1e3:7.2f} us  library "
            f"{r['library_ms']*1e3:7.2f} us  bound {r['bound_ms']*1e3:5.2f} us"
            f" ({r['bound_by']}, {nbytes/1e6:.1f} MB at "
            f"{mem_rate/1e12:.2f} TB/s)")
        for kname, us in device_times(kern).items():
            log(f"      {kname:40s} {us:6.2f} us on the device (L2 warm)")
    # for scale, not a bound: one PyTorch reduction reading the same bytes
    # in the same timing window, launch and ramp-up included
    rows_rx = g[rx].contiguous()
    log(f"  for scale: torch.sum over the same {rows_rx.numel() * 4 / 1e6:.1f}"
        f" MB of received rows, contiguous, "
        f"{time_ms(rows_rx.sum, flush) * 1e3:.2f} us (L2 warm "
        f"{time_ms(rows_rx.sum) * 1e3:.2f})")
    return rows


def time_many_agents(mem_rate: float):
    """Cold times of the aggregation kernels past the shared-memory sizes,
    written down, not tuned: n = 4097 (CGE lists on chip beside 8 held
    columns, the trimmed mean through one stage of 8 columns, the mask
    walked in 33 batches) and n = 16,384 (CGE lists in a device workspace
    and no held column, the trimmed mean reading rows from device
    memory), P = 20,000, about 70% of the agents received, f = 1."""
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    for n in (4097, 16_384):
        gen = torch.Generator(device="cuda").manual_seed(n)
        p = 20_000
        g = torch.randn((n, p), generator=gen, device="cuda")
        rx = torch.rand(n, generator=gen, device="cuda") > 0.3
        q, s = gradagg.quantize_int8_parts(g)
        s = s[:, 0].contiguous()
        m = int(rx.sum())
        f32_bytes, i8_bytes = m * p * 4 + p * 4, m * p + p * 4
        times = {k: time_ms(fn, flush, reps=10, warmup=1) for k, fn in (
            ("masked_cge_reduce", lambda: agg.masked_cge_reduce(g, rx, 1)),
            ("trimmed_mean_tiled", lambda: agg.trimmed_mean_tiled(g, rx, 1)),
            ("dequant_accum", lambda: agg.dequant_accum(q, s, rx)))}
        log(f"  n={n} P={p} m={m} f=1 (cold, not tuned): masked_cge_reduce "
            f"{times['masked_cge_reduce'] * 1e3:.2f} us, trimmed_mean_tiled "
            f"{times['trimmed_mean_tiled'] * 1e3:.2f} us (bound "
            f"{f32_bytes / mem_rate * 1e6:.2f} us each), dequant_accum "
            f"{times['dequant_accum'] * 1e3:.2f} us (bound "
            f"{i8_bytes / mem_rate * 1e6:.2f} us)")
        del g, q


def device_times(fn, calls: int = 20):
    """Mean device time per call of each CUDA kernel ``fn`` launches
    (torch.profiler, after warm-up; inputs warm in L2)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


# ---------------------------------------------------------------------------
# 3b. the paged flash-decode against its plain form, and its times


# (B, H, Hkv, D, Dv, page_size, Pmax, num_pages); the first is the
# serving path's own shape (qwen2-0.5b, phase 6)
DECODE_SHAPES = {
    "qwen2-0.5b": (8, 14, 2, 64, 64, 16, 48, 8 * 48 + 1),
    "qwen2-1.5b": (8, 12, 2, 128, 128, 16, 12, 8 * 12 + 1),
    "yi-6b": (4, 32, 4, 128, 128, 16, 12, 4 * 12 + 1),
    # phase 11's serving shapes: 4 slots, 17 pages of 16 tokens
    "jamba": (4, 32, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "qwen2-vl-2b": (4, 12, 2, 128, 128, 16, 17, 4 * 17 + 1),
    "arctic": (4, 56, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "dv_ne_d": (3, 2, 2, 128, 64, 8, 4, 16),
    "ps128": (2, 2, 1, 32, 32, 128, 2, 8),
    "pmax1": (2, 4, 2, 32, 32, 8, 1, 16),
}
# f32: tile-wise online softmax against one softmax, sums in another
# order; bf16: one rounding of the output (2^-7 relative, values of order 1)
DECODE_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def decode_inputs(shape, dtype, lens=None, seed=0):
    b, h, hkv, d, dv, ps, pmax, npg = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(npg, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(npg, ps, hkv, dv)).astype(np.float32)
    tbl = (rng.permutation(npg - 1)[: b * pmax] + 1).reshape(b, pmax)
    if lens is None:
        lens = rng.integers(1, pmax * ps + 1, size=b)
    return ([torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v)]
            + [torch.tensor(tbl, dtype=torch.int32, device="cuda"),
               torch.tensor(lens, dtype=torch.int32, device="cuda")])


def split_plan(shape):
    b, _, hkv, _, _, ps, pmax, _ = shape
    return dattn.split_plan(b, hkv, pmax, ps, torch.cuda.get_device_properties(
        0).multi_processor_count)


def check_decode_kernel():
    errs = []
    for name, shape in DECODE_SHAPES.items():
        b, _, hkv, _, _, ps, pmax, _ = shape
        n_split, per = split_plan(shape)
        log(f"  paged_flash_decode {name}: split plan {n_split} splits of "
            f"{per} pages ({per * ps} tokens), {b * hkv * n_split} blocks")
        for dtype in (torch.float32, torch.bfloat16):
            for kind, lens in (("ragged", None),
                               ("full", np.full(b, pmax * ps))):
                args = decode_inputs(shape, dtype, lens)
                out = dattn.paged_flash_decode(*args)
                e = check(f"paged_flash_decode {name} {dtype} {kind}", out,
                          dattn.paged_decode_plain(*args),
                          DECODE_TOL[dtype], errs)
                if not torch.equal(dattn.paged_flash_decode(*args), out):
                    raise AssertionError(f"paged_flash_decode {name} "
                                         "differs run to run")
                log(f"  paged_flash_decode {name:11s} {str(dtype)[6:]:9s} "
                    f"{kind:6s} max_abs_err={e:.3e}, run to run identical")
    # kv_len 0, one token, on a page boundary, one past it, the full
    # table, more than the table holds
    lens = np.array([0, 1, 16, 17, 96, 500])
    used = -(-np.maximum(lens, 1) // 16)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tbl, ln = decode_inputs((6, 14, 2, 64, 64, 16, 6, 64),
                                         dtype, lens, seed=3)
        out = dattn.paged_flash_decode(q, k, v, tbl, ln)
        check(f"paged_flash_decode edge lengths {dtype}", out,
              dattn.paged_decode_plain(q, k, v, tbl, ln), DECODE_TOL[dtype],
              errs)
        if not torch.equal(out[0], torch.zeros_like(out[0])):
            raise AssertionError("kv_len = 0 must give exact zeros")
        for fill in (-1, 5):
            stale = tbl.clone()
            for i, u in enumerate(used):
                stale[i, min(u, 6):] = fill
            if not torch.equal(dattn.paged_flash_decode(q, k, v, stale, ln),
                               out):
                raise AssertionError(f"table entries {fill} past the "
                                     "length changed the output")
    log("  edge cases kv_len 0 (exact zeros), 1, 16, 17, 96, 500; -1 and "
        "stale entries past the length (bit-identical): ok")
    # a 4096-token table over many splits: one token, one split exactly,
    # one split plus a token, the whole table; and run-to-run identity
    shape = (2, 14, 2, 64, 64, 16, 256, 2 * 256 + 1)
    n_split, per = split_plan(shape)
    for dtype in (torch.float32, torch.bfloat16):
        for lens in ([1, per * 16], [per * 16 + 1, 4096]):
            args = decode_inputs(shape, dtype, np.array(lens), seed=5)
            out = dattn.paged_flash_decode(*args)
            check(f"paged_flash_decode long {dtype} {lens}", out,
                  dattn.paged_decode_plain(*args), DECODE_TOL[dtype], errs)
            if not torch.equal(dattn.paged_flash_decode(*args), out):
                raise AssertionError("paged_flash_decode differs run to run")
    log(f"  long context (Pmax = 256, {n_split} splits of {per} pages): "
        f"lengths 1, {per * 16}, {per * 16 + 1}, 4096 within the limits, "
        "run to run identical: ok")
    torch.cuda.synchronize()
    return max(errs)


def library_decode(q, k_pages, v_pages, tbl_used, mask):
    """One PyTorch composite for the same function (timed only): gather
    the used pages, then scaled_dot_product_attention with the length
    mask and grouped KV heads."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    k = k_pages[tbl_used].reshape(b, -1, hkv, d).transpose(1, 2)
    v = v_pages[tbl_used].reshape(b, -1, hkv, v_pages.shape[-1])
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v.transpose(1, 2), attn_mask=mask[:, None, None],
        enable_gqa=True)[:, :, 0]


def time_decode_kernel(mem_rate: float, f32_rate: float):
    """The kernel at the serving path's shape (qwen2-0.5b, 8 slots, bf16)
    and lengths like phase 6's (prompts of 64-512 plus up to 64 new
    tokens). Bound: the valid tokens' K and V rows read once plus q and
    out, over the memory rate; operations: the f32 multiply-adds of the valid
    tokens' scores and weighted values."""
    shape = DECODE_SHAPES["qwen2-0.5b"]
    b, h, hkv, d, dv, ps, pmax, _ = shape
    n_split, per = split_plan(shape)
    lens = np.random.default_rng(1).integers(64, 577, size=b)
    args = decode_inputs(shape, torch.bfloat16, lens, seed=1)
    q, k, v, tbl, ln = args
    used = -(-lens // ps)
    tbl_used = tbl[:, :used.max()].long()
    mask = (torch.arange(used.max() * ps, device="cuda")[None]
            < ln.long()[:, None])
    nbytes = int(lens.sum()) * hkv * (d + dv) * 2 + 2 * b * h * (d + dv)
    nops = 2 * int(lens.sum()) * h * (d + dv)
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    r = timing_row(lambda: dattn.paged_flash_decode(*args),
                   lambda: dattn.paged_decode_plain(*args),
                   lambda: library_decode(q, k, v, tbl_used, mask),
                   nbytes, nops, mem_rate, f32_rate, flush)
    warm = time_ms(lambda: dattn.paged_flash_decode(*args))
    log(f"  {'paged_flash_decode':20s} kernel {r['ms']*1e3:7.2f} us (L2 warm "
        f"{warm*1e3:6.2f})  plain {r['plain_ms']*1e3:7.2f} us  library "
        f"{r['library_ms']*1e3:7.2f} us  bound {r['bound_ms']*1e3:5.2f} us "
        f"({r['bound_by']}, {nbytes/1e6:.2f} MB at {mem_rate/1e12:.2f} TB/s;"
        f" lens {lens.tolist()}; {n_split} splits of {per} pages)")
    log(f"      kernel {r['ms'] / r['library_ms']:.2f}x the gather + SDPA "
        "composite's time")
    for kname, us in device_times(
            lambda: dattn.paged_flash_decode(*args)).items():
        log(f"      {kname:40s} {us:6.2f} us on the device (L2 warm)")
    log("      (the combine starts during the split kernel and waits for "
        "it: its span includes the wait)")
    return r


# ---------------------------------------------------------------------------
# 3c. flash attention and the CGE bucketed passes against their plain
#     forms, and their times


# phase 8's shapes: qwen2-0.5b's layer 0 over a 4096-token prompt (B, H,
# S, T, D, Dv), yi-6b's head shape, and the qwen2-0.5b parameter tree
# bucketed into rows of 2048
FLASH_QWEN = (1, 14, 4096, 4096, 64, 64)
FLASH_YI = (1, 32, 4096, 4096, 128, 128)
TREE_ROWS = (241_227, 2048)


def flash_inputs(shape, dtype, mult=1.0, seed=0):
    b, h, s, t, d, dv = shape[:6]
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, h, s, d)) * mult,
              rng.normal(size=(b, h, t, d)) * mult,
              rng.normal(size=(b, h, t, dv)))
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for a in arrays]


def check_flash_kernel():
    errs = {torch.float32: [], torch.bfloat16: []}
    for case in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, case[6])
            for causal in (True, False):
                e = check(f"flash_attention {case} {dtype} causal={causal}",
                          fattn.flash_attention(q, k, v, causal=causal),
                          fattn.flash_attention_plain(q, k, v, causal=causal),
                          FLASH_TOL[dtype], errs[dtype])
            log(f"  flash_attention {str(case[:6]):30s} x{case[6]:<3} "
                f"{str(dtype)[6:]:9s} max_abs_err={e:.3e} (causal and not)")
    torch.cuda.synchronize()
    log(f"  flash_attention: f32 max_abs_err {max(errs[torch.float32]):.3e}"
        f" ({FLASH_TOL[torch.float32]}), bf16 "
        f"{max(errs[torch.bfloat16]):.3e} ({FLASH_TOL[torch.bfloat16]})")
    return max(max(v) for v in errs.values())


def check_cge_norm_kernels():
    errs = []
    for n, w in CGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(n * w)
            x = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)
                                 ).to("cuda", dtype)
            norms = cgen.block_sq_norms(x)
            e = check(f"block_sq_norms {n}x{w} {dtype}", norms,
                      cgen.block_sq_norms_plain(x), NORM_TOL, errs)
            if not torch.equal(cgen.block_sq_norms(x), norms):
                raise AssertionError("block_sq_norms differs run to run")
            for scale in (rng.uniform(size=n), np.zeros(n), np.ones(n)):
                s = torch.tensor(scale, dtype=torch.float32, device="cuda")
                if not torch.equal(cgen.masked_scale(x, s),
                                   cgen.masked_scale_plain(x, s)):
                    raise AssertionError(f"masked_scale {n}x{w} {dtype} is "
                                         "not bit-identical")
            log(f"  block_sq_norms {n}x{w:<5d} {str(dtype)[6:]:9s} "
                f"max_abs_err={e:.3e} (rtol 1e-5), run to run identical; "
                "masked_scale bit-identical (uniform, 0, 1)")
    torch.cuda.synchronize()
    return {"block_sq_norms": max(errs), "masked_scale": 0.0}


def flash_work(shape, causal, elt):
    """(bytes, operations) flash attention must move and do: q, k, v read
    once and the output written once; 2 (D + Dv) operations per (query,
    key) pair the mask lets through."""
    b, h, s, t, d, dv = shape
    if causal:
        pairs = t * (t + 1) // 2 + (s - t) * t if s > t else s * (s + 1) // 2
    else:
        pairs = s * t
    return (b * h * (s * d + t * d + t * dv + s * dv) * elt,
            2 * (d + dv) * pairs * b * h)


def log_row(name, r, what, kern):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms'] * 1e3:9.2f} us")
    log(f"  {name:20s} kernel {r['ms'] * 1e3:9.2f} us  plain "
        f"{r['plain_ms'] * 1e3:9.2f} us  library {lib}  bound "
        f"{r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']}; {what})")
    for kname, us in device_times(kern, calls=5).items():
        log(f"      {kname:40s} {us:9.2f} us on the device (L2 warm)")


def time_new_kernels(mem_rate, f32_rate, bf16_rate):
    """Flash attention (bf16, causal) at qwen2-0.5b's and yi-6b's
    long-prompt head shapes, the squared norms and the masked scaling on
    the qwen2-0.5b tree's 241,227 rows of 2048 bf16; seed-0 inputs."""
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = {}
    for label, shape in (("qwen2-0.5b", FLASH_QWEN), ("yi-6b", FLASH_YI)):
        q, k, v = flash_inputs(shape, torch.bfloat16)
        nbytes, nops = flash_work(shape, True, 2)
        kern = lambda: fattn.flash_attention(q, k, v)  # noqa: E731
        r = timing_row(
            kern, lambda: fattn.flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            nbytes, nops, mem_rate, bf16_rate, flush)
        log_row("flash_attention", r, f"{label} {shape} bf16 causal, "
                f"{nops / 1e9:.2f} GFLOP at {bf16_rate / 1e12:.0f} TFLOP/s, "
                f"{nbytes / 1e6:.1f} MB", kern)
        log(f"      achieved {nops / r['ms'] / 1e9:.2f} TFLOP/s on the tensor "
            f"cores, SDPA {nops / r['library_ms'] / 1e9:.2f} TFLOP/s; kernel "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA's time, "
            f"{r['ms'] / r['bound_ms']:.2f}x its bound")
        if label == "qwen2-0.5b":
            rows["flash_attention"] = r
        del q, k, v
    n, w = TREE_ROWS
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, w), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    s = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    kern = lambda: cgen.block_sq_norms(x)  # noqa: E731
    rows["block_sq_norms"] = r = timing_row(
        kern, lambda: cgen.block_sq_norms_plain(x),
        lambda: torch.linalg.vector_norm(x, dim=1, dtype=torch.float32),
        n * w * 2 + n * 4, 2 * n * w, mem_rate, f32_rate, flush)
    log_row("block_sq_norms", r, f"{n} x {w} bf16, {(n * w * 2 + n * 4) / 1e6:.2f}"
            f" MB at {mem_rate / 1e12:.2f} TB/s", kern)
    # one torch.mul computes x * s in f32 and rounds once into x's dtype,
    # the same function bit for bit
    o = torch.empty_like(x)
    lib = lambda: torch.mul(x, s[:, None], out=o)  # noqa: E731
    kern = lambda: cgen.masked_scale(x, s)  # noqa: E731
    if not torch.equal(lib(), kern()):
        raise AssertionError("torch.mul is not masked_scale's function")
    rows["masked_scale"] = r = timing_row(
        kern, lambda: cgen.masked_scale_plain(x, s), lib,
        2 * n * w * 2 + n * 4, n * w, mem_rate, f32_rate, flush)
    log_row("masked_scale", r, f"{n} x {w} bf16, {(2 * n * w * 2 + n * 4) / 1e6:.2f}"
            f" MB at {mem_rate / 1e12:.2f} TB/s", kern)
    return rows


# ---------------------------------------------------------------------------
# 4. the main path


RUNS = [  # (label, kernel, cfg overrides)
    ("mean fresh r=3", None, dict(rule="mean", r=3)),
    ("cge fresh f=1 sign_flip", "masked_cge_reduce",
     dict(rule="cge", r=3, f=1, byz_ids=(4,), attack="sign_flip")),
    ("trimmed_mean stale tau=2 f=1", "trimmed_mean_tiled",
     dict(rule="trimmed_mean", mode="stale", tau=2, r=3, f=1)),
    ("quantized fresh r=3", "dequant_accum", dict(rule="quantized", r=3)),
]
LAUNCHES_PER_CALL = {"masked_cge_reduce": 1, "trimmed_mean_tiled": 1,
                     "dequant_accum": 1}
EVENT_FIELDS = ("n_rx", "max_age", "comm_time", "wall", "bytes_tx")


def make_server(sets, test, flat0, backend, overrides):
    grad_fn, _, unravel = lenet.make_agent_grad_fn(sets, 32, device="cuda",
                                                   flat0=flat0)
    tx = torch.as_tensor(test.x[:512], device="cuda")
    ty = torch.as_tensor(test.y[:512], device="cuda")
    ones = torch.ones(len(ty), device="cuda")

    def loss_fn(x):
        with torch.no_grad():
            flat = torch.as_tensor(np.asarray(x, np.float32), device="cuda")
            return classifier_loss(lenet.apply_lenet(unravel(flat), tx), ty,
                                   ones).item()

    cfg = EngineConfig(n_agents=N_AGENTS, step_size=lambda t: 0.05,
                       proj_gamma=1e6, seed=0, agg_backend=backend,
                       device="cuda", **overrides)
    srv = AsyncDGDServer(grad_fn, np.asarray(flat0), cfg,
                         latency=default_latency(N_AGENTS, 3, 10.0, seed=0),
                         loss_fn=loss_fn)
    return srv, grad_fn, cfg


def drive_main_path(half: int):
    train, test = mnist_like(n_train=4000, n_test=512, seed=0)
    sets = partition(train, N_AGENTS, overlap=2, seed=0)
    grad_fn, flat0, _ = lenet.make_agent_grad_fn(sets, 32, device="cuda")
    if flat0.device.type != "cuda" or flat0.numel() != P_LENET:
        raise AssertionError(f"LeNet has {flat0.numel()} parameters on "
                             f"{flat0.device}")
    flat0 = flat0.cpu().numpy()
    grad_fn(0, flat0, None)                  # cuDNN/cuBLAS set-up, untimed
    agg.reset_launches()
    t_main = time.perf_counter()
    for label, kernel, overrides in RUNS:
        before = dict(agg.LAUNCHES)
        t0 = time.perf_counter()
        srv, grad_fn, cfg = make_server(sets, test, flat0, "device",
                                        overrides)
        srv.run(1)
        x_1 = srv.x.copy()
        srv.run(half - 1)
        snap = srv.snapshot()
        streams = [r.bit_generator.state for r in grad_fn.rngs]
        srv.run(half)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        x_a, hist_a = srv.x.copy(), dataclasses.asdict(srv.engine.hist)
        ledger_a = srv.engine.ledger_host()
        srv.restore(snap, cfg)
        for r, st in zip(grad_fn.rngs, streams):
            r.bit_generator.state = st
        srv.run(half)
        if not (np.array_equal(srv.x, x_a)
                and np.array_equal(srv.engine.ledger_host(), ledger_a)
                and dataclasses.asdict(srv.engine.hist) == hist_a):
            raise AssertionError(f"{label}: snapshot -> restore -> run "
                                 "is not bit-identical")
        losses = np.asarray(hist_a["loss"])
        if not (losses.size == 2 * half and np.isfinite(losses).all()
                and np.isfinite(x_a).all() and x_a.shape == (P_LENET,)):
            raise AssertionError(f"{label}: non-finite or misshapen output")
        # the host conformance pipeline on the card: same agents, same
        # events, the reference rule op by op. After one step the two differ
        # only by f32 summation order (the tests' tolerance). Later steps
        # feed that back through LeNet's gradients, and for the quantized
        # rule through int8 rounding, which can flip by one step, so the
        # end of the run is held to a relative distance and the losses.
        ref, _, _ = make_server(sets, test, flat0, "host", overrides)
        ref.run(1)
        np.testing.assert_allclose(x_1, np.asarray(ref.x, np.float64),
                                   rtol=1e-3, atol=1e-5, err_msg=label)
        h_ref = ref.run(2 * half - 1)
        for fld in EVENT_FIELDS:
            if getattr(h_ref, fld) != hist_a[fld]:
                raise AssertionError(f"{label}: {fld} differs from host run")
        rel = np.linalg.norm(x_a - ref.x) / np.linalg.norm(ref.x)
        if rel > 1e-3:
            raise AssertionError(f"{label}: |x - x_host| / |x_host| = {rel}")
        np.testing.assert_allclose(losses, h_ref.loss, rtol=1e-3,
                                   err_msg=label)
        if kernel is not None:
            calls = agg.LAUNCHES[kernel] - before[kernel]
            need = 3 * half * LAUNCHES_PER_CALL[kernel]
            if calls < need:
                raise AssertionError(f"{label}: {kernel} launched {calls} "
                                     f"times, expected at least {need}")
        log(f"  {label:30s} {2 * half} iters {dt:6.2f} s "
            f"({dt / (2 * half) * 1e3:7.1f} ms/iter)  loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}  "
            f"|x - x_host|/|x_host| {rel:.1e}")
    counts = dict(agg.LAUNCHES)
    log(f"  main path {time.perf_counter() - t_main:.1f} s, kernel launches "
        f"{counts}")
    for k, c in counts.items():
        if c == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return counts, (sets, test, flat0)


OUR_KERNELS = ("masked_cge_kernel", "trimmed_mean_kernel",
               "dequant_accum_kernel")


def where_time_goes(data, iters: int = 3):
    """Profile a few device-backend cge iterations: host wall time per
    iteration, the union of device activity (kernels and copies), the
    device's idle share, and the part of it that is copies and the
    aggregation kernels."""
    from torch.profiler import ProfilerActivity, profile
    srv, _, _ = make_server(*data, "device", RUNS[1][2])
    srv.run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(iters)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    per = lambda keys: sum(b - a for a, b, nm in spans  # noqa: E731
                           if any(k in nm for k in keys)) / 1e3 / iters
    busy = busy / 1e3 / iters
    log(f"  cge device backend under the profiler: {wall:.1f} ms/iter on the "
        f"host clock, device busy {busy:.2f} ms/iter (idle share "
        f"{1 - busy / wall:.3f}), copies {per(('Memcpy',)):.2f} ms, "
        f"aggregation kernels {per(OUR_KERNELS) * 1e3:.1f} us, "
        f"{len(spans) / iters:.0f} device activities per iteration")


def kernels_under(event):
    """The device kernels launched under a profiler CPU event."""
    return list(event.kernels) + [k for ch in event.cpu_children
                                  for k in kernels_under(ch)]


def where_quantized_time_goes(data, iters: int = 3):
    """Profile a few quantized device-backend iterations and split the
    aggregate step: the int8 quantization (``gradagg.quantize_int8_parts``,
    PyTorch operations over the whole (n, P) ledger, run under a
    ``record_function`` range here) against ``dequant_accum``'s kernel,
    device us per iteration each."""
    from torch.profiler import ProfilerActivity, profile, record_function
    parts = gradagg.quantize_int8_parts

    def traced(x):
        with record_function("quantize_int8_parts"):
            return parts(x)

    srv, _, _ = make_server(*data, "device", RUNS[3][2])
    srv.run(1)
    torch.cuda.synchronize()
    gradagg.quantize_int8_parts = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.run(iters)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
    finally:
        gradagg.quantize_int8_parts = parts
    quant = [k for e in prof.events() if e.name == "quantize_int8_parts"
             and e.device_type == torch.autograd.DeviceType.CPU
             for k in kernels_under(e)]
    spans = [sp for sp in device_spans(prof)     # not the range's own span
             if sp[2] != "quantize_int8_parts"]
    deq = [b - a for a, b, nm in spans if "dequant_accum_kernel" in nm]
    if not quant or not deq:
        raise AssertionError(f"quantized profile: {len(quant)} quantize "
                             f"kernels, {len(deq)} dequant launches")
    q_us = sum(k.duration for k in quant) / iters
    d_us = sum(deq) / iters
    log(f"  quantized device backend under the profiler: {wall:.1f} ms/iter "
        f"on the host clock, device busy {busy_us(spans) / 1e3 / iters:.2f} "
        f"ms/iter; aggregate step on the device per iteration: quantize "
        f"{q_us:.1f} us ({len(quant) / iters:.0f} kernels) vs dequant_accum "
        f"{d_us:.1f} us ({len(deq) / iters:.0f} launch)")
    by_name = {}
    for k in quant:
        n, us = by_name.get(k.name[:70], (0, 0.0))
        by_name[k.name[:70]] = (n + 1, us + k.duration)
    for nm, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"      {nm:70s} {n / iters:4.1f} per iter {us / iters:8.1f} us")


# ---------------------------------------------------------------------------
# 6. the serving path at full qwen2-0.5b width


SERVE_ARCH = "qwen2-0.5b"
# the decode's two CUDA kernels (split partials, combine) share this prefix
DECODE_KERNEL = "paged_decode_"
SERVE_CCFG = PagedCacheConfig(num_slots=8, page_size=16, max_pages_per_seq=48,
                              num_pages=8 * 48 + 1)
# teacher-forced decode logits, kernel against plain form, both bf16: the
# attention outputs differ by rounding (f32 sums in another order, then a
# bf16 cast), which 24 layers carry into logits of order 1 to 10, whose
# own bf16 step is 2^-7 to 2^-4
LOGIT_TOL = 0.125


class TimedEngine(ServeEngine):
    """ServeEngine with host-clock totals of its prefills and of whole
    steps. Both end in a host sync, so the clock covers the device work;
    decode time is step time minus prefill time."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prefill_s = self.step_s = 0.0

    def _admit_grouped(self, admitted):
        t0 = time.perf_counter()
        super()._admit_grouped(admitted)
        self.prefill_s += time.perf_counter() - t0

    def step(self):
        t0 = time.perf_counter()
        super().step()
        self.step_s += time.perf_counter() - t0


def serve_requests(cfg, n: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513)))
             .astype(np.int32), int(rng.integers(16, 65))) for _ in range(n)]


@torch.no_grad()
def teacher_forced_logits(params, cfg, prompts, streams, impl,
                          ccfg=SERVE_CCFG):
    """(T, B, vocab) paged-decode logits along ``streams`` (B, T) with
    attention form ``impl``: prompt i prefilled into slot i of a fresh
    cache of layout ``ccfg``, then ``streams[:, t]`` fed at step t."""
    kv = PagedKVCache(cfg, ccfg, device="cuda")
    for slot, prompt in enumerate(prompts):
        _, _, cache = apply_model(params, torch.tensor(prompt[None],
                                                       device="cuda"),
                                  cfg, mode="prefill", logits_chunk=1)
        kv.admit(slot, cache, len(prompt), len(prompt) + streams.shape[1])
    slots = list(range(len(prompts)))
    out = []
    for t in range(streams.shape[1]):
        tokens = np.zeros((ccfg.num_slots, 1), np.int32)
        tokens[slots, 0] = streams[:, t]
        logits, _, _ = apply_model(
            params, torch.tensor(tokens, device="cuda"), cfg, mode="decode",
            cache=kv.cache, cache_index=kv.kv_lens_dev,
            page_table=kv.page_table_dev, impl=impl)
        kv.commit_token(slots)
        out.append(logits[slots, 0])
    return torch.stack(out)


def run_engine(params, cfg, reqs, k, ccfg=SERVE_CCFG):
    eng = TimedEngine(params, cfg, ccfg, superstep_k=k)
    rids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    torch.cuda.synchronize()
    return eng, rids, out


def drive_serving():
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, want "
                             f"{cfg.param_count()}")
    log(f"  {SERVE_ARCH}: {n_params:,} parameters (bf16) initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    reqs = serve_requests(cfg)
    run_engine(params, cfg, serve_requests(cfg, n=2, seed=1), 8)  # warm-up

    dattn.reset_launches()
    eng, rids, out = run_engine(params, cfg, reqs, 8)
    launches = dattn.LAUNCHES["paged_flash_decode"]
    st = eng.stats
    for rid, (prompt, budget) in zip(rids, reqs):
        toks = out[rid]
        if toks.shape != (budget,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: {toks.shape} tokens, "
                                 f"budget {budget}")
    if eng.kv.alloc.n_used or not eng.kv.alloc.check_invariants():
        raise AssertionError(f"{eng.kv.alloc.n_used} pages still used")
    if launches < st["decode_steps"] * cfg.n_layers:
        raise AssertionError(f"paged_flash_decode launched {launches} times "
                             f"for {st['decode_steps']} decode steps")
    decode_s = eng.step_s - eng.prefill_s
    decode_tokens = sum(len(t) - 1 for t in out.values())
    ttft = np.mean([s.ttft for s in eng.sched.finished.values()])
    metrics = dict(decode_tok_s=decode_tokens / decode_s,
                   ms_per_superstep=decode_s / st["supersteps"] * 1e3,
                   ms_per_decode_step=decode_s / st["decode_steps"] * 1e3,
                   mean_ttft_ms=ttft * 1e3,
                   prefill_ms=eng.prefill_s / st["prefill_calls"] * 1e3)
    log(f"  24 requests, {sum(n for _, n in reqs)} tokens, superstep_k=8: "
        f"{st['decode_steps']} decode steps in {st['supersteps']} supersteps,"
        f" {st['prefill_calls']} prefill calls, {st['host_syncs']} host "
        f"syncs; paged_flash_decode launched {launches} times")
    log(f"  decode {metrics['decode_tok_s']:.1f} tok/s, "
        f"{metrics['ms_per_superstep']:.2f} ms per superstep "
        f"({metrics['ms_per_decode_step']:.2f} ms per decode step), mean "
        f"TTFT {metrics['mean_ttft_ms']:.1f} ms, prefill "
        f"{metrics['prefill_ms']:.2f} ms per call "
        f"({eng.prefill_s * 1e3:.1f} ms in all)")

    ref, ref_rids, ref_out = run_engine(params, cfg, reqs, 1)
    for a, b in zip(rids, ref_rids):
        if not np.array_equal(out[a], ref_out[b]):
            raise AssertionError(f"request {a}: superstep_k=8 and 1 differ")
    log(f"  token streams identical to the superstep_k=1 run "
        f"({ref.stats['decode_steps']} decode steps, "
        f"{ref.stats['host_syncs']} host syncs)")

    # teacher-forced logits through the kernel and the plain form
    t_len = 16
    prompts = [p for p, _ in reqs[:8]]
    streams = np.stack([out[r][:t_len] for r in rids[:8]])
    lg_k = teacher_forced_logits(params, cfg, prompts, streams,
                                 "cuda").float()
    lg_p = teacher_forced_logits(params, cfg, prompts, streams,
                                 "plain").float()
    diff = float((lg_k - lg_p).abs().max())
    top2 = lg_p.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > LOGIT_TOL
    agree = lg_k.argmax(-1) == lg_p.argmax(-1)
    log(f"  teacher-forced decode, 8 slots x {t_len} steps: max |logit "
        f"diff| {diff:.4f} (logits up to {float(lg_p.abs().max()):.2f}, "
        f"tolerance {LOGIT_TOL}); argmax agrees at {int(agree.sum())} of "
        f"{agree.numel()} positions, {int(clear.sum())} with a top-2 margin "
        "above the tolerance")
    if not torch.isfinite(lg_k).all() or diff > LOGIT_TOL or \
            not bool(agree[clear].all()):
        raise AssertionError("teacher-forced logits: kernel and plain form "
                             "disagree")

    share = kernel_share(params, cfg, reqs)
    log(f"  paged_flash_decode: {share:.3f} of device busy time over the "
        "same run (torch.profiler)")
    metrics["kernel_share"] = share
    return launches, params, metrics


def device_spans(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def busy_us(spans):
    busy, end = 0.0, -np.inf
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def decode_spans(spans):
    """The decode's device spans. The combine kernel is a programmatic
    dependent launch: it starts during the split kernel and waits there,
    so the two overlap and their time is the union of their spans."""
    return [sp for sp in spans if DECODE_KERNEL in sp[2]]


def kernel_share(params, cfg, reqs):
    """The decode kernel's share of device busy time over a replay of
    the phase-6 workload (device activities only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_engine(params, cfg, reqs, 8)
    spans = device_spans(prof)
    return busy_us(decode_spans(spans)) / busy_us(spans)


def where_serving_time_goes(params, steps: int = 3):
    """Profile a few full supersteps (8 slots, K=8): host ms per step,
    device busy time and idle share, and device activities per decode
    step."""
    cfg = get_config(SERVE_ARCH)
    eng = ServeEngine(params, cfg, SERVE_CCFG, superstep_k=8)
    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 256).astype(np.int32), 64)
    profile_decode(eng, steps)


def profile_decode(eng, steps: int, top: int = 6):
    """Run the engine's admissions and first superstep, then profile
    ``steps`` more: host ms per decode step, device busy time and idle
    share, device activities per decode step and the ``top`` activities
    by device time."""
    from torch.profiler import ProfilerActivity, profile
    eng.step()                              # admissions + first superstep
    torch.cuda.synchronize()
    k0 = eng.stats["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n_dec = eng.stats["decode_steps"] - k0
    spans = device_spans(prof)
    busy = busy_us(spans) / 1e3
    mine = busy_us(decode_spans(spans))
    log(f"  {steps} supersteps ({n_dec} decode steps) under the profiler: "
        f"{wall / n_dec:.2f} ms per decode step on the host clock, device "
        f"busy {busy / n_dec:.3f} ms per decode step (idle share "
        f"{1 - busy / wall:.3f}), {len(spans) / n_dec:.0f} device "
        f"activities per decode step, paged_flash_decode "
        f"{mine / n_dec:.1f} us per decode step")
    by_name = {}
    for a, b, nm in spans:
        n, us = by_name.get(nm[:60], (0, 0.0))
        by_name[nm[:60]] = (n + 1, us + b - a)
    for nm, (n, us) in sorted(by_name.items(),
                              key=lambda kv: -kv[1][1])[:top]:
        log(f"      {nm:60s} {n / n_dec:5.1f} per step {us / n_dec:8.1f} us"
            " per step")


# ---------------------------------------------------------------------------
# 8. the kernels API at full width


FLASH_PROMPT = 4096
# ops.flash_attention (f32 inside, one bf16 rounding of the output) against
# the model's chunked attention, which rounds p to bf16 and carries its
# accumulator in bf16 across its 4 chunks of 1024 keys: outputs of order 1
# differ by a few bf16 steps, the whole output by about 2^-8 in L2
CHUNKED_BOUND = 5e-2
CHUNKED_REL_L2 = 2e-2
TOTAL_RTOL = 1e-5       # the norms' f32 total against an f64 sum of squares


@torch.no_grad()
def layer0_qkv(params, cfg, n_tokens):
    """Layer 0's q, k, v over a seed-0 prompt, through the model's own
    embedding, norm, projections and RoPE, with the KV heads expanded as
    ``apply_gqa`` does: (B, S, H, hd) bf16 each."""
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, n_tokens)[None], device="cuda")
    layer = mmodel._unstack(params["blocks"][0], cfg.n_periods)[0]
    x = mlayers.embed_tokens(params["embed"], tokens, cfg)
    h = mlayers.apply_norm(layer["norm1"], x, cfg)
    q = mattn._proj_q(layer["mixer"], h, cfg)
    k, v = mattn._proj_kv(layer["mixer"], h, cfg)
    pos = mmodel._positions_for(cfg, 1, n_tokens, 0, tokens.device)
    rope = mlayers.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q, k = mlayers.rotate(q, *rope), mlayers.rotate(k, *rope)
    g = cfg.n_heads // cfg.n_kv_heads
    return (q, torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


@torch.no_grad()
def flash_on_activations(params, cfg):
    q, k, v = layer0_qkv(params, cfg, FLASH_PROMPT)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    plain = fattn.flash_attention_plain(qt, kt, vt, causal=True)
    e = check("ops.flash_attention on layer 0", out, plain,
              FLASH_TOL[torch.bfloat16], [])
    chunked = mattn.chunked_attention(q, k, v, causal=True).transpose(1, 2)
    delta = out.float() - chunked.float()
    diff = float(delta.abs().max())
    rel = float(delta.norm() / chunked.float().norm())
    mag = plain.float().abs()
    log(f"  flash attention, qwen2-0.5b layer 0, {FLASH_PROMPT}-token prompt "
        f"{tuple(qt.shape)} {str(qt.dtype)[6:]} causal: kernel vs plain form "
        f"max_abs_err {e:.3e} ({FLASH_TOL[torch.bfloat16]}); vs the model's "
        f"chunked attention max {diff:.3e} (bound {CHUNKED_BOUND}), relative "
        f"L2 {rel:.3e} (bound {CHUNKED_REL_L2}); |out| median "
        f"{float(mag.median()):.4f}, max {float(mag.max()):.3f}")
    if diff > CHUNKED_BOUND or rel > CHUNKED_REL_L2:
        raise AssertionError(f"flash attention and chunked attention differ "
                             f"by {diff} (max), {rel} (relative L2)")


@torch.no_grad()
def norms_over_tree(params):
    rows, n = ops.tree_bucket(params)
    if rows.shape != TREE_ROWS or n != 494_032_768:
        raise AssertionError(f"tree_bucket gave {tuple(rows.shape)}, {n}")
    norms = ops.block_sq_norms(rows)
    e = check("ops.block_sq_norms on the qwen2-0.5b tree", norms,
              cgen.block_sq_norms_plain(rows), NORM_TOL, [])
    total = float(norms.double().sum())
    want = sum(float(t.to(torch.bfloat16).double().square().sum())
               for t in tree_flatten(params)[0])
    rel = abs(total - want) / want
    scale = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, rows.shape[0]).astype(np.float32)).cuda()
    same = torch.equal(ops.masked_scale(rows, scale),
                       cgen.masked_scale_plain(rows, scale))
    log(f"  qwen2-0.5b tree: {n:,} parameters -> {rows.shape[0]:,} rows x "
        f"{rows.shape[1]} bf16 ({rows.numel() * 2 / 1e6:.2f} MB); squared "
        f"norms vs plain max_abs_err {e:.3e} (rtol 1e-5), total {total:.6e} "
        f"vs f64 {want:.6e} (relative {rel:.1e}, limit {TOTAL_RTOL}); "
        f"masked_scale (keep/drop per row) bit-identical: {same}")
    if rel > TOTAL_RTOL or not same:
        raise AssertionError("norms or masked_scale over the tree are wrong")


def keepset_on_lenet(data):
    """One cge iteration of phase 4's run (20 agents, one sign-flip, f=1):
    the ledger's gradients bucketed through ``tree_bucket`` of each
    agent's LeNet parameter dict, per-agent squared norms as the sum of
    its 211 bucket norms, and the CGE keep-set from their square roots."""
    overrides = RUNS[1][2]
    srv, _, _ = make_server(*data, "device", overrides)
    seen = []
    step = srv.engine._device_step

    def spy(received, eta):
        seen.append(received.copy())
        step(received, eta)

    srv.engine._device_step = spy
    srv.run(1)
    g = torch.from_numpy(srv.engine.ledger_host()).cuda()
    rx = torch.from_numpy(seen[0]).cuda()
    f = overrides["f"]
    layout = lenet.lenet_layout()
    rows = torch.cat([ops.tree_bucket(layout.unflatten(g[j]))[0]
                      for j in range(N_AGENTS)])
    per = rows.shape[0] // N_AGENTS
    sq = ops.block_sq_norms(rows).view(N_AGENTS, per).sum(1)
    sq_plain = cgen.block_sq_norms_plain(rows).view(N_AGENTS, per).sum(1)
    keep = gradagg.cge_mask_from_norms(sq.sqrt(), rx, f)
    keep_plain = gradagg.cge_mask_from_norms(sq_plain.sqrt(), rx, f)
    f32_norms = agg.row_norms(g)
    keep_f32 = gradagg.cge_mask_from_norms(f32_norms, rx, f)
    rel = ((sq.sqrt() - f32_norms).abs() / f32_norms)[rx]
    srt = torch.sort(f32_norms[rx]).values
    m = int(rx.sum())
    gap = float((srt[m - f] - srt[m - f - 1]) / srt[m - f - 1])
    log(f"  LeNet cge iteration: {m} of {N_AGENTS} received, f={f}, "
        f"{per} rows of 2048 per agent; keep-set from kernel norms equals "
        f"the plain form's: {torch.equal(keep, keep_plain)}; equals the f32 "
        f"ledger's: {torch.equal(keep, keep_f32)} (bf16 bucketing moves a "
        f"norm by at most {float(rel.max()):.2e} relative; the f32 norms "
        f"at the keep boundary are {gap:.2e} apart, relative)")
    if not torch.equal(keep, keep_plain):
        raise AssertionError("keep-set from kernel norms differs from the "
                             "plain form's")
    if not torch.equal(keep, keep_f32) and gap > 2 * float(rel.max()):
        raise AssertionError("bf16 keep-set differs beyond the bucketing's "
                             "relative error")


def drive_kernels_api(params, data):
    cfg = get_config(SERVE_ARCH)
    fattn.reset_launches()
    cgen.reset_launches()
    t0 = time.perf_counter()
    flash_on_activations(params, cfg)
    norms_over_tree(params)
    keepset_on_lenet(data)
    torch.cuda.synchronize()
    counts = {**fattn.LAUNCHES, **cgen.LAUNCHES}
    log(f"  phase 8 in {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{counts}")
    for k, c in counts.items():
        if c == 0:
            raise AssertionError(f"{k} was not launched in phase 8")
    return counts


# ---------------------------------------------------------------------------
# 9. the simulator on the card


# trace fields from numpy event logic and the transport's own stream:
# identical on every device; loss and dist come from an f32 rule whose
# reduction order is the device's (tests/test_torch_engine.py tolerances)
SIM_EXACT = ("t", "n_rx", "r", "comm", "stale", "amax")
SIM_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
SIM_DIST_TOL = dict(rtol=1e-3, atol=1e-5)
# the two scenarios run again on the device backend: CGE under two attack
# switches, and the stale rule through a crash/recover wave
SIM_DEVICE_RUNS = ("byzantine_flip_midrun", "rolling_restart")


def check_sim_train(label, rep, ref):
    """``rep`` (card) against ``ref`` (CPU, same process): no violation,
    the discrete fields identical, loss and dist within tolerance."""
    if rep.violations or ref.violations:
        raise AssertionError(f"{label}: violations "
                             f"{summarize(rep.violations + ref.violations)}")
    for key in SIM_EXACT:
        if [st[key] for st in rep.trace] != [st[key] for st in ref.trace]:
            raise AssertionError(f"{label}: trace field {key} differs from "
                                 "the CPU run")
    if (rep.hist.bytes_tx, rep.transport.drops, rep.transport.dups) != \
            (ref.hist.bytes_tx, ref.transport.drops, ref.transport.dups):
        raise AssertionError(f"{label}: bytes_tx, drops or dups differ")
    np.testing.assert_allclose([st["loss"] for st in rep.trace],
                               [st["loss"] for st in ref.trace],
                               err_msg=label, **SIM_LOSS_TOL)
    np.testing.assert_allclose([st["dist"] for st in rep.trace],
                               [st["dist"] for st in ref.trace],
                               err_msg=label, **SIM_DIST_TOL)


def log_sim_train(label, rep, dt):
    sc = rep.scenario
    dist = rep.hist.dist[-1]
    if sc.expect.check_envelope:
        limit = (f"envelope radius "
                 f"{rep.envelope.radius(sc.expect.envelope_slack):.4g}")
    else:
        limit = f"max_dist {sc.expect.max_dist}"
    log(f"  {label:36s} {sc.iters} iters {dt:6.2f} s "
        f"({sc.iters / dt:7.1f} it/s)  ||x - x*|| {dist:.4g} vs {limit}, "
        f"drops {rep.transport.drops}, dups {rep.transport.dups}")


def drive_simulator():
    """Every registered scenario's ``run_train`` on the card (host
    backend) against the same run on the CPU, its ``run_serve``, then
    ``SIM_DEVICE_RUNS`` on the device backend. The aggregation kernels'
    counts are zeroed just before and read just after."""
    agg.reset_launches()
    t_all = time.perf_counter()
    on_cpu = {}
    for name in sorted(SCENARIOS):
        sc = get_scenario(name)
        t0 = time.perf_counter()
        rep = run_train(sc, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        on_cpu[name] = run_train(sc, device="cpu")
        check_sim_train(name, rep, on_cpu[name])
        log_sim_train(f"{name} (host)", rep, dt)
        served = run_serve(sc)
        if served.violations or len(served.trace) != sc.n_requests or \
                not np.isfinite(served.latencies).all():
            raise AssertionError(f"{name} serve: {len(served.trace)} "
                                 f"requests, violations "
                                 f"{summarize(served.violations)}")
    for name in SIM_DEVICE_RUNS:
        sc = get_scenario(name)
        before = agg.LAUNCHES["masked_cge_reduce"]
        t0 = time.perf_counter()
        rep = run_train(sc, device="cuda", agg_backend="device")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = agg.LAUNCHES["masked_cge_reduce"] - before
        check_sim_train(f"{name} (device)", rep, on_cpu[name])
        log_sim_train(f"{name} (device)", rep, dt)
        if sc.rule == "cge" and launched < sc.iters:
            raise AssertionError(f"{name}: masked_cge_reduce launched "
                                 f"{launched} times in {sc.iters} iters")
    counts = dict(agg.LAUNCHES)
    log(f"  phase 9 in {time.perf_counter() - t_all:.1f} s: 13 scenarios "
        f"x (train on the card and the CPU, serve), {len(SIM_DEVICE_RUNS)} "
        f"on the device backend; kernel launches {counts}")
    if counts["masked_cge_reduce"] == 0:
        raise AssertionError("masked_cge_reduce was not launched in phase 9")
    return {"masked_cge_reduce": counts["masked_cge_reduce"]}


# ---------------------------------------------------------------------------
# 10. the e2e harness at full width


# (name, requests run of the scenario's): both cut to their first 16 to
# leave phases 12-14 room in the script's time
E2E_RUNS = (("e2e_steady", 16), ("crash_cascade", 16))
E2E_REPLICAS = 8


def log_quorum(row, label):
    log(f"    {label:8s} ok {row.n_ok}/{row.n_requests} degraded "
        f"{row.n_degraded} unanswered {row.n_unanswered}  goodput "
        f"{row.goodput:.4f}/unit  latency p50 {row.p50_latency:.3f} p99 "
        f"{row.p99_latency:.3f}  TTFT p50 {row.p50_ttft:.3f} p99 "
        f"{row.p99_ttft:.3f}")


@torch.no_grad()
def greedy_check(params, cfg, page_size, prompts, streams):
    """Each of ``streams`` (1-D, any lengths) against the greedy argmax
    of its logits through the plain attention form: the first token
    against the prefill's (which runs no decode kernel), the rest against
    teacher-forced decode logits, 8 streams at a time on a fresh cache
    of ``page_size``-token pages. The streams were served with prompts
    prefilled in groups, or a cached prefix and a suffix fed through
    decode; these are prefilled one at a time, so bf16 roundings differ
    and a near tie may flip: a stream must be the argmax wherever the
    top-2 margin exceeds ``LOGIT_TOL``, and the kernel's teacher-forced
    logits must be within ``LOGIT_TOL`` of the plain form's. Returns
    (max |logit diff| between the kernel and the plain form, positions
    checked, positions within the margin, positions where the stream is
    the plain argmax)."""
    diff, checked, close, same = 0.0, 0, 0, 0
    for i in range(0, len(streams), 8):
        batch, ss = prompts[i:i + 8], streams[i:i + 8]
        n = np.asarray([len(s) for s in ss])
        toks = np.zeros((len(ss), n.max()), np.int32)
        for b, s in enumerate(ss):
            toks[b, :len(s)] = s
        pages = max(-(-(len(p) + n.max()) // page_size) for p in batch)
        ccfg = PagedCacheConfig(num_slots=8, page_size=page_size,
                                max_pages_per_seq=pages,
                                num_pages=8 * pages + 1)
        first = []
        for prompt in batch:
            x, _, _ = apply_model(params, torch.tensor(prompt[None],
                                                       device="cuda"),
                                  cfg, mode="prefill", logits_chunk=1)
            first.append(mlayers.unembed(params["embed"], x[0, -1], cfg))
        lg_p = teacher_forced_logits(params, cfg, batch, toks[:, :-1],
                                     "plain", ccfg).float()
        lg_k = teacher_forced_logits(params, cfg, batch, toks[:, :-1],
                                     "cuda", ccfg).float()
        # (T, B): position t of stream b was served
        valid = torch.as_tensor(np.arange(n.max())[:, None] < n[None],
                                device="cuda")
        if n.max() > 1:
            diff = max(diff, float((lg_k - lg_p).abs()[valid[1:]].max()))
        # position 0: the prefill's logits; then the decode's, teacher forced
        lg_p = torch.cat([torch.stack(first)[None].float(), lg_p])
        top2 = lg_p.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > LOGIT_TOL) & valid
        want = torch.as_tensor(toks.T, device="cuda").long()
        agree = (lg_p.argmax(-1) == want) & valid
        if not bool(agree[clear].all()):
            raise AssertionError("a served stream leaves the plain form's "
                                 "greedy argmax at a clear margin")
        checked += int(valid.sum())
        close += int((valid & ~clear).sum())
        same += int(agree.sum())
    if diff > LOGIT_TOL:
        raise AssertionError(f"teacher-forced logits: kernel and plain "
                             f"form differ by {diff}")
    return diff, checked, close, same


def plain_greedy_check(params, cfg, ecfg, report):
    """``greedy_check`` of every delivered honest stream of ``report``."""
    done = [q for q in report.requests if q.delivered()]
    return greedy_check(params, cfg, ecfg.page_size,
                        [q.prompt for q in done],
                        [q.delivered()[0].tokens for q in done])


def drive_e2e(params):
    """``run_e2e`` on one fleet of 8 full-width qwen2-0.5b replicas over
    phase 6's weights: ``e2e_steady``, then ``crash_cascade`` cut to 16
    requests, on the same warm fleet. The decode kernel's count is
    zeroed just before each run and read just after."""
    cfg = get_config(SERVE_ARCH)
    fleet = EngineFleet(E2E_REPLICAS, params=params, cfg=cfg, device="cuda")
    ecfg = fleet.ecfg
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dattn.split_plan(ecfg.num_slots, cfg.n_kv_heads,
                            ecfg.max_pages_per_seq, ecfg.page_size, n_sm)
    log(f"  {E2E_REPLICAS} replicas of {SERVE_ARCH} (full width, one "
        f"parameter set), {ecfg.num_slots} slots, {ecfg.page_size}-token "
        f"pages, at most {ecfg.max_pages_per_seq} a sequence, superstep_k="
        f"{ecfg.superstep_k}, {ecfg.max_new_tokens} new tokens a request; "
        f"decode split plan (splits, pages a split) {plan}")
    log("  reduced: " + ", ".join(
        f"{name} {get_scenario(name).n_requests} -> {cut} requests"
        for name, cut in E2E_RUNS))
    total, results = 0, {}
    for name, cut in E2E_RUNS:
        if not fleet.drained():
            raise AssertionError(f"fleet not drained before {name}")
        sc = get_scenario(name)
        st0 = [dict(e.stats) for e in fleet.engines]
        dattn.reset_launches()
        t0 = time.perf_counter()
        rep = run_e2e(sc, fleet=fleet, n_requests=cut)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dattn.LAUNCHES["paged_flash_decode"]
        total += launches
        if rep.violations:
            raise AssertionError(f"{name}: {summarize(rep.violations)}")
        if not fleet.drained():
            raise AssertionError(f"{name}: fleet not drained after the run")
        dec = [e.stats["decode_steps"] - s["decode_steps"]
               for e, s in zip(fleet.engines, st0)]
        sup = [e.stats["supersteps"] - s["supersteps"]
               for e, s in zip(fleet.engines, st0)]
        pre = [e.stats["prefill_calls"] - s["prefill_calls"]
               for e, s in zip(fleet.engines, st0)]
        if launches == 0 or launches < sum(dec) * cfg.n_layers:
            raise AssertionError(f"{name}: paged_flash_decode launched "
                                 f"{launches} times for {sum(dec)} decode "
                                 "steps")
        lost = sum(c.status != "delivered" for q in rep.requests
                   for c in q.copies.values())
        log(f"  {name}: {len(rep.requests)} requests in {dt:.1f} s on the "
            f"host clock; paged_flash_decode launched {launches} times; per "
            f"replica decode steps {dec}, supersteps {sup}, prefill calls "
            f"{pre}; retries {sum(q.retries for q in rep.requests)}, copies "
            f"lost or dropped {lost}")
        log_quorum(rep.native, "native")
        for r, row in sorted(rep.sweep.items()):
            log_quorum(row, f"r={r}")
        results[name] = rep
    diff, checked, close, same = plain_greedy_check(params, cfg, ecfg,
                                                    results["e2e_steady"])
    log(f"  e2e_steady: delivered streams vs the plain form's greedy "
        f"argmax: equal at {same} of {checked} positions ({close} with a "
        f"top-2 margin within {LOGIT_TOL}); max |teacher-forced logit "
        f"diff| kernel vs plain {diff:.4f}")
    return {"paged_flash_decode": total}, fleet


# ---------------------------------------------------------------------------
# 11. the other model families at full width


# (arch, layers run): one whole period of jamba's pattern, deepseek-v2
# and arctic cut in depth to fit 80 GB with their serving state, rwkv6-3b
# and qwen2-vl-2b whole
FAMILY_RUNS = (("jamba-v0.1-52b", 8), ("deepseek-v2-236b", 2),
               ("arctic-480b", 1), ("rwkv6-3b", 32), ("qwen2-vl-2b", 28))
FAMILY_CCFG = PagedCacheConfig(num_slots=4, page_size=16,
                               max_pages_per_seq=17, num_pages=4 * 17 + 1)
TWIN_ARCHS = ("arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b",
              "rwkv6-3b", "qwen2-vl-2b", "whisper-base")
# f32 on the card against f32 on the CPU: the same operations, reductions
# in another order (and the Mamba scan's f32 state carried over steps)
TWIN_TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER_DECODE_STEPS = 16


def family_requests(cfg, n: int = 8, seed: int = 0):
    """Prompts of 16-256 tokens (never 2, never above 256: the Mamba
    scan's chunk rule), 8-16 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
             .astype(np.int32), int(rng.integers(8, 17))) for _ in range(n)]


def gqa_layers(cfg) -> int:
    if cfg.attention != "gqa":
        return 0
    return cfg.layer_pattern.count("attn") * cfg.n_periods


def serve_family(name: str, depth: int):
    """One config at full width, ``depth`` layers, bf16 weights from seed
    0 made on the card: ``ServeEngine`` (4 slots, 16-token pages,
    superstep_k = 4) serves 8 requests; every budget met and every page
    back, streams equal to a superstep_k = 1 run's, the decode kernel
    launched exactly once per GQA layer and decode step (zero without
    GQA layers), and for GQA configs teacher-forced decode logits through
    the kernel within ``LOGIT_TOL`` of the plain form's. Returns the
    kernel's launches in the superstep_k = 4 run."""
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=depth)
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves = tree_flatten(params)[0]
    n_params = sum(t.numel() for t in leaves)
    if n_params != cfg.param_count():
        raise AssertionError(f"{name}: {n_params} parameters, want "
                             f"{cfg.param_count()}")
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    cut = ("none" if depth == full.n_layers
           else f"n_layers {full.n_layers} -> {depth}")
    dtypes = "/".join(sorted({str(t.dtype)[6:] for t in leaves}))
    log(f"  {name}: {n_params:,} parameters ({gb:.2f} GB, {dtypes}) made on "
        f"the card in {load_s:.1f} s; reduced: {cut}")
    reqs = family_requests(cfg)
    dattn.reset_launches()
    eng, rids, out = run_engine(params, cfg, reqs, 4, FAMILY_CCFG)
    launches = dattn.LAUNCHES["paged_flash_decode"]
    st = eng.stats
    for rid, (_, budget) in zip(rids, reqs):
        toks = out[rid]
        if toks.shape != (budget,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{name} request {rid}: {toks.shape} "
                                 f"tokens, budget {budget}")
    if eng.kv.alloc.n_used or not eng.kv.alloc.check_invariants():
        raise AssertionError(f"{name}: {eng.kv.alloc.n_used} pages used")
    want = gqa_layers(cfg) * st["decode_steps"]
    if launches != want:
        raise AssertionError(f"{name}: paged_flash_decode launched "
                             f"{launches} times, want {want}")
    decode_s = eng.step_s - eng.prefill_s
    decode_tokens = sum(len(t) - 1 for t in out.values())
    log(f"    8 requests, {sum(n for _, n in reqs)} tokens, superstep_k=4: "
        f"{st['decode_steps']} decode steps in {st['supersteps']} "
        f"supersteps, {st['prefill_calls']} prefill calls; decode "
        f"{decode_tokens / decode_s:.1f} tok/s, "
        f"{decode_s / st['decode_steps'] * 1e3:.2f} ms per decode step, "
        f"prefill {eng.prefill_s / st['prefill_calls'] * 1e3:.1f} ms per "
        f"call; paged_flash_decode launched {launches} times "
        f"({gqa_layers(cfg)} GQA layers x {st['decode_steps']} steps)")
    experts = [t for blk in params["blocks"] if "router" in blk["ffn"]
               for k, t in blk["ffn"].items()
               if k in ("w_gate", "w_up", "w_down")]
    if experts:
        nbytes = sum(t.numel() * t.element_size() for t in experts)
        mem_rate = card_peaks(torch.cuda.get_device_name(0))[0]
        log(f"    routed experts' weights {nbytes / 1e9:.2f} GB: drop-free "
            "capacity runs every expert, so each decode step reads them "
            f"all, at least {nbytes / mem_rate * 1e3:.2f} ms at "
            f"{mem_rate / 1e12:.2f} TB/s")
    ref, ref_rids, ref_out = run_engine(params, cfg, reqs, 1, FAMILY_CCFG)
    for a, b in zip(rids, ref_rids):
        if not np.array_equal(out[a], ref_out[b]):
            raise AssertionError(f"{name} request {a}: superstep_k=4 and 1 "
                                 "differ")
    log(f"    token streams identical to the superstep_k=1 run "
        f"({ref.stats['decode_steps']} decode steps)")
    if gqa_layers(cfg):
        steps = min(n for _, n in reqs)
        prompts = [p for p, _ in reqs[:FAMILY_CCFG.num_slots]]
        streams = np.stack([out[r][:steps]
                            for r in rids[:FAMILY_CCFG.num_slots]])
        lg = [teacher_forced_logits(params, eng.infer_cfg, prompts, streams,
                                    impl, FAMILY_CCFG).float()
              for impl in ("cuda", "plain")]
        diff = float((lg[0] - lg[1]).abs().max())
        log(f"    teacher-forced decode, {len(prompts)} slots x {steps} "
            f"steps: max |logit diff| kernel vs plain {diff:.4f} (logits up "
            f"to {float(lg[1].abs().max()):.2f}, tolerance {LOGIT_TOL})")
        if not torch.isfinite(lg[0]).all() or diff > LOGIT_TOL:
            raise AssertionError(f"{name}: teacher-forced logits, kernel "
                                 "and plain form disagree")
    # where a decode step's time goes: 4 slots of 128-token prompts
    prof_eng = ServeEngine(params, cfg, FAMILY_CCFG, superstep_k=4)
    rng = np.random.default_rng(3)
    for _ in range(FAMILY_CCFG.num_slots):
        prof_eng.submit(rng.integers(0, cfg.vocab_size, 128).astype(
            np.int32), 16)
    profile_decode(prof_eng, steps=2, top=4)
    del params, eng, ref, prof_eng
    torch.cuda.empty_cache()
    return launches


def dense_cache(cfg, prefill, batch, max_len, device):
    """A dense decode cache of ``max_len`` positions holding a prefill's
    cache: attention rows copied to the front, state and cross leaves
    whole."""
    cache = mmodel.init_cache(cfg, batch, max_len, device=device)
    for blk, pre in zip(cache, prefill):
        for part, leaves in blk.items():
            for leaf_name, leaf in leaves.items():
                src = pre[part][leaf_name]
                if part == "mixer" and leaf_name in ("k", "v", "ckv", "kr"):
                    leaf[:, :, :src.shape[2]] = src
                else:
                    leaf.copy_(src)
    return cache


@torch.no_grad()
def twin_logits(params, cfg, prompt, enc, steps, device, feed=None):
    """Prefill ``prompt`` (B, S) (with frame embeddings ``enc`` for an
    encoder-decoder), then ``steps`` dense-cache decode steps, each fed
    ``feed``'s next token, or the step's own argmax. Returns the prefill's
    logits, the (steps, B, vocab) decode logits and the tokens fed."""
    b, s = prompt.shape
    tok = torch.tensor(prompt, device=device)
    kw = {} if enc is None else {"enc_embed": torch.tensor(enc,
                                                           device=device)}
    logits, _, pre = apply_model(params, tok, cfg, mode="prefill", **kw)
    cache = dense_cache(cfg, pre, b, s + steps, device)
    nxt = logits[:, -1].argmax(-1)
    out, fed = [], []
    for i in range(steps):
        cur = (torch.tensor(feed[i], device=device) if feed is not None
               else nxt)
        fed.append(cur.cpu().numpy())
        lg, _, _ = apply_model(params, cur[:, None].int(), cfg,
                               mode="decode", cache=cache, cache_index=s + i)
        out.append(lg[:, 0])
        nxt = lg[:, 0].argmax(-1)
    return logits, torch.stack(out), np.stack(fed)


def whisper_card_vs_cpu():
    """whisper-base at full size in f32: a prefill over 1,500 random frame
    embeddings and an 8-token prompt, then 16 dense-cache decode steps
    fed the CPU's greedy tokens, on the card against the CPU."""
    cfg = dataclasses.replace(get_config("whisper-base"),
                              param_dtype="float32", compute_dtype="float32")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    t0 = time.perf_counter()
    c_pre, c_dec, fed = twin_logits(params, cfg, prompt, enc,
                                    WHISPER_DECODE_STEPS, "cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_pre, g_dec, _ = twin_logits(mmodel.tree_to(params, "cuda"), cfg,
                                  prompt, enc, WHISPER_DECODE_STEPS, "cuda",
                                  feed=fed)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    diff = max(float((g_pre.cpu() - c_pre).abs().max()),
               float((g_dec.cpu() - c_dec).abs().max()))
    log(f"  whisper-base (full, {cfg.param_count():,} parameters, f32): "
        f"prefill over {cfg.encoder_seq} frames + {WHISPER_DECODE_STEPS} "
        f"decode steps, card {gpu_s:.2f} s, CPU {cpu_s:.2f} s; max |logit "
        f"diff| card vs CPU {diff:.3e} (logits up to "
        f"{float(c_dec.abs().max()):.2f}, rtol = atol = 1e-4)")
    for a, b in ((g_pre, c_pre), (g_dec, c_dec)):
        torch.testing.assert_close(a.cpu(), b, **TWIN_TOL)


@torch.no_grad()
def family_twin(name: str):
    """The reduced config of ``name`` in f32 on the card and on the CPU:
    prefill and dense-decode logits within ``TWIN_TOL``; for a
    decoder-only arch, ``ServeEngine`` streams (4 slots, superstep_k = 4)
    identical wherever the CPU's top-2 margin exceeds the tolerance.
    Returns (max |logit diff|, stream positions checked, positions equal
    up to each stream's first divergence)."""
    cfg = get_config(name).reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    gparams = mmodel.tree_to(params, "cuda")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    enc = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) if cfg.encoder_decoder else None)
    c_pre, c_dec, fed = twin_logits(params, cfg, prompt, enc, 8, "cpu")
    g_pre, g_dec, _ = twin_logits(gparams, cfg, prompt, enc, 8, "cuda",
                                  feed=fed)
    for a, b in ((g_pre, c_pre), (g_dec, c_dec)):
        torch.testing.assert_close(a.cpu(), b, **TWIN_TOL)
    diff = max(float((g_pre.cpu() - c_pre).abs().max()),
               float((g_dec.cpu() - c_dec).abs().max()))
    if cfg.encoder_decoder:
        return diff, 0, 0
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 65)))
             .astype(np.int32), int(rng.integers(8, 17))) for _ in range(8)]
    ccfg = PagedCacheConfig(num_slots=4, page_size=16, max_pages_per_seq=6,
                            num_pages=25)
    outs = []
    for p, dev in ((params, "cpu"), (gparams, "cuda")):
        eng = ServeEngine(p, cfg, ccfg, superstep_k=4, device=dev)
        rids = [eng.submit(q, n) for q, n in reqs]
        out = eng.run()
        outs.append([out[r] for r in rids])
    icfg = eng.infer_cfg
    checked = same = 0
    for (prompt_i, _), c_toks, g_toks in zip(reqs, *outs):
        checked += len(c_toks)
        if np.array_equal(c_toks, g_toks):
            same += len(c_toks)
            continue
        j = int(np.argmax(c_toks != g_toks))       # the first divergence
        same += j
        seq = np.concatenate([prompt_i, c_toks[:j]])[None]
        lg, _, _ = apply_model(params, torch.tensor(seq), icfg)
        top2 = lg[0, -1].float().topk(2).values
        if float(top2[0] - top2[1]) > TWIN_TOL["atol"]:
            raise AssertionError(f"{name}: card and CPU streams diverge at a "
                                 "clear top-2 margin")
    return diff, checked, same


def drive_families():
    """Phase 11: the five served configs at full width, whisper-base on
    the card against the CPU, and the reduced CPU twin of every new
    family. Returns the decode kernel's launches (the served configs'
    superstep_k = 4 runs)."""
    t_all = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    total = 0
    for name, depth in FAMILY_RUNS:
        cfg = get_config(name)
        if gqa_layers(cfg):
            plan = dattn.split_plan(FAMILY_CCFG.num_slots, cfg.n_kv_heads,
                                    FAMILY_CCFG.max_pages_per_seq,
                                    FAMILY_CCFG.page_size, n_sm)
            log(f"  {name}: decode kernel at G = "
                f"{cfg.n_heads // cfg.n_kv_heads} (H = {cfg.n_heads}, Hkv "
                f"= {cfg.n_kv_heads}, D = {cfg.resolved_head_dim}), split "
                f"plan {plan}")
        t0 = time.perf_counter()
        total += serve_family(name, depth)
        log(f"    {name} in {time.perf_counter() - t0:.1f} s")
    whisper_card_vs_cpu()
    for name in TWIN_ARCHS:
        diff, checked, same = family_twin(name)
        streams = (f"served streams equal at {same} of {checked} positions "
                   "(any divergence at a CPU top-2 margin within the "
                   "tolerance)" if checked else "not paged (encoder-decoder)")
        log(f"  CPU twin {name} (reduced, f32): max |logit diff| card vs "
            f"CPU {diff:.3e}; {streams}")
    log(f"  phase 11 in {time.perf_counter() - t_all:.1f} s; "
        f"paged_flash_decode launched {total} times")
    return {"paged_flash_decode": total}


# ---------------------------------------------------------------------------
# 12. the prefix cache at full width


SYSTEM_PROMPT = 256          # tokens: 16 full pages shared by 16 requests
PREFIX_CCFG_A = PagedCacheConfig(num_slots=8, page_size=16,
                                 max_pages_per_seq=24, num_pages=24 * 24 + 1)
# run B: room for the largest request and a few more, so cached pages
# must be reclaimed from the LRU while higher-priority requests preempt
PREFIX_CCFG_B = PagedCacheConfig(num_slots=8, page_size=16,
                                 max_pages_per_seq=24, num_pages=60)
PREFIX_TWIN_CCFG = PagedCacheConfig(num_slots=2, page_size=4,
                                    max_pages_per_seq=8, num_pages=24)
PREFIX_SLA_CCFG = PagedCacheConfig(num_slots=1, page_size=4,
                                   max_pages_per_seq=8, num_pages=12)


def prefix_requests(vocab: int, seed: int = 0):
    """24 requests, 16-32 new tokens each, in a seeded order: 16 share a
    256-token system prompt and add their own tails of 1-40 tokens
    (partial-block hits, new blocks), 4 carry one identical 200-token
    prompt (full hits, a COW fork each), 4 are cold unique prompts of
    64-128 tokens. Returns (prompt, budget, family) triples."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    same = rng.integers(0, vocab, 200)
    reqs = [(np.concatenate([system, rng.integers(0, vocab, int(
        rng.integers(1, 41)))]), "shared") for _ in range(16)]
    reqs += [(same.copy(), "identical") for _ in range(4)]
    reqs += [(rng.integers(0, vocab, int(rng.integers(64, 129))), "cold")
             for _ in range(4)]
    order = rng.permutation(len(reqs))
    return [(reqs[i][0].astype(np.int32), int(rng.integers(16, 33)),
             reqs[i][1]) for i in order]


class PrefixTimedEngine(TimedEngine):
    """TimedEngine that with the prefix cache on also bills each
    admission (a cold prefill, or a shared hit and its suffix feed; each
    ends in a host sync) to ``prefill_s``, and its suffix feeds to
    ``suffix_s`` as well; per request it keeps the admission's time to
    the first token and its cached tokens, and it counts the pages that
    resumes re-shared from the index."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.suffix_s = 0.0
        self.reshared = 0
        self.admit_ms = {}                   # rid -> (ms, cached tokens)

    def _feed_suffix(self, slot, suffix):
        t0 = time.perf_counter()
        out = super()._feed_suffix(slot, suffix)
        self.suffix_s += time.perf_counter() - t0
        return out

    def _admit_prefix(self, st):
        hits = self.stats["cache_hit_tokens"]
        t0 = time.perf_counter()
        super()._admit_prefix(st)
        dt = time.perf_counter() - t0
        self.prefill_s += dt
        if st.generated:
            self.admit_ms[st.req.rid] = (
                dt * 1e3, self.stats["cache_hit_tokens"] - hits)

    def _resume(self, st):
        swap_in = self.kv.swap_in

        def counted(*args):
            m = swap_in(*args)
            self.reshared += m
            return m
        self.kv.swap_in = counted
        try:
            super()._resume(st)
        finally:
            del self.kv.swap_in


class SharedPageProbe:
    """After a step where one physical page sits in two active slots'
    tables, or a COW fork happened, holds the decode kernel against its
    plain form on the engine's own pools and tables, every layer, on a
    random query (at most ``limit`` times a run). Its launches are kept
    apart, so the main path's count can leave them out."""

    def __init__(self, limit: int = 4):
        self.limit, self.probes, self.shared = limit, 0, 0
        self.launches, self.forks, self.errs = 0, 0, []
        self.gen = torch.Generator(device="cuda").manual_seed(7)

    def __call__(self, eng):
        kv, ps = eng.kv, eng.kv.ccfg.page_size
        forked = eng.stats["cow_forks"] > self.forks
        self.forks = eng.stats["cow_forks"]
        rows = [kv.page_table[s, :-(-int(kv.kv_lens[s]) // ps)]
                for s in eng.sched.active]
        used = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        shared = len(used) - len(np.unique(used))
        if self.probes >= self.limit or not (shared or forked):
            return
        self.probes += 1
        self.shared = max(self.shared, shared)
        tbl = torch.tensor(kv.page_table, device="cuda")
        lens = torch.tensor(kv.kv_lens, device="cuda")
        before = dattn.LAUNCHES["paged_flash_decode"]
        for pos, blk in enumerate(kv.cache):
            kp, vp = blk["mixer"]["k_pages"], blk["mixer"]["v_pages"]
            q = torch.randn((kv.page_table.shape[0], eng.cfg.n_heads,
                             kp.shape[-1]), generator=self.gen,
                            device="cuda").to(kp.dtype)
            for p in range(kp.shape[0]):
                check(f"paged_flash_decode on the engine's shared pages, "
                      f"layer {pos}.{p}",
                      dattn.paged_flash_decode(q, kp[p], vp[p], tbl, lens),
                      dattn.paged_decode_plain(q, kp[p], vp[p], tbl, lens),
                      DECODE_TOL[kp.dtype], self.errs)
        self.launches += dattn.LAUNCHES["paged_flash_decode"] - before


def checked_drain(eng, max_steps: int = 10_000, after_step=None):
    """``run()`` with the allocator's and the index's books checked after
    every step, and ``after_step(eng)`` called there."""
    steps = 0
    while not eng.sched.idle:
        eng.step()
        eng.kv.alloc.check_invariants()
        if eng.kv.prefix is not None:
            eng.kv.prefix.check_invariants()
        if after_step is not None:
            after_step(eng)
        steps += 1
        if steps > max_steps:
            raise AssertionError("serving loop did not drain")
    return {rid: np.asarray(st.generated, np.int32)
            for rid, st in eng.sched.finished.items()}


def serve_prefix(params, cfg, reqs, ccfg, prefix, policy="fifo",
                 split=None, probe=None):
    """Serve ``reqs`` on one engine (superstep_k = 8). With ``split``,
    the requests at those indices come first at priority 0, the rest two
    steps later at priority 1 (under ``sla`` they preempt). ``probe`` is
    called after every step. Returns the engine, the streams in request
    order and the decode kernel's launches over the run, its count zeroed
    just before, less the probe's."""
    eng = PrefixTimedEngine(params, cfg, ccfg, superstep_k=8,
                            prefix_cache=prefix, policy=policy,
                            device=params["embed"]["tok"].device)
    dattn.reset_launches()
    rids = {}
    if split is None:
        for i, (p, n, _) in enumerate(reqs):
            rids[i] = eng.submit(p, n)
    else:
        for i in split:
            rids[i] = eng.submit(reqs[i][0], reqs[i][1], priority=0)
        eng.step()
        eng.step()
        for i in range(len(reqs)):
            if i not in rids:
                rids[i] = eng.submit(reqs[i][0], reqs[i][1], priority=1)
    out = checked_drain(eng, after_step=probe)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    launches = dattn.LAUNCHES["paged_flash_decode"]
    if probe is not None:
        launches -= probe.launches
    return eng, [out[rids[i]] for i in range(len(reqs))], launches


def prefix_metrics(eng, reqs):
    """Host-clock figures of one run. Prefill time per call includes the
    prompt's page writes; with the cache on it is the mean cold
    admission. Decode time is step time less all admission time."""
    st = eng.stats
    ttft = np.asarray([s.ttft for s in eng.sched.finished.values()]) * 1e3
    cold = [ms for ms, c in eng.admit_ms.values() if not c]
    return dict(
        ttft_mean_ms=float(ttft.mean()), ttft_p50_ms=float(np.median(ttft)),
        prefill_calls=st["prefill_calls"],
        prefill_ms=(float(np.mean(cold)) if eng.kv.prefix is not None
                    else eng.prefill_s / st["prefill_calls"] * 1e3),
        hit_tokens=st["cache_hit_tokens"], miss_tokens=st["cache_miss_tokens"],
        suffix_steps=st["suffix_steps"],
        suffix_step_ms=(eng.suffix_s / st["suffix_steps"] * 1e3
                        if st["suffix_steps"] else float("nan")),
        decode_steps=st["decode_steps"],
        decode_tok_s=(sum(n - 1 for _, n, _ in reqs)
                      / (eng.step_s - eng.prefill_s)),
        cow_forks=st["cow_forks"], evictions=st["prefix_evictions"],
        preemptions=st["preemptions"], resumed=st["resumed"])


def log_prefix(label, m):
    log(f"    {label}: TTFT mean {m['ttft_mean_ms']:.1f} ms p50 "
        f"{m['ttft_p50_ms']:.1f} ms; {m['prefill_calls']} prefill calls, "
        f"{m['prefill_ms']:.2f} ms each; hit {m['hit_tokens']} / miss "
        f"{m['miss_tokens']} tokens; {m['suffix_steps']} suffix steps, "
        f"{m['suffix_step_ms']:.2f} ms each; decode {m['decode_tok_s']:.1f} "
        f"tok/s over {m['decode_steps']} steps; COW forks {m['cow_forks']}, "
        f"evictions {m['evictions']}, preemptions {m['preemptions']}, "
        f"resumed {m['resumed']}")


def serve_sla_twin(params, cfg, prefix):
    """The f32 twin's small-pool ``sla`` run, one slot and 12 pages of 4
    tokens: three 8-token prompts are served and retire (their blocks
    stay in the LRU), a 9-token prompt starts, and two steps later a
    priority-2 prompt on its first block preempts it. The pool makes the
    LRU evict, and the resume re-shares the long prompt's resident
    blocks. Returns the engine and the streams."""
    rng = np.random.default_rng(5)
    v = cfg.vocab_size
    p_long = rng.integers(0, v, 9).astype(np.int32)
    p_hot = np.concatenate([p_long[:4], rng.integers(0, v, 2)
                            ]).astype(np.int32)
    warm = [rng.integers(0, v, 8).astype(np.int32) for _ in range(3)]
    eng = PrefixTimedEngine(params, cfg, PREFIX_SLA_CCFG, superstep_k=1,
                            prefix_cache=prefix, policy="sla",
                            device=params["embed"]["tok"].device)
    rids = [eng.submit(p, 4, priority=0) for p in warm]
    checked_drain(eng)
    rids.append(eng.submit(p_long, 12, priority=0))
    eng.step()
    eng.step()
    rids.append(eng.submit(p_hot, 3, priority=2, deadline=2.0))
    out = checked_drain(eng)
    return eng, [out[r] for r in rids]


def prefix_twin(dev_params, cpu_params, cfg):
    """Reduced qwen2-0.5b in f32, on ``tests/test_serve_prefix.py``'s mix
    and on the small-pool ``sla`` run: the card's streams with the cache
    on equal its streams with it off and the CPU's with it on, exactly,
    and the card's and the CPU's stats (and re-shared pages) match.
    Returns the card's stats of both runs and its re-shared pages."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    p2 = np.concatenate([p0[:8], rng.integers(0, cfg.vocab_size, 3)
                         ]).astype(np.int32)
    p3 = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    reqs = [(p, n, "") for p, n in zip([p0, p0.copy(), p2, p3], [4, 3, 5, 4])]
    runs = {}
    for label, params, prefix in (("card on", dev_params, "on"),
                                  ("card off", dev_params, "off"),
                                  ("cpu on", cpu_params, "on")):
        eng, out, _ = serve_prefix(params, cfg, reqs, PREFIX_TWIN_CCFG,
                                   prefix)
        sla, sla_out = serve_sla_twin(params, cfg, prefix)
        runs[label] = ((eng.stats, sla.stats, sla.reshared),
                       out + sla_out)
    for label in ("card off", "cpu on"):
        for a, b in zip(runs["card on"][1], runs[label][1]):
            if not np.array_equal(a, b):
                raise AssertionError(f"reduced f32 twin: card on and {label} "
                                     "streams differ")
    if runs["card on"][0] != runs["cpu on"][0]:
        raise AssertionError("reduced f32 twin: card and CPU stats differ")
    st, sla, reshared = runs["card on"][0]
    if (sla["prefix_evictions"] < 1 or sla["preemptions"] < 1
            or sla["resumed"] < 1 or reshared < 1):
        raise AssertionError(f"reduced f32 twin, sla run: {sla}, "
                             f"{reshared} pages re-shared")
    return st, sla, reshared


def drive_prefix(params, cfg):
    """Phase 12: the prefix cache on qwen2-0.5b at full width (phase 6's
    bf16 weights), 8 slots, 16-token pages, superstep_k = 8. Returns the
    decode kernel's launches over the cached runs and the metrics of run
    A with the cache on and off."""
    reqs = prefix_requests(cfg.vocab_size)
    prompts = [p for p, _, _ in reqs]
    fams = {f: sum(1 for *_, g in reqs if g == f)
            for f in ("shared", "identical", "cold")}
    log(f"  24 requests ({fams['shared']} on a {SYSTEM_PROMPT}-token system "
        f"prompt with tails of 1-40, {fams['identical']} identical "
        f"200-token prompts, {fams['cold']} cold of 64-128), "
        f"{sum(n for _, n, _ in reqs)} new tokens; run A pool "
        f"{PREFIX_CCFG_A.num_pages} pages, run B {PREFIX_CCFG_B.num_pages}")
    total = 0
    serve_prefix(params, cfg, reqs[:2], PREFIX_CCFG_A, "on")    # warm-up
    probe_a = SharedPageProbe()
    eng_on, on, launches = serve_prefix(params, cfg, reqs, PREFIX_CCFG_A,
                                        "on", probe=probe_a)
    total += launches
    st = eng_on.stats
    iters = st["decode_steps"] + st["suffix_steps"]
    if launches != cfg.n_layers * iters:
        raise AssertionError(f"run A: paged_flash_decode launched {launches} "
                             f"times, want {cfg.n_layers} x {iters}")
    if eng_on.kv.alloc.n_used != eng_on.kv.prefix.n_indexed:
        raise AssertionError("run A: used pages other than the indexed ones")
    if (st["cache_hit_tokens"] < 15 * SYSTEM_PROMPT or st["cow_forks"] < 1
            or st["suffix_steps"] <= 0 or st["prefix_evictions"]):
        raise AssertionError(f"run A: cache counters {st}")
    eng_off, off, launches_off = serve_prefix(params, cfg, reqs,
                                              PREFIX_CCFG_A, "off")
    if launches_off != cfg.n_layers * eng_off.stats["decode_steps"]:
        raise AssertionError("run A off: decode launches do not match")
    for what, streams in (("run A on", on), ("run A off", off)):
        for (_, n, _), g in zip(reqs, streams):
            if g.shape != (n,):
                raise AssertionError(f"{what}: {g.shape} tokens, budget {n}")
    # on and off both the plain argmax at every clear margin: where they
    # part, the margin is within LOGIT_TOL
    g_on = greedy_check(params, cfg, 16, prompts, on)
    g_off = greedy_check(params, cfg, 16, prompts, off)
    div = sum(not np.array_equal(a, b) for a, b in zip(on, off))
    log(f"  run A: paged_flash_decode launched {launches} times = "
        f"{cfg.n_layers} layers x ({st['decode_steps']} decode + "
        f"{st['suffix_steps']} suffix steps); books checked after every "
        f"step; {eng_on.kv.alloc.n_used} pages left, all indexed")
    log_greedy("run A, cache on ", g_on)
    log_greedy("run A, cache off", g_off)
    log(f"    {div} of {len(reqs)} cache-on streams differ from the "
        f"cache-off run's, each first where the top-2 margin is within "
        f"{LOGIT_TOL}")
    m_on, m_off = prefix_metrics(eng_on, reqs), prefix_metrics(eng_off, reqs)
    log_prefix("cache on ", m_on)
    log_prefix("cache off", m_off)
    hits = [ms for ms, c in eng_on.admit_ms.values() if c]
    cold = [ms for ms, c in eng_on.admit_ms.values() if not c]
    tails = [len(p) - SYSTEM_PROMPT for p, _, g in reqs if g == "shared"]
    m_on["hit_admit_ms"] = float(np.mean(hits))
    m_on["cold_admit_ms"] = float(np.mean(cold))
    m_on["break_even_tokens"] = m_on["cold_admit_ms"] / m_on["suffix_step_ms"]
    log(f"    admission to first token, cache on: {len(hits)} hits "
        f"{m_on['hit_admit_ms']:.1f} ms mean (suffixes of 1 token and of "
        f"{min(tails)}-{max(tails)}), {len(cold)} cold single prefills "
        f"{m_on['cold_admit_ms']:.1f} ms mean: a suffix longer than "
        f"{m_on['break_even_tokens']:.1f} tokens costs more than a cold "
        "prefill")

    lo = [i for i in range(len(reqs)) if i % 2 == 0]
    probe_b = SharedPageProbe()
    eng_b, out_b, launches_b = serve_prefix(params, cfg, reqs, PREFIX_CCFG_B,
                                            "on", policy="sla", split=lo,
                                            probe=probe_b)
    total += launches_b
    sb = eng_b.stats
    if (sb["prefix_evictions"] < 1 or sb["preemptions"] < 1
            or sb["resumed"] < 1):
        raise AssertionError(f"run B: cache counters {sb}")
    if launches_b != cfg.n_layers * (sb["decode_steps"] + sb["suffix_steps"]):
        raise AssertionError("run B: decode launches do not match")
    if eng_b.kv.alloc.n_used != eng_b.kv.prefix.n_indexed:
        raise AssertionError("run B: used pages other than the indexed ones")
    eng_b.reset_prefix_cache()
    if eng_b.kv.alloc.n_used:
        raise AssertionError(f"run B: {eng_b.kv.alloc.n_used} pages kept")
    for (_, n, _), g in zip(reqs, out_b):
        if g.shape != (n,):
            raise AssertionError(f"run B: {g.shape} tokens, budget {n}")
    g_b = greedy_check(params, cfg, 16, prompts, out_b)
    div_b = sum(not np.array_equal(a, b) for a, b in zip(out_b, off))
    log(f"  run B (sla, priorities 0 then 1): {sb['prefix_evictions']} "
        f"evictions, {sb['preemptions']} preemptions, {sb['resumed']} "
        f"resumed, {sb['swapped_pages']} pages swapped, {eng_b.reshared} "
        f"re-shared on resume; every page back after reset_prefix_cache; "
        f"{div_b} streams differ from run A off's")
    log_greedy("run B", g_b)
    for label, pr in (("run A", probe_a), ("run B", probe_b)):
        if not pr.shared:
            raise AssertionError(f"{label}: no step with a page in two "
                                 "slots' tables was probed")
        log(f"    {label}: decode kernel vs plain form on the engine's own "
            f"pools and tables after {pr.probes} steps (at most "
            f"{pr.shared} table entries on a page another slot holds), "
            f"{cfg.n_layers} layers each: "
            f"max_abs_err {max(pr.errs):.3e} (bf16 rtol/atol 2e-2)")
    log_prefix("run B    ", prefix_metrics(eng_b, reqs))

    tcfg = get_config(SERVE_ARCH).reduced()
    cpu_params = init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu", max_pos=64)
    tst, sla, reshared = prefix_twin(mmodel.tree_to(cpu_params, "cuda"),
                                     cpu_params, tcfg)
    log(f"  reduced {SERVE_ARCH} f32: streams with the cache on equal the "
        f"cache-off run's and the CPU's exactly; stats equal the CPU's "
        f"(hit {tst['cache_hit_tokens']}, suffix steps "
        f"{tst['suffix_steps']}, COW forks {tst['cow_forks']}); small-pool "
        f"sla run: {sla['prefix_evictions']} evictions, "
        f"{sla['preemptions']} preemption, {sla['resumed']} resumed with "
        f"{reshared} pages re-shared, equal to the CPU's")
    return {"paged_flash_decode": total}, m_on, m_off


def log_greedy(label, g):
    diff, checked, close, same = g
    log(f"    {label}: streams vs the plain form's greedy argmax, teacher "
        f"forced: equal at {same} of {checked} positions ({close} with a "
        f"top-2 margin within {LOGIT_TOL}); max |logit diff| kernel vs "
        f"plain {diff:.4f}")


# ---------------------------------------------------------------------------
# 13. fleet control and checkpoint rejoin on real engines


FLEET_REQUESTS = 16          # the reference's smoke size for fleet replays
# crash_cascade's crashes start at 100, 140 and 180 of virtual time, when
# no request is in flight; moved to 3.0, 14.5 and 29.8 each lands on a
# request in flight on that replica, and the windows end early enough
# that the restarted replicas serve the later arrivals
INFLIGHT_CRASHES = ((0, 3.0, 60.0), (1, 14.5, 70.0), (2, 29.8, 80.0))


def engine_rejoin(eng):
    """A drained engine's snapshot through the Checkpointer into
    ``restart(image)``: rid counter monotone, one request's stream the
    same after as before; a busy engine's snapshot refused."""
    import tempfile
    prompt = np.random.default_rng(51).integers(
        0, eng.cfg.vocab_size, 24).astype(np.int32)
    rid0 = eng.submit(prompt, 8)
    before = eng.run()[rid0]
    image = eng.snapshot()
    with tempfile.TemporaryDirectory(prefix="rejoin_") as d:
        ck = Checkpointer(d, keep=1)
        t0 = time.perf_counter()
        ck.save(image, step=0, blocking=True)
        loaded, _ = ck.restore_flat()
        ck_s = time.perf_counter() - t0
    mb = sum(v.nbytes for v in loaded.values()) / 1e6
    t0 = time.perf_counter()
    eng.restart(loaded)
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    rid1 = eng.submit(prompt, 8)
    if rid1 <= rid0:
        raise AssertionError("rid counter went back across the restart")
    try:
        eng.snapshot()
    except SnapshotInFlightError as e:
        refused = (e.n_active, e.n_waiting)
    else:
        raise AssertionError("snapshot of a busy engine was not refused")
    after = eng.run()[rid1]
    if not np.array_equal(before, after):
        raise AssertionError("the stream changed across the restart")
    return mb, ck_s, restart_s, refused


def fleet_replay(params, fleet, sc):
    """``run_fleet_e2e`` of ``sc`` cut to 16 requests on the warm fleet,
    the decode kernel's count zeroed just before and read just after:
    zero violations, nothing lost, every death rejoined after probation,
    delivered streams the plain form's greedy argmax where the margin
    allows. Returns the launches, the report and the wall seconds."""
    dattn.reset_launches()
    t0 = time.perf_counter()
    rep = run_fleet_e2e(sc, fleet, n_requests=FLEET_REQUESTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dattn.LAUNCHES["paged_flash_decode"]
    m = rep.metrics
    if rep.violations:
        raise AssertionError(f"{sc.name}: {summarize(rep.violations)}")
    if m.permanently_lost or m.restarts < 1 or m.deaths < 1:
        raise AssertionError(f"{sc.name}: {m.as_dict()}")
    if m.rejoins != m.deaths:
        raise AssertionError(f"{sc.name}: {m.deaths} deaths but "
                             f"{m.rejoins} rejoins after probation")
    if launches == 0:
        raise AssertionError(f"paged_flash_decode was not launched in "
                             f"{sc.name}")
    if not fleet.drained():
        raise AssertionError(f"fleet not drained after {sc.name}")
    lost = sum(c.status == LOST for q in rep.requests
               for c in q.copies.values())
    log(f"  {sc.name}, {len(rep.requests)} requests through the fleet "
        f"controller in {wall:.1f} s on the host clock; paged_flash_decode "
        f"launched {launches} times; copies lost to crashes {lost}")
    log(f"    deaths {m.deaths}, rejoins {m.rejoins}, restarts {m.restarts}, "
        f"transitions {m.transitions}; hedges {m.hedges}, retries "
        f"{m.retries}, shed {m.shed}, permanently lost "
        f"{m.permanently_lost}; recovery {m.recovery_time_mean:.3f} mean / "
        f"{m.recovery_time_max:.3f} max, rejoin lag {m.rejoin_lag_mean:.3f} "
        f"(virtual time); success rate {m.sr_pre:.3f} pre-fault, "
        f"{m.sr_post:.3f} post-rejoin; goodput {m.goodput_pre:.4f} / "
        f"{m.goodput_post:.4f} per unit")
    log_quorum(rep.native, "native")
    for r, row in sorted(rep.sweep.items()):
        log_quorum(row, f"r={r}")
    diff, checked, close, same = plain_greedy_check(
        params, fleet.engines[0].cfg, fleet.ecfg, rep)
    log(f"    delivered streams vs the plain form's greedy argmax: equal at "
        f"{same} of {checked} positions ({close} with a top-2 margin within "
        f"{LOGIT_TOL}); max |teacher-forced logit diff| kernel vs plain "
        f"{diff:.4f}")
    return launches, rep, wall, lost


def drive_fleet(params, fleet):
    """Phase 13: the engine-level rejoin on phase 10's warm fleet, then
    ``run_fleet_e2e`` of ``crash_cascade`` cut to 16 requests, and of the
    same scenario with its crashes on requests in flight, where the
    controller must fail copies over and a restarted replica must serve
    again. Returns the decode kernel's launches over the replays."""
    if not fleet.drained():
        raise AssertionError("fleet not drained before phase 13")
    mb, ck_s, restart_s, refused = engine_rejoin(fleet.engines[0])
    log(f"  engine 0: a {mb:.1f} MB snapshot through the Checkpointer in "
        f"{ck_s:.2f} s, restart(image) in {restart_s * 1e3:.1f} ms; rid "
        f"counter monotone, the stream after the restart equals the one "
        f"before; a busy engine's snapshot refused ({refused[0]} active, "
        f"{refused[1]} waiting)")
    sc = get_scenario("crash_cascade")
    launches, rep, wall, _ = fleet_replay(params, fleet, sc)
    sc = dataclasses.replace(
        sc, name="crash_cascade_inflight", faults=dataclasses.replace(
            sc.faults, crashes=tuple(CrashWindow(*c)
                                     for c in INFLIGHT_CRASHES)))
    more, rep2, wall2, lost = fleet_replay(params, fleet, sc)
    m = rep2.metrics
    if not lost or m.hedges + m.retries == 0 or not np.isfinite(m.sr_post):
        raise AssertionError(f"{sc.name}: no failover ({lost} copies lost, "
                             f"{m.as_dict()})")
    # the controller ranks replicas by latency, so a restarted one need
    # not be picked again; one at least must serve from its image
    served = sorted({j for j, _, end in INFLIGHT_CRASHES
                     for q in rep2.requests for c in q.delivered()
                     if c.replica == j and c.t_first > end})
    if not served:
        raise AssertionError(f"{sc.name}: no restarted replica served")
    log(f"    restarted replicas {served} delivered copies after their "
        "restarts")
    return {"paged_flash_decode": launches + more}, m, wall + wall2


# ---------------------------------------------------------------------------
# 14. wall-clock chaos on real engines


WALLCLOCK_N = 4
WALLCLOCK_REQUESTS = 12      # the reference's smoke size
WALLCLOCK_STUB_WORK = 0.3    # StubReplica work_time at scale 1


class CheckedReplica(EngineReplica):
    """EngineReplica that keeps the traceback of every exception of its
    engine other than a kill. The fleet counts such an exception as a
    crash and restarts the replica, so without this record a fault of
    the kernel or the cache would pass for one more crash and rejoin."""

    def __init__(self, *args):
        super().__init__(*args)
        self.errors = []

    def process(self, request, should_abort):
        try:
            return super().process(request, should_abort)
        except ReplicaKilled:
            raise
        except Exception:
            self.errors.append(traceback.format_exc())
            raise


def drive_wallclock(fleet):
    """Phase 14: 4 of the fleet's engines as ``EngineReplica``s under
    ``RealClock``, through ``kill_rejoin`` cut to 12 requests. Outcomes
    only, never timings.

    The timescale comes from one measured request, as the reference's
    wall-clock benchmark sets it, but from the request as a dispatch
    serves it: on n - r = 3 replicas at once, each on its own thread.
    One process drives every engine, and its host work serializes on the
    interpreter lock, so 3 replicas at once take far longer than one
    alone; a lone request's time would put heartbeats and deadlines
    below the fleet's real service time. The detector's prior
    (``init_interval``) scales with the heartbeat, as at scale 1."""
    replicas = [CheckedReplica(e, fleet.ecfg.max_new_tokens)
                for e in fleet.engines[:WALLCLOCK_N]]
    req = np.arange(1, 9, dtype=np.int32)
    for rep in replicas:
        rep.process(req, lambda: False)
    t0 = time.perf_counter()
    for rep in replicas:
        rep.process(req, lambda: False)
    lat = (time.perf_counter() - t0) / len(replicas)
    threads = [threading.Thread(target=rep.process, args=(req, lambda: False))
               for rep in replicas[:3]]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lat3 = time.perf_counter() - t0
    scale = max(lat3, 1e-3) / WALLCLOCK_STUB_WORK
    log(f"  one request {lat * 1e3:.1f} ms on one replica, {lat3 * 1e3:.1f} "
        f"ms on 3 at once (host clock): timescale {scale:.3f}")
    plan = dataclasses.replace(PLANS["kill_rejoin"](WALLCLOCK_N, scale=scale),
                               n_requests=WALLCLOCK_REQUESTS)
    cfg = FleetConfig(n_replicas=WALLCLOCK_N, r=1, seed=0,
                      heartbeat_period=2.0 * scale, init_interval=2.0 * scale)
    dattn.reset_launches()
    t0 = time.perf_counter()
    rep = run_realtime_chaos(plan, cfg, clock=RealClock(), replicas=replicas)
    wall = time.perf_counter() - t0
    launches = dattn.LAUNCHES["paged_flash_decode"]
    d = rep.as_dict()
    log(f"  kill_rejoin cut to {WALLCLOCK_REQUESTS} requests in {wall:.1f} s "
        f"(heartbeat {cfg.heartbeat_period:.3f} s); paged_flash_decode "
        f"launched {launches} times")
    log(f"    {json.dumps(d)}")
    log("    transitions " + ", ".join(
        f"{t:.3f} replica {j} {a} -> {b}" for t, j, a, b in rep.transition_log))
    log("    latencies " + " ".join(f"{x:.3f}" for x in rep.latencies))
    if rep.lost or rep.violations or not rep.drained:
        raise AssertionError(f"wall-clock kill_rejoin: {d}")
    for j in {ev.replica for ev in plan.events}:
        seen = [(a, b) for _, r, a, b in rep.transition_log if r == j]
        if not any(b == "dead" for _, b in seen) or \
                ("recovering", "healthy") not in seen:
            raise AssertionError(f"wall-clock kill_rejoin: the kill of "
                                 f"replica {j} was not detected or it did "
                                 f"not rejoin: {d}")
    errors = [e for r in replicas for e in r.errors]
    if errors:
        raise AssertionError(f"wall-clock kill_rejoin: {len(errors)} "
                             f"exceptions in the replicas' engines, the "
                             f"first:\n{errors[0]}")
    kills = sum(ev.kind == "kill" for ev in plan.events)
    if rep.deaths < 1 or rep.rejoins < 1 or rep.restarts != kills:
        raise AssertionError(f"wall-clock kill_rejoin: {rep.restarts} "
                             f"restarts for {kills} kills: {d}")
    if launches == 0:
        raise AssertionError("paged_flash_decode was not launched in the "
                             "wall-clock run")
    if not all(e.sched.idle for e in fleet.engines[:WALLCLOCK_N]):
        raise AssertionError("an engine replica was left busy")
    return {"paged_flash_decode": launches}, d, wall


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    log("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    mem_rate, f32_rate, bf16_rate = card_peaks(name)

    log("== 2. build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as ex:    # one nvcc per source
        outs = list(ex.map(_build.build, BUILDS))
    log(f"  built {', '.join(f'csrc/{b}.cu' for b in BUILDS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, out in outs:
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())
    log("  flash_wgmma_kernel dynamic shared memory per block: " + ", ".join(
        f"D = Dv = {d}: {fattn.wgmma_smem_bytes(d, d)} B"
        for d in (64, 128, 192, 256)))

    log("== 3. kernels vs plain forms")
    errs = check_kernels()
    errs["paged_flash_decode"] = check_decode_kernel()
    timing = time_kernels(mem_rate, f32_rate)
    time_many_agents(mem_rate)
    timing["paged_flash_decode"] = time_decode_kernel(mem_rate, f32_rate)

    log("== 3c. flash attention and the CGE norm kernels vs plain forms")
    t0 = time.perf_counter()
    errs["flash_attention"] = check_flash_kernel()
    errs.update(check_cge_norm_kernels())
    timing.update(time_new_kernels(mem_rate, f32_rate, bf16_rate))
    log(f"  phase 3c in {time.perf_counter() - t0:.1f} s")

    log("== 4. main path: AsyncDGDServer + LeNet, device backend")
    counts, data = drive_main_path(half=5)

    log("== 5. where the time goes")
    where_time_goes(data)
    where_quantized_time_goes(data)

    log(f"== 6. serving path: ServeEngine, {SERVE_ARCH} at full width, bf16")
    counts["paged_flash_decode"], params, _ = drive_serving()

    log("== 7. where the serving time goes")
    where_serving_time_goes(params)

    log(f"== 8. kernels API at full width: {SERVE_ARCH} activations and "
        "parameter tree, LeNet keep-set")
    counts.update(drive_kernels_api(params, data))

    log("== 9. the simulator: 13 scenarios, train (host backend, then two "
        "on the device backend) and serve")
    for k, c in drive_simulator().items():
        counts[k] += c

    log(f"== 10. the e2e harness: {E2E_REPLICAS} {SERVE_ARCH} replicas at "
        "full width")
    e2e_counts, fleet = drive_e2e(params)
    for k, c in e2e_counts.items():
        counts[k] += c

    # phase 6's weights and phase 10's fleet (about 1 GB) stay on the
    # card through phase 11 for phases 12-14
    log("== 11. the other model families at full width: jamba, deepseek-v2, "
        "arctic, rwkv6, qwen2-vl served; whisper and the CPU twins")
    for k, c in drive_families().items():
        counts[k] += c

    log(f"== 12. the prefix cache: {SERVE_ARCH} at full width, bf16")
    t0 = time.perf_counter()
    c12, _, _ = drive_prefix(params, get_config(SERVE_ARCH))
    log(f"  phase 12 in {time.perf_counter() - t0:.1f} s")

    log(f"== 13. fleet control and checkpoint rejoin: {E2E_REPLICAS} "
        f"{SERVE_ARCH} replicas at full width")
    c13, _, _ = drive_fleet(params, fleet)

    log(f"== 14. wall-clock chaos: {WALLCLOCK_N} of the replicas on real "
        "threads and timers")
    c14, _, _ = drive_wallclock(fleet)
    for c in (c12, c13, c14):
        counts["paged_flash_decode"] += c["paged_flash_decode"]
    del params, fleet
    torch.cuda.empty_cache()

    log("== 15. result")

    rows = [dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k],
                 launches=counts[k], max_abs_err=errs[k],
                 ms=timing[k]["ms"], plain_ms=timing[k]["plain_ms"],
                 bound_ms=timing[k]["bound_ms"],
                 bound_by=timing[k]["bound_by"],
                 library_ms=timing[k]["library_ms"]) for k in REPLACES]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
