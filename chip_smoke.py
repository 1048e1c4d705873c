#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA
   versions.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (nvcc, sm_90a) and print the build time.
3. Hold each kernel against its plain torch form on the card at the
   paper's shape (n=20 agents, P=431,080 LeNet parameters), at ragged
   P, and on the edge cases (every agent crashed, m - f <= 0, exact norm
   ties, duplicate values); then time the kernel, the plain form and one
   library call for the same function, each with a cold L2, beside the
   bytes-over-bandwidth bound.
4. The main path: ``AsyncDGDServer`` with the §5 LeNet agents (n=20,
   data partitioned with overlap 2) on the device backend, for the
   mean, cge (one sign-flip agent), trimmed_mean (stale) and quantized
   rules. Kernel launch counts are zeroed just before and read just
   after. Every run must give finite losses, match the host conformance
   pipeline (the reference rule op by op) on the card, and replay
   snapshot -> restore -> run bit for bit.
5. Where the time goes: a few cge iterations under torch.profiler (host
   ms per iteration, device busy time and idle share, copies, kernels).
6. A JSON line with every kernel's launches, error and times, the
   ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is not available or the
repository's sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import gradagg  # noqa: E402
from repro_torch.core.async_engine import (EngineConfig,  # noqa: E402
                                           default_latency)
from repro_torch.core.server import AsyncDGDServer  # noqa: E402
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402
from repro_torch.kernels import _build, agg  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models.model import classifier_loss  # noqa: E402

N_AGENTS, P_LENET = 20, 431_080
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # agent-order sum vs torch's order
EDGE_TOL = dict(rtol=1e-6, atol=1e-6)     # edge cases: exact or near-exact
REPLACES = {
    "masked_cge_reduce": "src/repro/kernels/agg.py:58",
    "trimmed_mean_tiled": "src/repro/kernels/agg.py:154",
    "dequant_accum": "src/repro/kernels/agg.py:247",
}
SOURCE = "src/repro_torch/kernels/csrc/agg.cu"


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# 1. the card


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s outside the tensor cores) of an H100
    SXM from NVIDIA's data sheet: 3.35 TB/s and 67 TFLOP/s. Another card
    has other peaks, which this script does not guess."""
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return 3.35e12, 67e12
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


def check_kernels():
    errs = {k: [] for k in REPLACES}
    shapes = [(N_AGENTS, P_LENET, N_AGENTS - 3, 1), (7, 4097, 5, 1),
              (N_AGENTS, 1_000_003, N_AGENTS, 2), (3, 1, 3, 0)]
    for i, (n, p, m, f) in enumerate(shapes):
        g, rx = ledger(n, p, m, seed=i)
        q, s = gradagg.quantize_int8_parts(g)
        for k, kern, plain in (
                ("masked_cge_reduce", agg.masked_cge_reduce,
                 agg.masked_cge_dot),
                ("trimmed_mean_tiled", agg.trimmed_mean_tiled,
                 agg.trimmed_mean_running)):
            e = check(f"{k} n={n} P={p} f={f}", kern(g, rx, f),
                      plain(g, rx, f), KERNEL_TOL, errs[k])
            log(f"  {k:20s} n={n:<3d} P={p:<9d} m={m:<3d} f={f} "
                f"max_abs_err={e:.3e}")
        e = check(f"dequant_accum n={n} P={p}",
                  agg.dequant_accum(q, s[:, 0], rx),
                  agg.dequant_dot(q, s[:, 0], rx), KERNEL_TOL,
                  errs["dequant_accum"])
        log(f"  {'dequant_accum':20s} n={n:<3d} P={p:<9d} m={m:<3d}     "
            f"max_abs_err={e:.3e}")
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
                    agg.trimmed_mean_tiled(g, rx, f).abs().max() != 0:
                raise AssertionError("all_crashed must give exact zeros")
        log(f"  edge case {case}: ok")
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
        byte_ms = nbytes / mem_rate * 1e3
        op_ms = nops / f32_rate * 1e3
        rows[k] = r = dict(
            ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
            library_ms=time_ms(lib, flush),
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations")
        warm = time_ms(kern)
        log(f"  {k:20s} kernel {r['ms']*1e3:7.2f} us (L2 warm "
            f"{warm*1e3:6.2f})  plain {r['plain_ms']*1e3:7.2f} us  library "
            f"{r['library_ms']*1e3:7.2f} us  bound {r['bound_ms']*1e3:5.2f} us"
            f" ({r['bound_by']}, {nbytes/1e6:.1f} MB at "
            f"{mem_rate/1e12:.2f} TB/s)")
        for kname, us in device_times(kern).items():
            log(f"      {kname:40s} {us:6.2f} us on the device (L2 warm)")
    return rows


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
# 4. the main path


RUNS = [  # (label, kernel, cfg overrides)
    ("mean fresh r=3", None, dict(rule="mean", r=3)),
    ("cge fresh f=1 sign_flip", "masked_cge_reduce",
     dict(rule="cge", r=3, f=1, byz_ids=(4,), attack="sign_flip")),
    ("trimmed_mean stale tau=2 f=1", "trimmed_mean_tiled",
     dict(rule="trimmed_mean", mode="stale", tau=2, r=3, f=1)),
    ("quantized fresh r=3", "dequant_accum", dict(rule="quantized", r=3)),
]
LAUNCHES_PER_CALL = {"masked_cge_reduce": 3, "trimmed_mean_tiled": 1,
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


OUR_KERNELS = ("cge_partial_norms", "cge_keep", "masked_col_sum",
               "trimmed_mean_kernel")


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
    peaks = card_peaks(name)

    log("== 2. build")
    t0 = time.perf_counter()
    _, out = _build.build("agg")
    log(f"  built csrc/agg.cu in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    log("== 3. kernels vs plain forms")
    errs = check_kernels()
    timing = time_kernels(*peaks)

    log("== 4. main path: AsyncDGDServer + LeNet, device backend")
    counts, data = drive_main_path(half=5)

    log("== 5. where the time goes")
    where_time_goes(data)

    rows = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
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
