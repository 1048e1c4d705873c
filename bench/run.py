#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``bench/``
and the port (``src/repro_torch``). The cell's traffic mix names its
driver (``bench/drivers/``), which builds the program from the seed, warms
it up (set-up), measures for ``--seconds`` and then checks what the timed
path produced against the plain reference (``bench/reference/``). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read by ``bench/metrics/``),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number compared with the reference beside its limit, which also end
standard error. Without a card, with fewer cards than the cell asks for,
without the port in the checkout, or with JAX loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX
    through a library that would load it."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def _fail(code: int, msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return code


def _metrics(cell, out, trace: bool, peaks) -> dict:
    import spec
    res = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in out["e2e"]:
                res[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
        return res
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"]).read(out["ctx"], peaks)
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(BENCH))
    import spec
    from program import import_port
    try:
        import_port()
        cell = spec.cell(args.workload)
    except (FileNotFoundError, KeyError) as e:
        return _fail(2, str(e))
    import torch
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} found")
    torch.set_num_threads(4)
    from peaks import card_peaks, power_limit
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    power = power_limit()

    out = spec.driver(cell.traffic).run(cell, args.seed, args.seconds,
                                        bool(args.trace), T0, device="cuda")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if leaked:
        return _fail(4, f"loaded in this process: {', '.join(leaked)}")

    out["ctx"]["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit": power}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": _metrics(cell, out, bool(args.trace), peaks),
              "device": device}
    tracer = out["ctx"].get("tracer")
    if args.trace and tracer is not None:
        device["busy_s"] = tracer.busy_s()
        device["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['at']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
