"""Cost of one use of the port's spans (``repro_torch.spans``), in us,
on the card: with nothing recording (no profiler, no ``start()``), after
``start()``, and under ``torch.profiler`` (host and device activities),
each bare, with a count (as ``serve.superstep`` carries ``k``) and with
``device=True`` (as ``train.update``). Run from the root of the
repository:

    PYTHONPATH=src python3 scripts/span_cost.py [--n 20000]

Prints one JSON line: the card, and us a span in each mode.
"""
import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans


def per_span_us(n: int, **kw) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        with spans.span("cost", **kw):
            pass
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def modes(n: int, tag: str) -> dict:
    per_span_us(n // 10)                                   # warm
    out = {f"{tag}": per_span_us(n), f"{tag}_count": per_span_us(n, k=8),
           f"{tag}_device": per_span_us(n, device=True)}
    spans.clear()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    n = ap.parse_args().n
    if not torch.cuda.is_available():
        raise SystemExit("span_cost: needs a CUDA card")
    torch.ones(1, device="cuda").sum().item()
    out = {"device": torch.cuda.get_device_name(0), "spans_per_mode": n}
    out.update(modes(n, "off"))
    spans.start()
    out.update(modes(n, "start"))
    spans.stop()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out.update(modes(n, "profiler"))
    spans.clear()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
