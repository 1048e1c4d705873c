"""Decode steps a superstep ran (``k`` of the program's
``serve.superstep`` spans, the least budget left among the live slots,
capped by ``superstep_k``), averaged over the traced window's
supersteps: how often the host is consulted per decode."""
from pathlib import Path

import spec

_spans = spec.load_module(Path(__file__).with_name("_spans.py"),
                         "bench_metric_spans")


def read(ctx, peaks):
    s = _spans.named("serve.superstep") if ctx.get("kind") == "serve" else None
    if s is None:
        return None
    return sum(x.counts["k"] for x in s) / len(s)
