"""The card's busy time in the engine's prefill calls over the real
prompt tokens they took, in us a token: the device spans that start
inside the profiler's ``serve.prefill`` ranges (the token upload, the
prefill, the copies of its cache into the pages), their union, over the
sum of the program's ``serve.prefill`` spans' ``tokens``."""
from pathlib import Path

import spec

_spans = spec.load_module(Path(__file__).with_name("_spans.py"),
                         "bench_metric_spans")


def read(ctx, peaks):
    tr = ctx.get("tracer")
    if ctx.get("kind") != "serve" or tr is None:
        return None
    p = _spans.named("serve.prefill")
    busy = _spans.busy_in(tr, "serve.prefill")
    if p is None or busy is None:
        return None
    tokens = sum(s.counts["tokens"] for s in p)
    return 1e6 * busy / tokens if tokens else None
