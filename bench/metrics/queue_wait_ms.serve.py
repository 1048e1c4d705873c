"""Median time a request waited before its own admission began, from
its submit to the start of its group's prefill (or of its prefix
admission): the program's ``serve.queued`` spans, one per request
admitted in the traced window, in ms. With that admission it makes up
the request's TTFT. A median: about 30 requests are admitted in the
window, too few for a tail."""
import statistics
from pathlib import Path

import spec

_spans = spec.load_module(Path(__file__).with_name("_spans.py"),
                         "bench_metric_spans")


def read(ctx, peaks):
    q = _spans.named("serve.queued") if ctx.get("kind") == "serve" else None
    if q is None:
        return None
    return statistics.median((s.t1_ns - s.t0_ns) * 1e-6 for s in q)
