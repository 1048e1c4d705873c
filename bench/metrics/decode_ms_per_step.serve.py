"""The card's busy time in the engine's supersteps over the decode steps
they ran, in ms a decode step: the device spans that start inside the
profiler's ``serve.superstep`` ranges (each ends after its sync, so its
kernels run inside it), their union, over the sum of the program's
``serve.superstep`` spans' ``k``. The host's pacing between kernels is
not counted: that is the card idle."""
from pathlib import Path

import spec

_spans = spec.load_module(Path(__file__).with_name("_spans.py"),
                         "bench_metric_spans")


def read(ctx, peaks):
    tr = ctx.get("tracer")
    if ctx.get("kind") != "serve" or tr is None:
        return None
    s = _spans.named("serve.superstep")
    busy = _spans.busy_in(tr, "serve.superstep")
    if s is None or busy is None:
        return None
    k = sum(x.counts["k"] for x in s)
    return 1e3 * busy / k if k else None
