"""Median device time of a training step's update (the program's
``train.update`` spans: clipping, the optimizer and ``apply_updates``,
timed by CUDA events on the stream), in ms. The host launches the step
ahead of the card and does not wait inside the update, so the events
mark the card's own start and end of that work."""
import statistics
from pathlib import Path

import spec

_spans = spec.load_module(Path(__file__).with_name("_spans.py"),
                         "bench_metric_spans")


def read(ctx, peaks):
    u = _spans.named("train.update") if ctx.get("kind") == "train" else None
    if u is None or any(s.device_ms is None for s in u):
        return None
    return statistics.median(s.device_ms for s in u)
