"""Share of the traced window in which the card runs nothing while the
host is inside the engine's ``step()`` and not waiting on the card: the
profiler's host ranges ``serve.step`` less its ``serve.sync`` ranges,
less the union of the device's spans, over the window, in percent.
Beside ``idle_share.serve`` it splits the card's idle time between the
engine's host work and what runs outside ``step()`` (the client loop)."""


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _less(xs, ys):
    """The parts of the disjoint sorted intervals ``xs`` outside the
    disjoint sorted intervals ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def read(ctx, peaks):
    tr = ctx.get("tracer")
    if ctx.get("kind") != "serve" or tr is None or not tr.window_s:
        return None
    steps = _union((a, b) for a, b, n in tr.host if n == "serve.step")
    if not steps:
        return None
    syncs = _union((a, b) for a, b, n in tr.host if n == "serve.sync")
    busy = _union((a, b) for a, b, _ in tr.dev)
    idle = _less(_less(steps, syncs), busy)
    return 100.0 * sum(b - a for a, b in idle) * 1e-6 / tr.window_s
