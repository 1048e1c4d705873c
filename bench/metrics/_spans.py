"""The program's spans (``repro_torch.spans``) kept while the traced
window's profiler ran, and the card's busy time inside the profiler's
copies of them, for the readers beside this file."""
import bisect


def named(name: str):
    """The kept spans called ``name``; None where there are none, or
    where the program records no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    got = [s for s in spans.recorded() if s.name == name]
    return got or None


def busy_in(tr, name: str):
    """Seconds the card was busy with the work of the host ranges called
    ``name`` (the profiler's copies of the spans): each range's device
    spans that start inside it, taken whole, their union summed over the
    ranges. None where the trace holds no such range."""
    ranges = sorted((a, b) for a, b, n in tr.host if n == name)
    if not ranges:
        return None
    starts = [s[0] for s in tr.dev]
    busy = 0.0
    for a, b in ranges:
        end = float("-inf")
        for d0, d1, _ in tr.dev[bisect.bisect_left(starts, a):
                                bisect.bisect_right(starts, b)]:
            if d1 > end:
                busy += d1 - max(d0, end)
                end = d1
    return busy * 1e-6
