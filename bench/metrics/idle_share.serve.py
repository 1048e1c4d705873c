"""Share of the traced window (whole engine steps) in which no kernel,
copy or set ran on the card, in percent."""


def read(ctx, peaks):
    tr = ctx.get("tracer")
    if ctx.get("kind") != "serve" or tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
