"""``torch.cuda.max_memory_allocated`` over the window, as a share of the
card's memory, in percent."""


def read(ctx, peaks):
    if ctx.get("kind") != "train" or not ctx.get("total_memory"):
        return None
    return 100.0 * ctx["peak_window_bytes"] / ctx["total_memory"]
