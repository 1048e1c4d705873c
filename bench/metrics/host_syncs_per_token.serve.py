"""The engine's own ``stats["host_syncs"]`` counted over the window (one
per prefill group, one per superstep), per generated token."""


def read(ctx, peaks):
    if ctx.get("kind") != "serve" or not ctx["tokens"]:
        return None
    return ctx["host_syncs"] / ctx["tokens"]
