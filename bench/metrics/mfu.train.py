"""Model FLOPs of the S^t tokens of the window's whole steps (forward and
backward, ``flops.train_flops_per_token``), over the window and the
card's bf16 peak, in percent."""


def read(ctx, peaks):
    if ctx.get("kind") != "train" or not ctx["window_s"]:
        return None
    return 100.0 * ctx["train_flops"] / ctx["window_s"] / peaks["bf16_flops"]
