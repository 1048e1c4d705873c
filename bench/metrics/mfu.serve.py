"""Model FLOPs of the prompt and generated tokens the engine processed in
the window (prefills and decodes, ``flops.prefill_flops`` and
``flops.decode_flops``; an MoE layer its top-k experts), over the window
and the card's bf16 peak, in percent."""


def read(ctx, peaks):
    if ctx.get("kind") != "serve" or not ctx["window_s"]:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / peaks["bf16_flops"]
