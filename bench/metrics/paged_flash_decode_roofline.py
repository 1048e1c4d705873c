"""The paged flash-decode kernel's share of its roofline over the traced
steps: the least time the card could take (each live slot's K and V
context read once, its query read and output written once, over 3.35
TB/s: ``flops.decode_attn_bytes``; the kernel is bound by bytes) over the
device time of the ``paged_decode_`` kernels, the union of the split and
combine spans, which overlap. In percent."""
import flops


def read(ctx, peaks):
    tr = ctx.get("tracer")
    if ctx.get("kind") != "serve" or tr is None:
        return None
    busy = tr.busy_s("paged_decode_")
    if busy <= 0:
        return None
    moved = 0.0
    for _, slots in ctx["steps_log"]:
        for n, ctx0 in slots:
            moved += flops.decode_attn_bytes(ctx["arch"], n,
                                             n * ctx0 + n * (n - 1) / 2)
    if moved <= 0:
        return None
    return 100.0 * moved / peaks["hbm_bytes_per_s"] / busy
