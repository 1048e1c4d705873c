"""Dispatchers for the aggregation kernels, with ``repro.kernels.ops``'s
``impl=`` contract:

- ``"ref"``    the torch oracle (``kernels/ref.py``),
- ``"plain"``  the plain torch form of the kernel (``kernels/agg.py``),
- ``"cuda"``   the CUDA kernel; its wrapper raises for a tensor that is
               not on a card,
- ``"auto"``   decided by the tensor's device: a CUDA tensor gets the
               kernel (or an exception), a CPU tensor the plain form.

This is the one place that decides by device; the wrappers in
``kernels/agg.py`` only launch.
"""
from __future__ import annotations

from repro_torch.kernels import agg as _agg
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "ref", "plain", "cuda")


def _route(impl: str, x) -> str:
    """``impl`` with ``"auto"`` resolved by ``x``'s device."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.device.type == "cuda" else "plain"
    return impl


def masked_cge_reduce(g, received, *, f: int = 0, impl: str = "auto"):
    """CGE aggregate over the (n, P) gradient ledger: per-agent norms +
    keep-set + masked sum (paper eq. (18))."""
    impl = _route(impl, g)
    if impl == "ref":
        return _ref.ref_masked_cge_reduce(g, received, f)
    if impl == "plain":
        return _agg.masked_cge_dot(g, received, f)
    return _agg.masked_cge_reduce(g, received, f)


def trimmed_mean_tiled(g, received, *, f: int = 0, impl: str = "auto"):
    """Coordinate-wise trimmed mean over the (n, P) ledger via running
    min/max extraction; ``impl="ref"`` forces the sort oracle."""
    impl = _route(impl, g)
    if impl == "ref":
        return _ref.ref_trimmed_mean(g, received, f)
    if impl == "plain":
        return _agg.trimmed_mean_running(g, received, f)
    return _agg.trimmed_mean_tiled(g, received, f)


def dequant_accum(q, scale, received, *, impl: str = "auto"):
    """int8 payload x per-agent scale, masked f32 accumulation (the
    quantized rule's server-side reduction)."""
    impl = _route(impl, q)
    if impl == "ref":
        return _ref.ref_dequant_accum(q, scale, received)
    if impl == "plain":
        return _agg.dequant_dot(q, scale, received)
    return _agg.dequant_accum(q, scale, received)
