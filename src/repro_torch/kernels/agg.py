"""The three GradAgg kernels of the device ledger, and their plain forms.

Each Pallas kernel of ``repro/kernels/agg.py`` has a CUDA C++ kernel for
Hopper in ``csrc/agg.cu`` and a plain torch form here:

=====================  ============================  =====================
wrapper (CUDA kernel)  replaces (TPU kernel)         plain torch form
=====================  ============================  =====================
masked_cge_reduce      agg.py:masked_cge_reduce      masked_cge_dot
trimmed_mean_tiled     agg.py:trimmed_mean_tiled     trimmed_mean_running
dequant_accum          agg.py:dequant_accum          dequant_dot
=====================  ============================  =====================

A wrapper launches its kernel and raises for a tensor that is not on a
card; ``kernels/ops.py`` decides between a wrapper and its plain form by
the tensor's device. ``LAUNCHES`` counts kernel launches per wrapper (the
CGE wrapper launches three kernels per call: norms, keep-set, masked
sum).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.gradagg import cge_mask_from_norms
from repro_torch.kernels import _build

BIG = 1e30          # matches gradagg.BIG (received-masking sentinel)
TRIM_MAX_N = 32     # the trimmed-mean kernel holds a column in registers
MAX_N = 4096        # the other kernels list the agents in shared memory

LAUNCHES = {"masked_cge_reduce": 0, "trimmed_mean_tiled": 0,
            "dequant_accum": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "agg_norm_tile": (_I, []),
    "agg_cge_partial_norms": (_I, [_P, _P, _I, _L, _I, _P, _P]),
    "agg_cge_keep": (_I, [_P, _P, _I, _I, _I, _P, _P]),
    "agg_cge_masked_sum": (_I, [_P, _P, _I, _L, _P, _P]),
    "agg_trimmed_mean": (_I, [_P, _P, _I, _L, _I, _P, _P]),
    "agg_dequant_accum": (_I, [_P, _P, _P, _I, _L, _P, _P]),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain torch forms


def masked_sum_dot(g, received):
    """Masked agent-axis sum as a (n,) @ (n, P) matvec: the sum/mean
    device twins (same math as ``gradagg.agg_sum``)."""
    return received.to(torch.float32) @ g.to(torch.float32)


def row_norms(g):
    """Per-agent (row) L2 norms of a flat ledger block, f32."""
    return torch.linalg.vector_norm(g.to(torch.float32), dim=1)


def masked_cge_dot(g, received, f: int):
    """Plain form of :func:`masked_cge_reduce`: per-agent norms, the
    shared ``cge_mask_from_norms`` keep-set, then the masked matvec."""
    keep = cge_mask_from_norms(row_norms(g), received, f)
    return keep.to(torch.float32) @ g.to(torch.float32)


def _running_cut(lo, hi, f: int):
    """Sum of the f smallest + f largest entries per column of ``lo``/
    ``hi`` (received-masked to +/-BIG), extracted one occurrence per
    round, first occurrence by agent id — exactly sort semantics under
    duplicates."""
    n = lo.shape[0]
    ids = torch.arange(n, device=lo.device)[:, None].expand_as(lo)
    cut = torch.zeros(lo.shape[1:], dtype=lo.dtype, device=lo.device)
    for _ in range(f):
        mn = torch.amin(lo, dim=0)
        mx = torch.amax(hi, dim=0)
        cut += mn + mx
        first_mn = torch.amin(torch.where(lo == mn[None, :], ids, n), dim=0)
        lo = torch.where(ids == first_mn[None, :], BIG, lo)
        first_mx = torch.amin(torch.where(hi == mx[None, :], ids, n), dim=0)
        hi = torch.where(ids == first_mx[None, :], -BIG, hi)
    return cut


def trimmed_mean_running(g, received, f: int):
    """Plain form of :func:`trimmed_mean_tiled`: the same f rounds of
    min/max extraction, vectorized over the full P axis."""
    rx = received[:, None]
    x = g.to(torch.float32)
    m = torch.sum(received.to(torch.int64))
    ssum = torch.sum(torch.where(rx, x, 0.0), dim=0)
    cut = _running_cut(torch.where(rx, x, BIG), torch.where(rx, x, -BIG), f)
    cnt = m - 2 * f
    num = torch.where(cnt > 0, ssum - cut, 0.0)
    return num / torch.clamp(cnt, min=1).to(torch.float32)


def dequant_dot(q, scale, received):
    """Plain form of :func:`dequant_accum`: scale and mask folded into one
    weight vector, then a matvec over the widened payload."""
    w = scale.to(torch.float32) * received.to(torch.float32)
    return w @ q.to(torch.float32)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers


def _lib() -> ctypes.CDLL:
    return _build.load("agg", _SIGNATURES)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")


def _check_ledger(g, received, dtype, max_n: int, name: str):
    if g.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {g.device}")
    if g.dim() != 2 or g.dtype != dtype or not g.is_contiguous():
        raise ValueError(f"{name}: g must be a contiguous (n, P) {dtype} "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    n = g.shape[0]
    if not 1 <= n <= max_n:
        raise ValueError(f"{name}: n={n} agents outside [1, {max_n}]")
    if (received.shape != (n,) or received.dtype != torch.bool
            or received.device != g.device):
        raise ValueError(f"{name}: received must be an ({n},) bool tensor "
                         f"on {g.device}")
    return received.contiguous()


def masked_cge_reduce(g, received, f: int):
    """g: (n, P) f32, received: (n,) bool -> (P,) f32 — sum of the m-f
    smallest-norm received rows (CGE filter, paper eq. (18))."""
    rx = _check_ledger(g, received, torch.float32, MAX_N,
                       "masked_cge_reduce")
    n, p = g.shape
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    if p == 0:
        return out
    lib = _lib()
    nblk = -(-p // lib.agg_norm_tile())
    partial = torch.empty((n, nblk), dtype=torch.float32, device=g.device)
    keep = torch.empty(n, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib.agg_cge_partial_norms(g.data_ptr(), rx.data_ptr(), n, p,
                                         nblk, partial.data_ptr(), stream),
               "agg_cge_partial_norms")
        LAUNCHES["masked_cge_reduce"] += 1
        _check(lib.agg_cge_keep(partial.data_ptr(), rx.data_ptr(), n, nblk,
                                int(f), keep.data_ptr(), stream),
               "agg_cge_keep")
        LAUNCHES["masked_cge_reduce"] += 1
        _check(lib.agg_cge_masked_sum(g.data_ptr(), keep.data_ptr(), n, p,
                                      out.data_ptr(), stream),
               "agg_cge_masked_sum")
        LAUNCHES["masked_cge_reduce"] += 1
    return out


def trimmed_mean_tiled(g, received, f: int):
    """g: (n, P) f32, received: (n,) bool -> (P,) f32 — per coordinate,
    drop the f largest and f smallest received values, average the rest;
    0 where m - 2f <= 0."""
    rx = _check_ledger(g, received, torch.float32, TRIM_MAX_N,
                       "trimmed_mean_tiled")
    n, p = g.shape
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    if p == 0:
        return out
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_trimmed_mean(g.data_ptr(), rx.data_ptr(), n, p,
                                       int(f), out.data_ptr(), stream),
               "agg_trimmed_mean")
        LAUNCHES["trimmed_mean_tiled"] += 1
    return out


def dequant_accum(q, scale, received):
    """q: (n, P) int8, scale: (n,) f32, received: (n,) bool -> (P,) f32:
    sum over received rows of q * scale, accumulated in f32."""
    rx = _check_ledger(q, received, torch.int8, MAX_N, "dequant_accum")
    n, p = q.shape
    if (scale.shape != (n,) or scale.dtype != torch.float32
            or scale.device != q.device):
        raise ValueError(f"dequant_accum: scale must be an ({n},) f32 "
                         f"tensor on {q.device}")
    scale = scale.contiguous()
    out = torch.empty(p, dtype=torch.float32, device=q.device)
    if p == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_dequant_accum(q.data_ptr(), scale.data_ptr(),
                                        rx.data_ptr(), n, p, out.data_ptr(),
                                        stream),
               "agg_dequant_accum")
        LAUNCHES["dequant_accum"] += 1
    return out
