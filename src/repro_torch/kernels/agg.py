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
the tensor's device. ``LAUNCHES`` counts kernel launches per wrapper, one
per call each.

The CGE and trimmed-mean kernels stage the received rows of a column
share into shared memory with bulk asynchronous copies. Their plans
(:func:`cge_plan`, :func:`trimmed_plan`) are pure functions of the
shapes, the card's SM count and its shared-memory limit, computed here
and handed to the kernels, so the plan the CPU tests check is the plan
the card runs; :func:`row_segments` is the kernels' split of a row
segment into plain-loaded edges and a 16-byte-aligned bulk interior.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.gradagg import cge_mask_from_norms
from repro_torch.kernels import _build

BIG = 1e30          # matches gradagg.BIG (received-masking sentinel)
TRIM_MAX_N = 32     # the trimmed-mean kernel holds a column in registers
MAX_N = 4096        # the other kernels list the agents in shared memory
SMEM_LIMIT = 232_448    # shared memory a block may ask for on an H100
SMEM_HEADER = 64    # kHeader: a kernel's mbarriers and counters
CGE_CHUNKS = 4      # kMaxChunks: held chunks of a CGE share, one mbarrier each
TRIM_STAGES = 3     # kMaxStages: the trimmed-mean ring's stages, at most
TRIM_HEADER = SMEM_HEADER + 8 * TRIM_MAX_N  # + the rows and their offsets

LAUNCHES = {"masked_cge_reduce": 0, "trimmed_mean_tiled": 0,
            "dequant_accum": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "agg_smem_optin": (_I, [_I]),
    "agg_masked_cge": (_I, [_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P]),
    "agg_trimmed_mean": (_I, [_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P,
                              _P]),
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
# the kernels' plans


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shares(p: int, n_sm: int) -> tuple[int, int]:
    """(share, grid): columns per block, a multiple of 4 so every share
    starts on a 16-byte line wherever its row does, and the blocks that
    cover [0, p), at most one per SM. The last share may be shorter."""
    share = 4 * _cdiv(_cdiv(p, 4), n_sm)
    return share, _cdiv(p, share)


def _round4(x: int) -> int:
    """x rounded up to a multiple of 4."""
    return 4 * _cdiv(x, 4)


def row_shift(base_word: int, row: int, p: int, c: int) -> int:
    """Word offset of element (row, c) within its 16-byte line, for an
    (n, p) f32 tensor whose first element lies at word ``base_word`` (its
    address / 4). Works on ints and on numpy integer arrays alike."""
    return (base_word + row * p + c) % 4


def row_segments(shift: int, width: int) -> tuple[int, int, int]:
    """(head, bulk, tail) of a row segment of ``width`` columns whose first
    column has word offset ``shift``: ``head`` columns by plain loads up to
    the first 16-byte line, ``bulk`` (a multiple of 4) by one bulk copy,
    ``tail`` (at most 3) by plain loads (``seg_head`` and ``stage_rows``
    in ``csrc/agg.cu``). Works on ints and on numpy integer arrays."""
    head = np.minimum((4 - shift) % 4, width)
    bulk = (width - head) // 4 * 4
    return head, bulk, width - head - bulk


@dataclasses.dataclass(frozen=True)
class CgePlan:
    """One cooperative launch of ``grid`` blocks of ``masked_cge_kernel``:
    block b takes columns [b * share, min((b + 1) * share, P)); with m rows
    received it holds the first ``held[m]`` of them on chip in chunks of
    ``chunk`` columns (one row of a share at ``held[m] + 4`` words, the 4
    absorbing the row's offset within its 16-byte line) and reads the
    rest again from device memory for the masked sum. The kernel derives
    ``held[m]`` from ``budget`` as this module does, once it knows m."""
    grid: int
    share: int
    chunk: int
    budget: int           # bytes for the held rows, after the header
    held: tuple           # (n + 1,) columns held per share, by m
    smem_bytes: int       # dynamic shared memory per block, the most any m needs


def cge_header(n: int) -> int:
    """Bytes before the held rows in ``masked_cge_kernel``'s shared memory:
    the header, then the received rows, their offsets, the kept rows'
    offsets and indices (int) and the keys (f32) of n agents, rounded up
    to 16."""
    return (SMEM_HEADER + 20 * n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def cge_plan(n: int, p: int, n_sm: int,
             smem_limit: int = SMEM_LIMIT) -> CgePlan:
    """The CGE kernel's plan for n agents and P columns on a card of
    ``n_sm`` SMs. ``held[m]`` is the most columns, a multiple of 4, whose
    m rows fit beside the header; where that is the whole share the stack
    is read from device memory once (m = 17 at the paper's shape)."""
    if min(n, p, n_sm) < 1:
        raise ValueError(f"cge_plan: n={n}, P={p}, SMs={n_sm} must be >= 1")
    share, grid = _shares(p, n_sm)
    budget = smem_limit - cge_header(n)
    held = [0] + [max(0, min(share, (budget // (4 * m) - 4) // 4 * 4))
                  for m in range(1, n + 1)]     # m = 0 reads nothing
    data = max((m * (h + 4) * 4 for m, h in enumerate(held) if h > 0),
               default=0)
    return CgePlan(grid=grid, share=share,
                   chunk=_round4(_cdiv(share, CGE_CHUNKS)), budget=budget,
                   held=tuple(held), smem_bytes=cge_header(n) + data)


@dataclasses.dataclass(frozen=True)
class TrimPlan:
    """``grid`` blocks of ``trimmed_mean_kernel``: block b walks columns
    [b * share, min((b + 1) * share, P)) in chunks of ``chunk`` columns
    through a ring of ``stages`` buffers of n rows of ``chunk + 4``
    words."""
    grid: int
    share: int
    chunk: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def trimmed_plan(n: int, p: int, n_sm: int,
                 smem_limit: int = SMEM_LIMIT) -> TrimPlan:
    """The trimmed-mean kernel's plan: chunks of about a quarter of a
    share, at most so wide that two stages of n rows fit, and up to
    ``TRIM_STAGES`` stages in flight."""
    if min(n, p, n_sm) < 1:
        raise ValueError(f"trimmed_plan: n={n}, P={p}, SMs={n_sm} must be "
                         ">= 1")
    share, grid = _shares(p, n_sm)
    budget = smem_limit - TRIM_HEADER
    cap = (budget // (2 * 4 * n) - 4) // 4 * 4
    chunk = min(_round4(_cdiv(share, 4)), cap)
    stage = n * (chunk + 4) * 4
    stages = min(TRIM_STAGES, _cdiv(share, chunk), budget // stage)
    return TrimPlan(grid=grid, share=share, chunk=chunk, stages=stages,
                    smem_bytes=TRIM_HEADER + stages * stage)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers


def _lib() -> ctypes.CDLL:
    return _build.load("agg", _SIGNATURES)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")


@functools.lru_cache(maxsize=None)
def card_limits(device: torch.device) -> tuple[int, int]:
    """(SM count, shared memory a block may ask for) of a CUDA device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    return (torch.cuda.get_device_properties(idx).multi_processor_count,
            _lib().agg_smem_optin(idx))


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
    smallest-norm received rows (CGE filter, paper eq. (18)), in one
    cooperative launch that reads the received rows once where they fit
    on chip (:func:`cge_plan`)."""
    rx = _check_ledger(g, received, torch.float32, MAX_N,
                       "masked_cge_reduce")
    n, p = g.shape
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    if p == 0:
        return out
    plan = cge_plan(n, p, *card_limits(g.device))
    partial = torch.empty(n * plan.grid, dtype=torch.float32,
                          device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_masked_cge(g.data_ptr(), rx.data_ptr(), n, p,
                                     int(f), plan.grid, plan.share,
                                     plan.chunk, plan.budget,
                                     plan.smem_bytes, partial.data_ptr(),
                                     out.data_ptr(), stream),
               "agg_masked_cge")
        LAUNCHES["masked_cge_reduce"] += 1
    return out


def trimmed_mean_tiled(g, received, f: int):
    """g: (n, P) f32, received: (n,) bool -> (P,) f32 — per coordinate,
    drop the f largest and f smallest received values, average the rest;
    0 where m - 2f <= 0 (:func:`trimmed_plan`)."""
    rx = _check_ledger(g, received, torch.float32, TRIM_MAX_N,
                       "trimmed_mean_tiled")
    n, p = g.shape
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    if p == 0:
        return out
    plan = trimmed_plan(n, p, *card_limits(g.device))
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_trimmed_mean(g.data_ptr(), rx.data_ptr(), n, p,
                                       int(f), plan.grid, plan.share,
                                       plan.chunk, plan.stages,
                                       plan.smem_bytes, out.data_ptr(),
                                       stream),
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
