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
(:func:`cge_plan`, :func:`trimmed_plan`, :func:`dequant_plan`) are pure
functions of the shapes, the card's SM count and its shared-memory limit
(and, for ``dequant_accum``, the payload's base address), computed here
and handed to the kernels, so the plan the CPU tests check is the plan
the card runs; :func:`row_segments` is the kernels' split of a row
segment into plain-loaded edges and a 16-byte-aligned bulk interior.
Every kernel takes any number of agents: where the per-agent lists or
the rows do not fit in shared memory, the plan moves them to a device
workspace or reads the rows straight from device memory.
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
SMEM_LIMIT = 232_448    # shared memory a block may ask for on an H100
SMEM_HEADER = 192   # kHeader: a kernel's mbarriers, counters, warp totals
CGE_CHUNKS = 4      # kMaxChunks: held chunks of a CGE share, one mbarrier each
CGE_LISTS = 5       # per-agent lists of the CGE kernel: rows, off, koff, krow, key
TRIM_STAGES = 3     # kMaxStages: the trimmed-mean ring's stages, at most
DQ_THREADS = 128    # kDqThreads: threads per block of dequant_accum
DQ_BLOCKS_PER_SM = 4   # dequant_accum blocks an SM takes at once

LAUNCHES = {"masked_cge_reduce": 0, "trimmed_mean_tiled": 0,
            "dequant_accum": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "agg_smem_optin": (_I, [_I]),
    "agg_masked_cge": (_I, [_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P]),
    "agg_trimmed_mean": (_I, [_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P,
                              _P]),
    "agg_dequant_accum": (_I, [_P, _P, _P, _I, _L, _I, _I, _I, _P, _P]),
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
    ``held[m]`` from ``budget`` as this module does, once it knows m.
    With ``workspace`` the per-agent lists live in a device workspace of
    ``CGE_LISTS * n`` ints per block, not in shared memory."""
    grid: int
    share: int
    chunk: int
    budget: int           # bytes for the held rows, after the header
    held: tuple           # (n + 1,) columns held per share, by m
    smem_bytes: int       # dynamic shared memory per block, the most any m needs
    workspace: bool       # the per-agent lists in device memory
    header: int           # bytes before the held rows


def cge_header(n: int) -> int:
    """Bytes before the held rows in ``masked_cge_kernel``'s shared memory:
    the header, then the received rows, their offsets, the kept rows'
    offsets and indices (int) and the keys (f32) of n agents, rounded up
    to 16."""
    return (SMEM_HEADER + 4 * CGE_LISTS * n + 15) // 16 * 16


def _held(budget: int, m: int, share: int) -> int:
    """Columns, a multiple of 4, whose m rows of ``held + 4`` words fit in
    ``budget`` bytes, at most ``share`` (the kernel's ``hb``)."""
    return max(0, min(share, (budget // (4 * m) - 4) // 4 * 4))


@functools.lru_cache(maxsize=None)
def cge_plan(n: int, p: int, n_sm: int,
             smem_limit: int = SMEM_LIMIT) -> CgePlan:
    """The CGE kernel's plan for n agents and P columns on a card of
    ``n_sm`` SMs. ``held[m]`` is the most columns, a multiple of 4, whose
    m rows fit beside the header; where that is the whole share the stack
    is read from device memory once (m = 17 at the paper's shape). Where
    the per-agent lists leave no room for 4 columns of every row (above
    about 4,460 agents on an H100) they move to a device workspace and
    shared memory holds rows only."""
    if min(n, p, n_sm) < 1:
        raise ValueError(f"cge_plan: n={n}, P={p}, SMs={n_sm} must be >= 1")
    share, grid = _shares(p, n_sm)
    workspace = _held(smem_limit - cge_header(n), n, 4) < 4
    header = SMEM_HEADER if workspace else cge_header(n)
    budget = smem_limit - header
    held = [0] + [_held(budget, m, share)
                  for m in range(1, n + 1)]     # m = 0 reads nothing
    data = max((m * (h + 4) * 4 for m, h in enumerate(held) if h > 0),
               default=0)
    return CgePlan(grid=grid, share=share,
                   chunk=_round4(_cdiv(share, CGE_CHUNKS)), budget=budget,
                   held=tuple(held), smem_bytes=header + data,
                   workspace=workspace, header=header)


@dataclasses.dataclass(frozen=True)
class TrimPlan:
    """``grid`` blocks of ``trimmed_mean_kernel``: block b walks columns
    [b * share, min((b + 1) * share, P)) in chunks of ``chunk`` columns
    through a ring of ``stages`` buffers of n rows of ``chunk + 4``
    words. ``stages == 0``: no ring, the block reads the received rows of
    its share straight from device memory, in agent order."""
    grid: int
    share: int
    chunk: int
    stages: int
    smem_bytes: int


def trimmed_header(n: int) -> int:
    """Bytes before the ring in ``trimmed_mean_kernel``'s shared memory:
    the header, then the received rows and their offsets (int) of n
    agents, rounded up to 16."""
    return (SMEM_HEADER + 8 * n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def trimmed_plan(n: int, p: int, n_sm: int,
                 smem_limit: int = SMEM_LIMIT) -> TrimPlan:
    """The trimmed-mean kernel's plan: chunks of about a quarter of a
    share, at most so wide that two stages of n rows fit, and up to
    ``TRIM_STAGES`` stages in flight. Where two stages of 4 columns do
    not fit, one stage of at least 4 columns (n = 4096: 8 columns); where
    not even that fits (above about 5,800 agents on an H100), no ring."""
    if min(n, p, n_sm) < 1:
        raise ValueError(f"trimmed_plan: n={n}, P={p}, SMs={n_sm} must be "
                         ">= 1")
    share, grid = _shares(p, n_sm)
    budget = smem_limit - trimmed_header(n)
    for ring in (2, 1):
        cap = (budget // (ring * 4 * n) - 4) // 4 * 4
        if cap >= 4:
            break
    else:
        return TrimPlan(grid=grid, share=share, chunk=share, stages=0,
                        smem_bytes=SMEM_HEADER)
    chunk = min(_round4(_cdiv(share, 4)), cap)
    stage = n * (chunk + 4) * 4
    stages = min(TRIM_STAGES, _cdiv(share, chunk), budget // stage)
    return TrimPlan(grid=grid, share=share, chunk=chunk, stages=stages,
                    smem_bytes=trimmed_header(n) + stages * stage)


@dataclasses.dataclass(frozen=True)
class DequantPlan:
    """``grid`` blocks of ``DQ_THREADS`` threads of ``dequant_accum_kernel``:
    block b takes columns [b * share, min((b + 1) * share, P)); a thread
    sums ``cols`` adjacent columns at a time, reading each received row's
    bytes of them with loads of ``vec`` bytes."""
    vec: int
    cols: int
    grid: int
    share: int


@functools.lru_cache(maxsize=None)
def dequant_plan(n: int, p: int, base: int, n_sm: int) -> DequantPlan:
    """The dequant kernel's plan for an (n, P) int8 payload at address
    ``base`` (only ``base % 16`` matters): ``vec`` is the largest of 16,
    8, 4 and 1 bytes to which every row ``base + i * P`` is aligned
    (P = 431,080 is 8 mod 16: 8 bytes), a thread's columns are
    ``max(vec, 4)`` (one f32 ``float4`` store or more), and
    ``DQ_BLOCKS_PER_SM`` blocks per SM split the columns evenly, each
    with at least a warp's worth of them."""
    if min(n, p, n_sm) < 1:
        raise ValueError(f"dequant_plan: n={n}, P={p}, SMs={n_sm} must be "
                         ">= 1")
    vec = next(v for v in (16, 8, 4, 1)
               if base % v == 0 and (n == 1 or p % v == 0))
    cols = max(vec, 4)
    groups = _cdiv(p, cols)
    grid = min(n_sm * DQ_BLOCKS_PER_SM, _cdiv(groups, 32))
    share = cols * _cdiv(groups, grid)
    return DequantPlan(vec=vec, cols=cols, grid=_cdiv(p, share), share=share)


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


def _check_ledger(g, received, dtype, name: str):
    if g.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {g.device}")
    if g.dim() != 2 or g.dtype != dtype or not g.is_contiguous():
        raise ValueError(f"{name}: g must be a contiguous (n, P) {dtype} "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    n = g.shape[0]
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
    rx = _check_ledger(g, received, torch.float32, "masked_cge_reduce")
    n, p = g.shape
    if n == 0 or p == 0:                # no agent or no column: nothing to read
        return torch.zeros(p, dtype=torch.float32, device=g.device)
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    plan = cge_plan(n, p, *card_limits(g.device))
    partial = torch.empty(n * plan.grid, dtype=torch.float32,
                          device=g.device)
    ws = (torch.empty(CGE_LISTS * n * plan.grid, dtype=torch.int32,
                      device=g.device) if plan.workspace else None)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_masked_cge(g.data_ptr(), rx.data_ptr(), n, p,
                                     int(f), plan.grid, plan.share,
                                     plan.chunk, plan.budget,
                                     plan.smem_bytes, partial.data_ptr(),
                                     None if ws is None else ws.data_ptr(),
                                     out.data_ptr(), stream),
               "agg_masked_cge")
        LAUNCHES["masked_cge_reduce"] += 1
    return out


def trimmed_mean_tiled(g, received, f: int):
    """g: (n, P) f32, received: (n,) bool -> (P,) f32 — per coordinate,
    drop the f largest and f smallest received values, average the rest;
    0 where m - 2f <= 0 (:func:`trimmed_plan`)."""
    rx = _check_ledger(g, received, torch.float32, "trimmed_mean_tiled")
    n, p = g.shape
    if n == 0 or p == 0:
        return torch.zeros(p, dtype=torch.float32, device=g.device)
    out = torch.empty(p, dtype=torch.float32, device=g.device)
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
    sum over received rows of q * scale, accumulated in f32 in agent
    order (:func:`dequant_plan`)."""
    rx = _check_ledger(q, received, torch.int8, "dequant_accum")
    n, p = q.shape
    if (scale.shape != (n,) or scale.dtype != torch.float32
            or scale.device != q.device):
        raise ValueError(f"dequant_accum: scale must be an ({n},) f32 "
                         f"tensor on {q.device}")
    if n == 0 or p == 0:
        return torch.zeros(p, dtype=torch.float32, device=q.device)
    scale = scale.contiguous()
    out = torch.empty(p, dtype=torch.float32, device=q.device)
    plan = dequant_plan(n, p, q.data_ptr() % 16, card_limits(q.device)[0])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().agg_dequant_accum(q.data_ptr(), scale.data_ptr(),
                                        rx.data_ptr(), n, p, plan.vec,
                                        plan.grid, plan.share,
                                        out.data_ptr(), stream),
               "agg_dequant_accum")
        LAUNCHES["dequant_accum"] += 1
    return out
