"""Flash-decode over a paged KV cache: the CUDA kernel and its plain form.

The Pallas kernel ``repro/kernels/decode_attention.py:paged_flash_decode``
carries every GQA decode step of the serving engine. Here it is the CUDA
C++ kernel of ``csrc/decode_attention.cu`` (see its header for the
design), behind the wrapper :func:`paged_flash_decode`, with the plain
torch form :func:`paged_decode_plain` beside it:

=====================  =========================================  ==================
wrapper (CUDA kernel)  replaces (TPU kernel)                      plain torch form
=====================  =========================================  ==================
paged_flash_decode     decode_attention.py:paged_flash_decode     paged_decode_plain
=====================  =========================================  ==================

The wrapper launches the kernel and raises for a tensor that is not on a
card; ``kernels/ops.py`` decides between it and the plain form by the
tensor's device. ``LAUNCHES`` counts calls of the wrapper that launched
the kernel: one call is two CUDA launches, the split partials and their
combine. :func:`split_plan` decides the split from the shapes alone.

:func:`tp_paged_decode` is the tensor-parallel decode: each rank of the
mesh's tp axes runs the kernel (or the plain form) on its own KV-head
block, with the split plan of the *unsharded* Hkv, so each head is
walked exactly as in the replicated engine, and one all-reduce of
``-0.0``-padded head blocks puts the ``(B, H, Dv)`` output together on
every rank, bit for bit. It is a wrapper, not a kernel of its own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.ref import NEG_INF

MAX_G = 8           # query heads per KV head (kMaxG in the kernel)
MAX_D = 128         # head dim of q/k and of v (kMaxD in the kernel)
SPLIT_TOKENS = 64   # fewest tokens a split walks, where Pmax allows more
BLOCKS_PER_SM = 2   # split blocks the plan aims for on each SM

LAUNCHES = {"paged_flash_decode": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_decode": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _I, _P]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    _launches.reset(LAUNCHES)


def paged_decode_plain(q, k_pages, v_pages, page_table, kv_lens):
    """Plain form of :func:`paged_flash_decode`: the oracle's grouped
    gather and full f32 softmax, as batched matmuls with masked fills.

    q: (B, H, D); k_pages: (N, PS, Hkv, D); v_pages: (N, PS, Hkv, Dv);
    page_table: (B, Pmax) int; kv_lens: (B,) int -> (B, H, Dv) in q's
    dtype. Table entries clamp into the pool; kv_len == 0 gives zeros.
    """
    b, h, d = q.shape
    n, ps, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    tbl = page_table.long().clamp(0, n - 1)
    t = tbl.shape[1] * ps
    # (B, Hkv, T, D) and (B, Hkv, T, Dv) in f32
    k = k_pages[tbl].reshape(b, t, hkv, d).transpose(1, 2).float()
    v = v_pages[tbl].reshape(b, t, hkv, dv).transpose(1, 2).float()
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.matmul(qg, k.transpose(-1, -2)) * (d ** -0.5)  # (B,Hkv,G,T)
    valid = (torch.arange(t, device=q.device)[None, :]
             < kv_lens.long()[:, None])                       # (B, T)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1) * valid.any(dim=1)[:, None, None, None]
    return torch.matmul(w, v).reshape(b, h, dv).to(q.dtype)


def split_plan(b: int, hkv: int, pmax: int, page_size: int,
               n_sm: int) -> tuple[int, int]:
    """(n_split, pages_per_split) of the kernel's split-K walk: split s
    takes pages [s * pages_per_split, (s + 1) * pages_per_split) of each
    sequence's table, and the splits cover [0, Pmax) exactly once.

    A function of the shapes and the card's SM count only, never of
    kv_lens or the table: they live on the card, so reading them would
    cost a sync, and the order of the sum stays the same whatever they
    hold (stale table entries change nothing, bit for bit). It aims for
    ``BLOCKS_PER_SM`` blocks of (sequence,
    KV head, split) on each SM, with splits of at least ``SPLIT_TOKENS``
    tokens (one page if a page holds more).
    """
    if min(b, hkv, pmax, page_size, n_sm) < 1:
        raise ValueError(f"split_plan: B={b}, Hkv={hkv}, Pmax={pmax}, "
                         f"PS={page_size}, SMs={n_sm} must be >= 1")
    min_pages = -(-SPLIT_TOKENS // page_size)
    want = -(-BLOCKS_PER_SM * n_sm // (b * hkv))
    n_split = max(1, min(want, -(-pmax // min_pages)))
    per = -(-pmax // n_split)
    return -(-pmax // per), per


# ---------------------------------------------------------------------------
# CUDA kernel wrapper


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k_pages, v_pages, page_table, kv_lens) -> None:
    name = "paged_flash_decode"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    for t, what in ((k_pages, "k_pages"), (v_pages, "v_pages"),
                    (page_table, "page_table"), (kv_lens, "kv_lens")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
    for t, what in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages"),
                    (page_table, "page_table"), (kv_lens, "kv_lens")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"{name}: q, k_pages and v_pages must share a "
                         f"dtype, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError(f"{name}: want q (B, H, D) and pages "
                         "(N, PS, Hkv, D|Dv)")
    b, h, d = q.shape
    n, ps, hkv, dk = k_pages.shape
    dv = v_pages.shape[-1]
    if dk != d or tuple(v_pages.shape[:3]) != (n, ps, hkv):
        raise ValueError(f"{name}: k_pages {tuple(k_pages.shape)} and "
                         f"v_pages {tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"{name}: H={h} must be a multiple of Hkv={hkv}")
    if h // hkv > MAX_G:
        raise ValueError(f"{name}: {h // hkv} query heads per KV head, at "
                         f"most {MAX_G}")
    if d % 8 or dv % 8 or not 0 < d <= MAX_D or not 0 < dv <= MAX_D:
        raise ValueError(f"{name}: D={d} and Dv={dv} must be multiples of "
                         f"8, at most {MAX_D}")
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.shape[1] < 1 or page_table.dtype != torch.int32):
        raise ValueError(f"{name}: page_table must be ({b}, Pmax) int32")
    if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"{name}: kv_lens must be ({b},) int32")
    for t, what in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")


def paged_flash_decode(q, k_pages, v_pages, page_table, kv_lens,
                       plan_hkv: Optional[int] = None):
    """q: (B, H, D); k_pages: (N, PS, Hkv, D); v_pages: (N, PS, Hkv, Dv);
    page_table: (B, Pmax) int32; kv_lens: (B,) int32 -> (B, H, Dv) in
    q's dtype. Head h reads KV head h // (H // Hkv); table entries past a
    sequence's length may be -1 or stale (they read page 0, masked).
    ``plan_hkv`` (default Hkv) is the KV-head count the split plan is
    made for: a tensor-parallel shard passes the unsharded count, so its
    heads split exactly as the whole pool's do."""
    _check(q, k_pages, v_pages, page_table, kv_lens)
    b, h, d = q.shape
    n, ps, hkv, dv = v_pages.shape
    pmax = page_table.shape[1]
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    n_split, per = split_plan(b, plan_hkv or hkv, pmax, ps,
                              _sm_count(q.device))
    # per (sequence, KV head, split): m (G), l (G), acc (G, Dv) in f32
    part = torch.empty(b * hkv * n_split * (h // hkv) * (dv + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_lens.data_ptr(), part.data_ptr(),
            out.data_ptr(), b, h, hkv, d, dv, n, ps, pmax, n_split, per,
            d ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    _launches.count(LAUNCHES, "paged_flash_decode")
    return out


# ---------------------------------------------------------------------------
# tensor-parallel decode


def tp_paged_decode(q, k_pages, v_pages, page_table, kv_lens, *, mesh,
                    kv_block, n_kv_heads: int, tp_axes=("model",),
                    impl: str = "auto"):
    """Tensor-parallel grouped paged decode, called on every rank of
    ``mesh``.

    q: (B, H, D), the same on every rank; ``kv_block = (h0, h1)``: this
    rank's KV-head block of the ``n_kv_heads`` (as
    ``dist.sharding.kv_head_block`` decides it), which k_pages/v_pages
    ``(N, PS, h1 - h0, D|Dv)`` hold; page_table/kv_lens the same on every
    rank. ``kv_block=None``: the pools hold every head, and the unsharded
    dispatcher runs with no collective.

    Each rank runs the grouped decode on its KV-head block and the G
    query heads each carries (G = H / n_kv_heads), with the split plan of
    the unsharded ``n_kv_heads``: GQA has no cross-KV-head reduction, so
    each head's output is the replicated engine's, bit for bit. The head
    blocks then meet in one all-reduce over the tp axes, every other
    block ``-0.0`` (``x + -0.0 == x``), so the ``(B, H, Dv)`` output is
    the same on every rank and the ``wo`` projection that follows runs
    as in the replicated engine.
    """
    from repro_torch.kernels import ops     # ops imports this module
    if kv_block is None:
        return ops.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          kv_lens, impl=impl)
    b, h, _ = q.shape
    h0, h1 = kv_block
    if k_pages.shape[2] != h1 - h0:
        raise ValueError(f"tp_paged_decode: pools hold {k_pages.shape[2]} "
                         f"KV heads, the block {kv_block} {h1 - h0}")
    g = h // n_kv_heads
    heads = slice(h0 * g, h1 * g)
    out_loc = ops.paged_decode_attention(
        q[:, heads].contiguous(), k_pages, v_pages, page_table, kv_lens,
        impl=impl, plan_hkv=n_kv_heads)
    full = torch.full((b, h, out_loc.shape[-1]), -0.0, dtype=out_loc.dtype,
                      device=out_loc.device)
    full[:, heads] = out_loc
    return mesh.all_reduce(full, tp_axes)
