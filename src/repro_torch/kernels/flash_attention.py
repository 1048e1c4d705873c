"""Flash attention, forward: the CUDA kernel and its plain form.

The Pallas kernel ``repro/kernels/flash_attention.py:flash_attention`` is
reached through ``ops.flash_attention``; no model path calls it (the
models attend through ``plain_attention``/``chunked_attention``). Here it
is the CUDA C++ kernel of ``csrc/flash_attention.cu`` (see its header for
the design), behind the wrapper :func:`flash_attention`, with the plain
torch form :func:`flash_attention_plain` beside it:

=====================  =========================================  =====================
wrapper (CUDA kernel)  replaces (TPU kernel)                      plain torch form
=====================  =========================================  =====================
flash_attention        flash_attention.py:flash_attention         flash_attention_plain
=====================  =========================================  =====================

The CUDA source holds two kernels behind one entry point: bf16 inputs run
on the tensor cores (wgmma, P rounded to bf16 for P.V), f32 inputs on the
CUDA cores (scalar f32 FMAs, which hold 2e-5 of the plain form). The
wrapper launches the kernel and raises for a tensor that is not on a
card; ``kernels/ops.py`` decides between it and the plain form by the
tensor's device. ``LAUNCHES`` counts kernel launches. The wrapper takes
any S and T (the JAX function takes S and T of at most 128 or a multiple
of 128); it refuses a D or Dv that is not a multiple of 8 or is above
256.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.ref import NEG_INF

BLOCK_K = 128       # the TPU kernel's key block (flash_attention.py:74)
MAX_D = 256         # head dims of q/k and of v the kernel stages

LAUNCHES = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _P]),
    "flash_wgmma_smem_bytes": (_I, [_I, _I]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    _launches.reset(LAUNCHES)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain form of :func:`flash_attention`, the TPU kernel's arithmetic
    in torch f32: key blocks of ``min(128, T)``, online softmax (running
    max m, sum l, correction exp(m_prev - m_new)), masked scores -1e30,
    out = acc / max(l, 1e-30) cast to q's dtype.

    q, k: (B, H, S|T, D); v: (B, H, T, Dv) -> (B, H, S, Dv).
    """
    b, h, s, d = q.shape
    t, dv = k.shape[2], v.shape[-1]
    scale = d ** -0.5
    qf = q.float()
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dv), dtype=torch.float32, device=q.device)
    qpos = torch.arange(s, device=q.device)
    bk = min(BLOCK_K, t)
    for k0 in range(0, t, bk):
        sc = torch.matmul(qf, k[:, :, k0:k0 + bk].float().transpose(-1, -2))
        sc = sc * scale
        if causal:
            kpos = k0 + torch.arange(sc.shape[-1], device=q.device)
            sc = sc.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(
            p, v[:, :, k0:k0 + bk].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def wgmma_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel for head
    dims D and Dv (built on first use; the compiler reports only static
    shared memory)."""
    return _lib().flash_wgmma_smem_bytes(d, dv)


def _check(q, k, v) -> None:
    name = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: want q, k (B, H, S|T, D) and v "
                         "(B, H, T, Dv)")
    b, h, _, d = q.shape
    t, dv = k.shape[2], v.shape[-1]
    if tuple(k.shape) != (b, h, t, d) or tuple(v.shape[:3]) != (b, h, t):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if t == 0:
        raise ValueError(f"{name}: no keys (T = 0)")
    if d % 8 or dv % 8 or not 0 < d <= MAX_D or not 0 < dv <= MAX_D:
        raise ValueError(f"{name}: D={d} and Dv={dv} must be multiples of "
                         f"8, at most {MAX_D}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q, k: (B, H, S|T, D); v: (B, H, T, Dv), f32 or bf16 on a card ->
    (B, H, S, Dv) in q's dtype. Causal masking is top-left (key j is seen
    by query i when j <= i)."""
    _check(q, k, v)
    b, h, s, d = q.shape
    t, dv = k.shape[2], v.shape[-1]
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0 or s == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            s, t, d, dv, d ** -0.5, int(causal), _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError {rc}")
    _launches.count(LAUNCHES, "flash_attention")
    return out
