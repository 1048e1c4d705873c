"""The CGE filter's bucketed passes: the CUDA kernels and their plain forms.

The Pallas kernels of ``repro/kernels/cge_norms.py`` reduce and scale a
gradient bucketed into ``(n_buckets, width)`` rows (``ops.tree_bucket``).
Here each is a CUDA C++ kernel of ``csrc/cge_norms.cu`` (see its header
for the design) behind a wrapper, with a plain torch form beside it:

=====================  ===============================  ===================
wrapper (CUDA kernel)  replaces (TPU kernel)            plain torch form
=====================  ===============================  ===================
block_sq_norms         cge_norms.py:block_sq_norms      block_sq_norms_plain
masked_scale           cge_norms.py:masked_scale        masked_scale_plain
=====================  ===============================  ===================

A wrapper launches its kernel and raises for a tensor that is not on a
card; ``kernels/ops.py`` decides between a wrapper and its plain form by
the tensor's device. ``LAUNCHES`` counts kernel launches per wrapper. The
wrappers take any width, where the JAX kernels take ``w <= 2048`` or a
multiple of 2048.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.ref import ref_block_sq_norms, ref_masked_scale

LAUNCHES = {"block_sq_norms": 0, "masked_scale": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "cge_block_sq_norms": (_I, [_P, _L, _L, _I, _I, _P, _P]),
    "cge_masked_scale": (_I, [_P, _P, _L, _L, _I, _I, _P, _P]),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    _launches.reset(LAUNCHES)


# ---------------------------------------------------------------------------
# plain torch forms: one f32 reduction or multiply, the oracles of
# kernels/ref.py themselves

block_sq_norms_plain = ref_block_sq_norms
masked_scale_plain = ref_masked_scale


# ---------------------------------------------------------------------------
# CUDA kernel wrappers


def _lib() -> ctypes.CDLL:
    return _build.load("cge_norms", _SIGNATURES)


def _check_rows(x, name: str) -> int:
    """Checks x and returns 1 when its rows can be read as 16-byte
    vectors (aligned base, width a multiple of the vector)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (n_buckets, width) "
                         f"float32 or bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    per_vec = 16 // x.element_size()
    return int(x.data_ptr() % 16 == 0 and x.shape[1] % per_vec == 0)


def block_sq_norms(x):
    """x: (n_buckets, width) f32 or bf16 on a card -> (n_buckets,) f32
    squared row norms, the same from run to run."""
    vec = _check_rows(x, "block_sq_norms")
    n, w = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cge_block_sq_norms(x.data_ptr(), n, w,
                                       _DTYPE_CODE[x.dtype], vec,
                                       out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cge_block_sq_norms launch failed: cudaError {rc}")
    _launches.count(LAUNCHES, "block_sq_norms")
    return out


def masked_scale(x, scale):
    """x: (n_buckets, width) f32 or bf16, scale: (n_buckets,) f32, both on
    a card -> x * scale[:, None] in x's dtype (one f32 multiply, one
    rounding)."""
    vec = _check_rows(x, "masked_scale")
    n, w = x.shape
    if (scale.shape != (n,) or scale.dtype != torch.float32
            or scale.device != x.device):
        raise ValueError(f"masked_scale: scale must be an ({n},) float32 "
                         f"tensor on {x.device}")
    scale = scale.contiguous()
    out = torch.empty_like(x)
    if n == 0 or w == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cge_masked_scale(x.data_ptr(), scale.data_ptr(), n, w,
                                     _DTYPE_CODE[x.dtype], vec,
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cge_masked_scale launch failed: cudaError {rc}")
    _launches.count(LAUNCHES, "masked_scale")
    return out
