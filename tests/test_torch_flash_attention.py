"""Port parity for flash attention: the plain torch form and the ``ops``
dispatcher on CPU tensors against JAX's Pallas kernel in interpret mode
and its oracle, over the JAX test shapes (Dv != D, key blocks of 128 and
256), causal and not, in f32 and bf16; ragged S = T = 100 and T = 2 S
under the top-left causal mask; the plain form against the model's
chunked attention at a long sequence; and ``impl="cuda"`` refusing a CPU
tensor."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import ref_flash_attention as jax_ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import chunked_attention

# (B, H, S, T, D, Dv, block_q, block_k): the shapes of
# tests/test_kernels_flash.py, then ragged S = T = 100 (one block of 100)
# and T = 2 S
SHAPES = [
    (1, 1, 128, 128, 64, 64, 128, 128),
    (2, 2, 256, 256, 64, 64, 128, 128),
    (1, 2, 256, 256, 128, 128, 128, 128),
    (2, 1, 512, 512, 64, 64, 128, 256),
    (1, 1, 256, 256, 128, 64, 128, 128),    # Dv != D (MLA-style)
    (1, 2, 100, 100, 64, 64, 128, 128),     # S = T <= 128, not a multiple
    (1, 2, 128, 256, 64, 32, 128, 128),     # T = 2 S
]
# f32: online softmax over blocks against one softmax, sums in another
# order; bf16: one rounding of the output (2^-8 relative, values of
# order 1) on top of that
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_kernel(causal, block_q, block_k):
    return jax.jit(functools.partial(jax_flash, causal=causal,
                                     block_q=block_q, block_k=block_k,
                                     interpret=True))


def _inputs(shape, seed=0, mult=1.0):
    b, h, s, t, d, dv, _, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)).astype(np.float32) * mult,
            rng.normal(size=(b, h, t, d)).astype(np.float32) * mult,
            rng.normal(size=(b, h, t, dv)).astype(np.float32))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel_and_oracle(shape, dtype, causal):
    q, k, v = _inputs(shape)
    jq, jk, jv = (jnp.asarray(a, _JNP[dtype]) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, k, v))
    want_kernel = _f32(_jax_kernel(causal, *shape[6:])(jq, jk, jv))
    want_ref = _f32(jax_ref(jq, jk, jv, causal=causal))
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    plain = tfa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert plain.dtype == _TORCH[dtype]
    assert plain.shape == (shape[0], shape[1], shape[2], shape[5])
    np.testing.assert_allclose(_f32(plain), want_kernel, **tol)
    np.testing.assert_allclose(_f32(plain), want_ref, **tol)
    auto = tops.flash_attention(tq, tk, tv, causal=causal)
    assert torch.equal(auto, plain)            # "auto" on a CPU tensor
    np.testing.assert_allclose(
        _f32(tops.flash_attention(tq, tk, tv, causal=causal, impl="ref")),
        want_ref, **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_large_logits_rescale(causal):
    """Inputs scaled x8 push the online rescaling (scores of order 100):
    the plain form still matches the JAX kernel in f32."""
    shape = SHAPES[1]
    q, k, v = _inputs(shape, seed=5, mult=8.0)
    want = _f32(_jax_kernel(causal, 128, 128)(*(jnp.asarray(a)
                                                 for a in (q, k, v))))
    got = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(_f32(got), want, rtol=2e-5, atol=2e-5)


def test_flash_plain_matches_chunked_attention():
    """The plain form computes the same math as the model's chunked
    attention (layouts (B, H, S, D) and (B, S, H, D)), as
    test_flash_matches_model_attention_math holds the Pallas kernel."""
    rng = np.random.default_rng(1)
    b, h, s, d = 1, 2, 4096, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, d))
                                .astype(np.float32)) for _ in range(3))
    out = tfa.flash_attention_plain(q, k, v, causal=True)
    tr = lambda x: x.transpose(1, 2)            # noqa: E731
    out2 = tr(chunked_attention(tr(q), tr(k), tr(v), causal=True, chunk=512))
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_flash_cuda_impl_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    before = tfa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    assert tfa.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="unknown impl"):
        tops.flash_attention(q, k, v, impl="interpret")


def test_flash_ref_oracle_matches_jax_oracle():
    """The port's oracle against JAX's, T != S under the causal mask."""
    q, k, v = _inputs(SHAPES[6], seed=2)
    for causal in (True, False):
        np.testing.assert_allclose(
            tref.ref_flash_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     causal=causal).numpy(),
            np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal)), rtol=1e-5, atol=1e-5)
