"""Port parity for the paged flash-decode: the plain torch form and the
``ops`` dispatcher on CPU tensors against JAX's Pallas kernel in interpret
mode and its oracle, over the JAX test shapes (GQA grouping, Dv != D,
lane-width pages, Pmax == 1, wide groups), ragged and full lengths, in
f32 and bf16; plus the edge cases the kernel must keep: kv_len == 0 gives
exact zeros, -1 and stale table entries are invisible, and table entries
past the used pages change nothing. The CUDA kernel's split-K is held here
too: its plan (a function of the shapes only) covers the table once, and
a torch mirror of its two passes (per-split partials, then the combine in
split order) matches the plain form and the Pallas kernel, with kv_len =
0, splits wholly past the length and lengths on a split boundary."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import paged_flash_decode
from repro.kernels.ref import ref_paged_decode_attention
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, H, Hkv, D, Dv, page_size, pages_per_seq, num_pages), as
# tests/test_kernels_decode.py
SHAPES = [
    (1, 1, 1, 64, 64, 16, 2, 4),
    (2, 4, 2, 64, 64, 16, 3, 8),
    (3, 2, 2, 128, 64, 8, 4, 16),
    (2, 2, 1, 32, 32, 128, 2, 8),
    (2, 4, 2, 32, 32, 8, 1, 16),
    (2, 8, 2, 32, 32, 8, 3, 8),
]
# f32: softmax sums in another order; bf16: one rounding of the output
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the Pallas kernel in interpret mode and its oracle, each compiled once
# per shape
jax_decode = jax.jit(functools.partial(paged_flash_decode, interpret=True))
jax_ref = jax.jit(ref_paged_decode_attention)


def _inputs(shape, dtype, ragged, seed=0):
    b, h, hkv, d, dv, ps, pmax, npg = shape
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.normal(size=(b, h, d)).astype(np_dt)
    k = rng.normal(size=(npg, ps, hkv, d)).astype(np_dt)
    v = rng.normal(size=(npg, ps, hkv, dv)).astype(np_dt)
    tbl = (rng.permutation(npg - 1)[: b * pmax] + 1).reshape(b, pmax)
    if ragged:
        lens = rng.integers(1, pmax * ps, size=b)
    else:
        lens = np.full(b, pmax * ps)
    return q, k, v, tbl.astype(np.int32), lens.astype(np.int32)


def _torch(*arrays):
    out = []
    for a in arrays:
        if a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.astype(np.float32)).bfloat16())
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_matches_jax_kernel_and_oracle(shape, dtype, ragged):
    arrays = _inputs(shape, dtype, ragged)
    j_out = jax_decode(*_jax(*arrays))
    j_ref = jax_ref(*_jax(*arrays))
    t_in = _torch(*arrays)
    tol = TOL[dtype]
    for out in (tda.paged_decode_plain(*t_in),
                tops.paged_decode_attention(*t_in),            # auto: CPU
                tref.ref_paged_decode_attention(*t_in)):
        assert out.dtype == t_in[0].dtype and out.shape == j_out.shape
        for want in (j_out, j_ref):
            np.testing.assert_allclose(_np(out), _np(want), atol=tol,
                                       rtol=tol)


def test_kv_len_zero_gives_exact_zeros():
    q, k, v, tbl, _ = _inputs((3, 4, 2, 32, 32, 4, 4, 16), "float32", True,
                              seed=6)
    lens = np.array([0, 6, 16], np.int32)
    t_in = _torch(q, k, v, tbl, lens)
    out = tda.paged_decode_plain(*t_in)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_decode(*_jax(q, k, v, tbl, lens))),
        atol=1e-5, rtol=1e-5)
    # one valid token: softmax weight 1 on it
    lens1 = np.array([1, 1, 1], np.int32)
    out1 = tda.paged_decode_plain(*_torch(q, k, v, tbl, lens1))
    want = np.broadcast_to(v[tbl[:, 0], 0, 0][:, None], (3, 2, 32))
    np.testing.assert_allclose(out1.numpy()[:, :2], want, atol=1e-6)


@pytest.mark.parametrize("fill", [-1, 3])
def test_table_entries_past_the_length_are_invisible(fill):
    """-1 (clamped to the null page) or live-looking stale entries past
    ceil(kv_len / PS), and a wider table, change nothing."""
    q, k, v, narrow, _ = _inputs((2, 4, 2, 32, 32, 4, 2, 32), "float32",
                                 True, seed=7)
    lens = np.array([5, 8], np.int32)
    wide = np.concatenate([narrow, np.full((2, 6), fill, np.int32)], axis=1)
    o_narrow = tda.paged_decode_plain(*_torch(q, k, v, narrow, lens))
    o_wide = tda.paged_decode_plain(*_torch(q, k, v, wide, lens))
    np.testing.assert_allclose(o_wide.numpy(), o_narrow.numpy(), atol=1e-7)
    j_wide = jax_decode(*_jax(q, k, v, wide, lens))
    np.testing.assert_allclose(o_wide.numpy(), np.asarray(j_wide),
                               atol=1e-5, rtol=1e-5)


def test_impls_route_by_device_and_name():
    t_in = _torch(*_inputs((2, 4, 2, 32, 32, 8, 2, 8), "float32", True))
    plain = tops.paged_decode_attention(*t_in, impl="plain")
    ref = tops.paged_decode_attention(*t_in, impl="ref")
    np.testing.assert_allclose(plain.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_decode_attention(*t_in, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.paged_decode_attention(*t_in, impl="interpret")


# ---------------------------------------------------------------------------
# the CUDA kernel's split-K plan and its two passes, mirrored in torch


@pytest.mark.parametrize("b,hkv,pmax,ps,n_sm", [
    (8, 2, 48, 16, 132),       # the serving shape of qwen2-0.5b
    (2, 2, 256, 16, 132),      # a long context
    (4, 4, 12, 16, 132),       # yi-6b
    (2, 1, 2, 128, 132),       # lane-width pages
    (3, 2, 7, 8, 16),          # Pmax not a multiple of the split
    (1, 1, 1000, 4, 132),
    (64, 8, 48, 16, 132),      # more blocks than the card holds at once
])
def test_split_plan_covers_the_table_once(b, hkv, pmax, ps, n_sm):
    n_split, per = tda.split_plan(b, hkv, pmax, ps, n_sm)
    assert n_split >= 1 and per >= 1
    covered = np.concatenate([np.arange(s * per, min((s + 1) * per, pmax))
                              for s in range(n_split)])
    np.testing.assert_array_equal(covered, np.arange(pmax))
    # every split starts inside the table: none is empty by construction
    assert (n_split - 1) * per < pmax
    # splits of at least SPLIT_TOKENS tokens unless one split is all
    assert n_split == 1 or per * ps >= tda.SPLIT_TOKENS
    # a plan of the shapes only: the same arguments give the same plan
    assert tda.split_plan(b, hkv, pmax, ps, n_sm) == (n_split, per)


def test_split_plan_edges():
    assert tda.split_plan(2, 2, 1, 8, 132) == (1, 1)        # Pmax = 1
    assert tda.split_plan(8, 2, 48, 16, 132) == (12, 4)     # 192 blocks
    assert tda.split_plan(1000, 8, 48, 16, 132) == (1, 48)  # card full
    with pytest.raises(ValueError, match="must be >= 1"):
        tda.split_plan(0, 2, 48, 16, 132)


def _split_k_mirror(q, k_pages, v_pages, page_table, kv_lens, n_split,
                    per):
    """The CUDA kernel's two passes in torch f32: per (sequence, KV head,
    split) the partial m, l and unnormalised acc of the split's tokens
    (m = -1e30, l = 0, acc = 0 for a split at or past the length), then
    the combine in split order."""
    b, h, d = q.shape
    n, ps, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    g = h // hkv
    pmax = page_table.shape[1]
    qg = q.float().reshape(b, hkv, g, d)
    ms = torch.full((n_split, b, hkv, g), tref.NEG_INF)
    ls = torch.zeros((n_split, b, hkv, g))
    accs = torch.zeros((n_split, b, hkv, g, dv))
    for bi in range(b):
        ln = max(min(int(kv_lens[bi]), pmax * ps), 0)
        for s in range(n_split):
            j0, j1 = s * per * ps, min(ln, (s + 1) * per * ps)
            if j0 >= j1:
                continue
            j = torch.arange(j0, j1)
            page = page_table[bi, j // ps].long().clamp(0, n - 1)
            kr = k_pages[page, j % ps].float()            # (J, Hkv, D)
            vr = v_pages[page, j % ps].float()
            sc = torch.einsum("hgd,jhd->hgj", qg[bi], kr) * d ** -0.5
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ms[s, bi], ls[s, bi] = m, p.sum(-1)
            accs[s, bi] = torch.einsum("hgj,jhe->hge", p, vr)
    m_star = ms.amax(0)
    w = torch.exp(ms - m_star)
    l_tot = (w * ls).sum(0)
    acc = (w[..., None] * accs).sum(0)
    out = acc / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(b, h, dv).to(q.dtype)


# (shape, lengths, n_sm): lengths with kv_len = 0, one token, a length on
# a split boundary and one past it, splits wholly past the length, and
# more than the table holds
MIRROR_CASES = [
    ((4, 14, 2, 64, 64, 16, 12, 64), [0, 1, 64, 65], 132),
    ((3, 4, 2, 32, 32, 4, 32, 128), [16, 17, 128, 500], 8),
    ((2, 7, 1, 64, 32, 16, 8, 24), [128, 3], 132),
    ((2, 6, 2, 32, 32, 8, 16, 40), [0, 0], 132),
    ((2, 8, 1, 128, 128, 16, 4, 12), [33, 64], 1),     # one split
]


@pytest.mark.parametrize("shape,lens,n_sm", MIRROR_CASES)
def test_split_k_mirror_matches_plain_and_jax(shape, lens, n_sm):
    b, h, hkv, d, dv, ps, pmax, npg = shape
    q, k, v, tbl, _ = _inputs(shape, "float32", True, seed=11)
    lens = np.asarray(lens, np.int32)[:b]
    lens = np.concatenate([lens, np.full(b - len(lens), 1, np.int32)])
    t_in = _torch(q, k, v, tbl, lens)
    n_split, per = tda.split_plan(b, hkv, pmax, ps, n_sm)
    out = _split_k_mirror(*t_in, n_split, per)
    np.testing.assert_allclose(out.numpy(),
                               tda.paged_decode_plain(*t_in).numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_decode(*_jax(q, k, v, tbl,
                                                           lens))),
                               atol=2e-5, rtol=2e-5)
    for i in np.flatnonzero(lens <= 0):
        assert torch.equal(out[i], torch.zeros_like(out[i]))
