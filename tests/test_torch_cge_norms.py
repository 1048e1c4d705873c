"""Port parity for the CGE bucketed passes: the plain torch forms and the
``ops`` dispatchers on CPU tensors against JAX's Pallas kernels in
interpret mode over the JAX test sweep (squared norms to f32 summation
order, the masked scaling bit for bit), ``ops.tree_bucket`` bit for bit
against JAX's on a reduced qwen2-0.5b tree and the LeNet tree, the CGE
keep-set from bucketed norms, and ``impl="cuda"`` refusing a CPU tensor."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.gradagg import cge_mask
from repro.kernels import ops as jops
from repro.kernels.cge_norms import block_sq_norms as jax_norms
from repro.kernels.cge_norms import masked_scale as jax_scale
from repro.models import lenet as jlenet
from repro.models import model as jmodel
from repro_torch.core.gradagg import cge_mask_from_norms
from repro_torch.kernels import cge_norms as tcn
from repro_torch.kernels import ops as tops
from repro_torch.models import lenet as tlenet
from repro_torch.models import model as tmodel

# (n_buckets, width, block), as tests/test_kernels_cge.py
SWEEP = [(1, 2048, 2048), (4, 4096, 2048), (8, 8192, 1024), (3, 6144, 2048)]
NORM_RTOL = 1e-5          # f32 sums of the same squares in another order
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_kernels(block):
    return (jax.jit(functools.partial(jax_norms, block=block, interpret=True)),
            jax.jit(functools.partial(jax_scale, block=block, interpret=True)))


def _bits(x):
    """The raw bits of a torch or JAX array, for bit-for-bit checks."""
    a = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32
               ).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n,w,block", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sq_norms_matches_jax_kernel(n, w, block, dtype):
    x = np.random.default_rng(0).normal(size=(n, w)).astype(np.float32)
    want = np.asarray(_jax_kernels(block)[0](jnp.asarray(x, _JNP[dtype])))
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    plain = tcn.block_sq_norms_plain(tx)
    assert plain.dtype == torch.float32 and plain.shape == (n,)
    np.testing.assert_allclose(plain.numpy(), want, rtol=NORM_RTOL)
    assert torch.equal(tops.block_sq_norms(tx), plain)   # "auto" on the CPU
    np.testing.assert_allclose(tops.block_sq_norms(tx, impl="ref").numpy(),
                               want, rtol=NORM_RTOL)


@pytest.mark.parametrize("n,w,block", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", ["uniform", "keep_drop"])
def test_masked_scale_matches_jax_kernel_bitwise(n, w, block, dtype, scales):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, w)).astype(np.float32)
    s = (rng.uniform(size=n) if scales == "uniform"
         else rng.integers(0, 2, size=n)).astype(np.float32)
    want = _jax_kernels(block)[1](jnp.asarray(x, _JNP[dtype]),
                                  jnp.asarray(s))
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    plain = tcn.masked_scale_plain(tx, torch.from_numpy(s))
    assert plain.dtype == tx.dtype and plain.shape == tx.shape
    np.testing.assert_array_equal(_bits(plain), _bits(want))
    for impl in ("auto", "ref"):
        np.testing.assert_array_equal(
            _bits(tops.masked_scale(tx, torch.from_numpy(s), impl=impl)),
            _bits(want))


def _bucket_equal(jtree, ttree, width):
    jrows, jn = jops.tree_bucket(jtree, width=width)
    trows, tn = tops.tree_bucket(ttree, width=width)
    assert tn == jn and trows.shape == jrows.shape
    assert trows.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(trows), _bits(jrows))
    return tn


@pytest.mark.parametrize("width", [2048, 1000])
def test_tree_bucket_matches_jax_on_model_tree(width):
    """A reduced qwen2-0.5b parameter tree (nested dicts and tuples, keys
    in insertion order other than sorted) buckets bit for bit as JAX's
    ``jax.tree.leaves`` order does."""
    jcfg = jax_config("qwen2-0.5b").reduced()
    jp = jax.tree.map(np.asarray, jmodel.init_model(jax.random.PRNGKey(0),
                                                    jcfg, max_pos=64))
    n = _bucket_equal(jp, tmodel.params_from_jax(jp), width)
    assert n == sum(x.size for x in jax.tree.leaves(jp))


def test_tree_bucket_matches_jax_on_lenet_tree():
    jp = jlenet.init_lenet(jax.random.PRNGKey(0))
    assert _bucket_equal(jp, tlenet.params_from_jax(jp), 2048) == 431_080


def test_tree_bucket_sorts_dict_keys():
    tree = {"z": torch.ones(3), "a": (torch.full((2,), 2.0),),
            "m": {"y": torch.full((1,), 3.0), "b": torch.full((2,), 4.0)}}
    rows, n = tops.tree_bucket(tree, width=4)
    assert n == 8 and rows.shape == (2, 4)
    assert rows.flatten().tolist() == [2, 2, 4, 4, 3, 1, 1, 1]


def test_cge_keepset_from_bucketed_norms():
    """Per-agent gradient norms from bucketed rows (the sum of each
    agent's bucket norms) give the same CGE keep-set as the reference
    filter, as tests/test_kernels_cge.py holds the Pallas kernel."""
    rng = np.random.default_rng(2)
    n_agents, dim = 6, 5000
    grads = rng.normal(size=(n_agents, dim)) * \
        rng.uniform(0.5, 3.0, size=(n_agents, 1))
    received = np.array([True] * 5 + [False])
    f = 2
    sq = []
    for j in range(n_agents):
        rows, _ = tops.tree_bucket(
            {"g": torch.from_numpy(grads[j].astype(np.float32))}, width=1024)
        sq.append(tops.block_sq_norms(rows).sum())
    keep = cge_mask_from_norms(torch.stack(sq).sqrt(),
                               torch.from_numpy(received), f)
    keep_ref = np.asarray(cge_mask(jnp.asarray(grads, jnp.float32),
                                   jnp.asarray(received), f))
    np.testing.assert_array_equal(keep.numpy(), keep_ref)


def test_cge_norm_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 16))
    before = dict(tcn.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tops.block_sq_norms(x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.masked_scale(x, torch.ones(2), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tcn.block_sq_norms(x)
    assert tcn.LAUNCHES == before
