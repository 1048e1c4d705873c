"""Mamba tensor-parallel over "model" (``repro_torch.models.ssm.apply_mamba``
under ``dist.tp``) on gloo ranks of the CPU, against live JAX
``repro.models.ssm.apply_mamba`` and against the port's own layer in one
process, in f32.

Each rank holds its block of one layer's Mamba parameters in the
reference's compute layout (``tree_specs(..., compute_rules(...))``:
``w_in`` and ``x_proj`` split on their fan-out, ``conv_w``, ``conv_b``,
``dt_w``, ``dt_b`` and ``d`` on the inner width di, ``a_log`` on
d_state, ``w_out`` on its fan-in) and runs the layer under
``tp_context`` on four meshes of one 4-rank process group: data 2 x
model 2 and data 1 x model 4 on reduced jamba-v0.1-52b (d 64, di 128,
d_state 8, dt_rank 8, so ``x_proj`` has 24 outputs: at model 4 its
blocks of 6 cross the dt/B/C boundaries, and ``a_log`` splits 2 states
a rank), and two variants at model 4 that 4 does not divide: d_state 6
(``a_log`` and the cache's state ``h`` whole; ``x_proj``'s 20 outputs
split) and dt_rank 6 (``x_proj``'s 22 outputs whole). Three calls:

- train: the output, and the gradients of this rank's parameter blocks
  and of the input of ``sum(y * c)``;
- prefill: the output and the cache in ``cache_specs``' layout, this
  rank's block of d_state of ``h`` and of di of ``conv``;
- dense decode: one token after a 6-token prefill, its cache in that
  layout: the output and the updated cache.

On every rank each is within ``TOL`` of JAX's and of the one process's
(cut to the rank's block), and the output has the same bits on every
rank. TOL is 1e-5 (rtol and atol), as the unsharded layer's parity
test: the partial products are summed over tp in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 300
B, S, PRE = 2, 8, 6                 # batch, train tokens, decode's prefix
# name -> (data, model, config variant)
MESHES = {"data2_model2": (2, 2, None), "model4": (1, 4, None),
          "model4_ds6": (1, 4, "ds6"), "model4_r6": (1, 4, "r6")}
# variant -> fields of the reduced config's ``ssm`` replaced
VARIANTS = {None: {}, "ds6": {"d_state": 6}, "r6": {"dt_rank": 6}}
CALLS = ("train", "prefill", "decode")


def _patched(cfg, variant):
    return dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, **VARIANTS[variant]))


def _cfg(variant=None):
    return _patched(get_config("jamba-v0.1-52b").reduced(), variant)


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    c = rng.normal(size=(B, S, 64)).astype(np.float32)
    return x, c


# ---------------------------------------------------------------------------
# the port (no JAX): one process, or a rank's blocks under tp_context


def _blocks(p, mesh):
    """This rank's compute-layout blocks of one layer's Mamba parameters,
    through the specs of the layer-stacked tree."""
    from repro_torch.dist.sharding import compute_rules, shard_tree, tree_specs
    stacked = {"blocks": ({"mixer": {k: v[None] for k, v in p.items()}},)}
    specs = tree_specs(stacked, compute_rules(mesh.shape))
    local = shard_tree(stacked, specs, mesh)["blocks"][0]["mixer"]
    return {k: v[0].clone() for k, v in local.items()}


def _numpy(tree):
    return {k: v.numpy().copy() for k, v in tree.items()}


def _port(p, cfg, x, c, mesh=None):
    """{call: results} of the three calls on parameters ``p`` (whole, or
    this rank's blocks under ``tp_context(mesh)``)."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.launch.serve import place_cache
    from repro_torch.models.model import init_cache
    from repro_torch.models.ssm import apply_mamba
    out = {}
    with tp_context(mesh):
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xs = torch.from_numpy(x).requires_grad_(True)
        y, _ = apply_mamba(pg, xs, cfg)
        (y * torch.from_numpy(c)).sum().backward()
        out["train"] = (y.detach().numpy().copy(),
                        {k: v.grad.numpy().copy() for k, v in pg.items()},
                        xs.grad.numpy().copy())
        with torch.no_grad():
            y, cache = apply_mamba(p, torch.from_numpy(x), cfg,
                                   return_cache=True)
            out["prefill"] = (y.numpy().copy(), _numpy(cache))
            _, pre = apply_mamba(p, torch.from_numpy(x[:, :PRE]), cfg,
                                 return_cache=True)
            dense = init_cache(cfg, B, 1, device="cpu")   # position 0: Mamba
            if mesh is not None:
                dense = place_cache(dense, cfg, mesh)
            mix = {k: v[0] for k, v in dense[0]["mixer"].items()}
            for k in mix:
                mix[k].copy_(pre[k])
            y, new = apply_mamba(p, torch.from_numpy(x[:, PRE:PRE + 1]),
                                 cfg, cache=mix)
            assert new is mix
            out["decode"] = (y.numpy().copy(), _numpy(mix))
    return out


def _rank(rank, world, np_params):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import params_from_jax
    torch.manual_seed(0)
    x, c = _inputs()
    out = {}
    for key, (data, model, variant) in MESHES.items():
        mesh = Mesh((data, model), ("data", "model"), device="cpu")
        p = _blocks(params_from_jax(np_params[variant]), mesh)
        out[key] = _port(p, _cfg(variant), x, c, mesh)
        out[key, "shapes"] = {k: tuple(v.shape) for k, v in p.items()}
    return out


# ---------------------------------------------------------------------------
# the references: live JAX, and the port in one process


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import ssm as jssm
    out = {}
    for variant in VARIANTS:
        jcfg = _patched(jax_config("jamba-v0.1-52b").reduced(), variant)
        out[variant] = jax.tree.map(
            np.asarray, jssm.init_mamba(jax.random.PRNGKey(2), jcfg))
    return out


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1, args=(jax_params,),
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _jax(variant, jp):
    """{call: results} of live JAX's ``apply_mamba``, as ``_port``'s."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import ssm as jssm
    jcfg = _patched(jax_config("jamba-v0.1-52b").reduced(), variant)
    x, c = _inputs()
    p = jax.tree.map(jnp.asarray, jp)

    def loss(pp, xx):
        y, _ = jssm.apply_mamba(pp, xx, jcfg)
        return (y * jnp.asarray(c)).sum(), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    out = {"train": (np.asarray(y), {k: np.asarray(v) for k, v in
                                     gp.items()}, np.asarray(gx))}
    prefill = jax.jit(lambda pp, xx: jssm.apply_mamba(pp, xx, jcfg,
                                                      return_cache=True))
    decode = jax.jit(lambda pp, xx, cache: jssm.apply_mamba(pp, xx, jcfg,
                                                            cache=cache))
    y, cache = prefill(p, jnp.asarray(x))
    out["prefill"] = (np.asarray(y), {k: np.asarray(v)
                                      for k, v in cache.items()})
    _, pre = prefill(p, jnp.asarray(x[:, :PRE]))
    y, new = decode(p, jnp.asarray(x[:, PRE:PRE + 1]), pre)
    out["decode"] = (np.asarray(y), {k: np.asarray(v)
                                     for k, v in new.items()})
    return out


@pytest.fixture(scope="module")
def references(jax_params):
    from repro_torch.models.model import params_from_jax
    x, c = _inputs()
    return {variant: (_jax(variant, jp),
                      _port(params_from_jax(jp), _cfg(variant), x, c))
            for variant, jp in jax_params.items()}


def _cut(whole, local_shape, rank, n):
    """The block of ``whole`` a rank of tp extent ``n`` (its index
    ``rank``) holds where ``local_shape`` is short of it along one
    dimension."""
    for dim, (w, l) in enumerate(zip(whole.shape, local_shape)):
        if w != l:
            assert w == l * n
            return np.take(whole, range(rank * l, (rank + 1) * l), axis=dim)
    return whole


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_mamba_tp_matches_jax_and_one_process(spawned, references, key,
                                              call):
    data, model, variant = MESHES[key]
    for r, o in enumerate(spawned):
        got, tr = o[key][call], r % model
        for ref in references[variant]:
            want = ref[call]
            np.testing.assert_allclose(got[0], want[0], **TOL)
            for name, g in got[1].items():
                np.testing.assert_allclose(
                    g, _cut(want[1][name], g.shape, tr, model), **TOL,
                    err_msg=name)
            if call == "train":
                np.testing.assert_allclose(got[2], want[2], **TOL)
        # the output's bits are the same on every rank
        np.testing.assert_array_equal(got[0], spawned[0][key][call][0])


def test_blocks_are_the_compute_layout(spawned):
    """What each rank ran on: the compute-layout blocks (``w_in``'s
    fan-out columns, which at model 4 give ranks 0-1 only ``xh``'s and
    ranks 2-3 only ``z``'s; ``x_proj``'s columns across the dt/B/C
    boundaries, or whole; ``a_log`` a block of d_state, or whole; the
    rest on a block of di) and caches in ``cache_specs``' layout (``h``
    a block of d_state, ``conv`` a block of di)."""
    def cut(dim, model):
        return dim // model if dim % model == 0 else dim

    for o in spawned:
        for key, (data, model, variant) in MESHES.items():
            cfg = _cfg(variant)
            di, n, r = 2 * cfg.d_model, cfg.ssm.d_state, cfg.ssm.dt_rank
            blk = di // model
            assert o[key, "shapes"] == {
                "w_in": (64, 2 * blk), "conv_w": (4, blk), "conv_b": (blk,),
                "x_proj": (di, cut(r + 2 * n, model)), "dt_w": (r, blk),
                "dt_b": (blk,), "a_log": (di, cut(n, model)), "d": (blk,),
                "w_out": (blk, 64)}, key
            for call in ("prefill", "decode"):
                cache = o[key][call][1]
                assert cache["h"].shape == (B, di, cut(n, model))
                assert cache["conv"].shape == (B, 3, blk)
    whole = spawned[0]
    assert whole["model4_ds6", "shapes"]["a_log"] == (128, 6)
    assert whole["model4_ds6", "shapes"]["x_proj"] == (128, 5)
    assert whole["model4_r6", "shapes"]["x_proj"] == (128, 22)


def test_prefill_over_a_state_under_tp_compute_raises():
    """A prefill that continues a given Mamba state has no
    tensor-parallel form (no step of the port runs one under
    ``dist.tp``); it raises rather than compute on mismatched blocks."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.models.ssm import apply_mamba, init_mamba
    cfg = _cfg()
    mesh = RecordingMesh((1, 2), ("data", "model"), rank=0, device="cpu")
    p = _blocks(init_mamba(torch.Generator().manual_seed(0), cfg, "cpu"),
                mesh)
    cache = {"h": torch.zeros(B, 128, 4), "conv": torch.zeros(B, 3, 64)}
    with tp_context(mesh), pytest.raises(NotImplementedError):
        apply_mamba(p, torch.zeros(B, 4, 64), cfg, cache=cache)
