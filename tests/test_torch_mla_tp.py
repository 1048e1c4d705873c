"""DeepSeek's multi-head latent attention tensor-parallel over "model"
(``repro_torch.models.attention.apply_mla`` under ``dist.tp``) on gloo
ranks of the CPU, against live JAX ``repro.models.attention.apply_mla``
and against the port's own layer in one process, in f32.

Each rank holds its block of one layer's MLA parameters in the
reference's compute layout (``tree_specs(..., compute_rules(...))``:
``w_dq``, ``w_uq``, ``w_dkv`` and ``w_kr`` split on their fan-out,
``w_uk`` and ``w_uv`` on each head's last dimension, ``wo`` on its
fan-in, the two norms whole) and runs the layer under ``tp_context`` on
three meshes of one 4-rank process group: data 2 x model 2, data 1 x
model 4, and data 1 x model 4 with 6 query heads (``w_uq``'s and
``wo``'s blocks cross head boundaries, the heads over gcd(6, 4) = 2
groups of ranks) and a latent rank of 30, a rope dim of 6 and a nope
dim of 18, which 4 does not divide (``w_dkv``, ``w_kr``, ``w_uk`` and
the cache stay whole there, as the reference's ``fit`` leaves them).
Reduced deepseek-v2-236b: rank 32, q rank 48, nope 16, rope 8, v 16.
Three calls:

- train: the output, and the gradients of this rank's parameter blocks
  and of the input of ``sum(y * c)``;
- prefill: the output and the cache, this rank's block of the normed
  latent ``ckv`` and of the roped key ``kr`` (``cache_specs``' layout);
- dense decode: one token at position 6 against a 12-row cache holding
  a 6-token prefill, its cache in that layout: the output and the
  cache's new row.

On every rank each is within ``TOL`` of JAX's and of the one process's
(cut to the rank's block), and the output has the same bits on every
rank. TOL is 1e-5 (rtol and atol), as the unsharded layer's parity
test: the partial products are summed over tp in another order, and the
two RMS norms over a split latent sum their blocks' squares over tp (the
reference's compiled form), which can move a norm by an ulp.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 300
B, S, T, PRE = 2, 7, 12, 6          # batch, train tokens, cache rows, prefix
# name -> (data, model, config variant)
MESHES = {"data2_model2": (2, 2, None), "model4": (1, 4, None),
          "model4_h6": (1, 4, "h6")}
# variant -> fields of the reduced config replaced (``mla``: its fields)
VARIANTS = {None: {},
            "h6": {"n_heads": 6,
                   "mla": dict(kv_lora_rank=30, qk_rope_head_dim=6,
                               qk_nope_head_dim=18)}}
CALLS = ("train", "prefill", "decode")


def _patched(cfg, variant):
    patch = dict(VARIANTS[variant])
    if "mla" in patch:
        patch["mla"] = dataclasses.replace(cfg.mla, **patch["mla"])
    return dataclasses.replace(cfg, **patch)


def _cfg(variant=None):
    return _patched(get_config("deepseek-v2-236b").reduced(), variant)


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    c = rng.normal(size=(B, S, 64)).astype(np.float32)
    return x, c


def _positions(start, n):
    return np.broadcast_to(np.arange(start, start + n), (B, n)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the port (no JAX): one process, or a rank's blocks under tp_context


def _blocks(p, mesh):
    """This rank's compute-layout blocks of one layer's MLA parameters,
    through the specs of the layer-stacked tree."""
    from repro_torch.dist.sharding import compute_rules, shard_tree, tree_specs
    stacked = {"blocks": ({"mixer": {k: v[None] for k, v in p.items()}},)}
    specs = tree_specs(stacked, compute_rules(mesh.shape))
    local = shard_tree(stacked, specs, mesh)["blocks"][0]["mixer"]
    return {k: v[0].clone() for k, v in local.items()}


def _port(p, cfg, x, c, mesh=None):
    """{call: results} of the three calls on parameters ``p`` (whole, or
    this rank's blocks under ``tp_context(mesh)``)."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.launch.serve import place_cache
    from repro_torch.models.attention import apply_mla
    from repro_torch.models.model import init_cache
    out = {}
    with tp_context(mesh):
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xs = torch.from_numpy(x).requires_grad_(True)
        y, _ = apply_mla(pg, xs, cfg,
                         positions=torch.from_numpy(_positions(0, S)))
        (y * torch.from_numpy(c)).sum().backward()
        out["train"] = (y.detach().numpy().copy(),
                        {k: v.grad.numpy().copy() for k, v in pg.items()},
                        xs.grad.numpy().copy())
        with torch.no_grad():
            y, cache = apply_mla(p, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(
                                     _positions(0, S)),
                                 return_cache=True)
            out["prefill"] = (y.numpy().copy(),
                              {k: v.numpy().copy() for k, v in
                               cache.items()})
            _, pre = apply_mla(p, torch.from_numpy(x[:, :PRE]), cfg,
                               positions=torch.from_numpy(
                                   _positions(0, PRE)),
                               return_cache=True)
            dense = init_cache(cfg, B, T, device="cpu")
            if mesh is not None:
                dense = place_cache(dense, cfg, mesh)
            mix = {k: v[0] for k, v in dense[0]["mixer"].items()}
            for k in mix:
                mix[k][:, :PRE] = pre[k]
            y, _ = apply_mla(p, torch.from_numpy(x[:, PRE:PRE + 1]), cfg,
                             positions=torch.from_numpy(_positions(PRE, 1)),
                             cache=mix, cache_index=PRE)
            out["decode"] = (y.numpy().copy(),
                             {k: v[:, PRE].numpy().copy()
                              for k, v in mix.items()})
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
    from repro.models import attention as jatt
    out = {}
    for variant in VARIANTS:
        jcfg = _patched(jax_config("deepseek-v2-236b").reduced(), variant)
        out[variant] = jax.tree.map(
            np.asarray, jatt.init_mla(jax.random.PRNGKey(2), jcfg))
    return out


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1, args=(jax_params,),
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _jax(variant, jp):
    """{call: results} of live JAX's ``apply_mla``, as ``_port``'s."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import attention as jatt
    from repro.models import model as jmodel
    jcfg = _patched(jax_config("deepseek-v2-236b").reduced(), variant)
    x, c = _inputs()
    p = jax.tree.map(jnp.asarray, jp)
    pos = jnp.asarray(_positions(0, S))

    def loss(pp, xx):
        y, _ = jatt.apply_mla(pp, xx, jcfg, positions=pos)
        return (y * jnp.asarray(c)).sum(), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    out = {"train": (np.asarray(y), {k: np.asarray(v) for k, v in
                                     gp.items()}, np.asarray(gx))}

    @jax.jit
    def prefill(pp, xx):
        return jatt.apply_mla(pp, xx, jcfg, return_cache=True,
                              positions=jnp.asarray(_positions(
                                  0, xx.shape[1])))

    @jax.jit
    def decode(pp, xx, mix):
        return jatt.apply_mla(pp, xx, jcfg, cache=mix, cache_index=PRE,
                              positions=jnp.asarray(_positions(PRE, 1)))

    y, cache = prefill(p, jnp.asarray(x))
    out["prefill"] = (np.asarray(y), {k: np.asarray(v)
                                      for k, v in cache.items()})
    _, pre = prefill(p, jnp.asarray(x[:, :PRE]))
    mix = {k: v[0] for k, v in jmodel.init_cache(jcfg, B, T)[0]["mixer"]
           .items()}
    mix = {k: mix[k].at[:, :PRE].set(pre[k]) for k in mix}
    y, new = decode(p, jnp.asarray(x[:, PRE:PRE + 1]), mix)
    out["decode"] = (np.asarray(y), {k: np.asarray(v[:, PRE])
                                     for k, v in new.items()})
    return out


@pytest.fixture(scope="module")
def references(jax_params):
    from repro_torch.models.model import params_from_jax
    x, c = _inputs()
    out = {}
    for variant in jax_params:
        out[variant] = (_jax(variant, jax_params[variant]),
                        _port(params_from_jax(jax_params[variant]),
                              _cfg(variant), x, c))
    return out


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
def test_mla_tp_matches_jax_and_one_process(spawned, references, key, call):
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
    """What each rank ran on: the compute-layout blocks (fan-out columns
    of the down and up projections, a block of each head's nope and v
    dimensions, ``wo``'s fan-in rows, whole norms; a dimension 4 does not
    divide whole) and a cache of this rank's latent and rope columns (or
    the whole)."""
    def cut(dim, model):
        return dim // model if dim % model == 0 else dim

    for o in spawned:
        for key, (data, model, variant) in MESHES.items():
            cfg = _cfg(variant)
            m, h = cfg.mla, cfg.n_heads
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            assert o[key, "shapes"] == {
                "w_dq": (64, cut(m.q_lora_rank, model)),
                "q_norm": (m.q_lora_rank,),
                "w_uq": (m.q_lora_rank, cut(h * qd, model)),
                "w_dkv": (64, cut(m.kv_lora_rank, model)),
                "kv_norm": (m.kv_lora_rank,),
                "w_kr": (64, cut(m.qk_rope_head_dim, model)),
                "w_uk": (m.kv_lora_rank, h, cut(m.qk_nope_head_dim, model)),
                "w_uv": (m.kv_lora_rank, h, cut(m.v_head_dim, model)),
                "wo": (cut(h * m.v_head_dim, model), 64)}, key
            for call in ("prefill", "decode"):
                cache = o[key][call][1]
                assert cache["ckv"].shape[-1] == cut(m.kv_lora_rank, model)
                assert cache["kr"].shape[-1] == cut(m.qk_rope_head_dim,
                                                    model)
    whole = spawned[0]["model4_h6", "shapes"]
    assert whole["w_dkv"][1] == 30 and whole["w_kr"][1] == 6
    assert whole["w_uk"][2] == 18 and whole["w_uv"][2] == 4


def test_paged_decode_under_tp_compute_raises():
    """A paged MLA decode belongs to the serving engine's own TP
    (``_mla_tp_shard``); under ``dist.tp`` on split blocks it raises, as
    GQA's does."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.models.attention import apply_mla, init_mla
    cfg = _cfg()
    mesh = _recording(2)
    p = _blocks(init_mla(torch.Generator().manual_seed(0), cfg, "cpu"), mesh)
    cache = {"ckv_pages": torch.zeros(4, 4, cfg.mla.kv_lora_rank),
             "kr_pages": torch.zeros(4, 4, cfg.mla.qk_rope_head_dim)}
    with tp_context(mesh), pytest.raises(NotImplementedError):
        apply_mla(p, torch.zeros(B, 1, 64), cfg,
                  positions=torch.zeros(B, 1, dtype=torch.int32),
                  cache=cache, cache_index=torch.zeros(B, dtype=torch.int32),
                  page_table=torch.zeros(B, 2, dtype=torch.int32))


def _recording(model):
    from repro_torch.launch.mesh import RecordingMesh
    return RecordingMesh((1, model), ("data", "model"), rank=0, device="cpu")
