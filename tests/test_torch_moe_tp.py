"""The expert-parallel MoE block (``repro_torch.models.moe.apply_moe``
under ``dist.tp``) on gloo ranks of the CPU, against live JAX
``repro.models.moe.apply_moe`` and against the port's own block in one
process, forward and gradients in f32.

Each rank holds its block of the block's parameters in the reference's
compute layout (``tree_specs(..., compute_rules(...))``: the expert
stacks' E over the ep axes, which equal the tp axes, the router's E
columns over tp, the shared experts and the dense residual column- and
row-parallel) and runs the block on the same tokens (2 dispatch groups)
under ``tp_context`` on two meshes of one 4-rank process group: data 2
x model 2 and data 1 x model 4. Cases:

- reduced arctic: 4 experts, top-2, the dense residual;
- a deepseek-shaped block: 8 experts, top-6, 2 shared experts (their
  fused width, 2 x 32, is not ``d_ff``);
- a jamba-shaped block: 4 experts, top-2, nothing else (one expert a
  rank at model 4);
- 6 experts, which model 4 does not divide: the stacks and the router
  stay whole there (the reference's ``fit``), split at model 2.

On every rank: the output and the aux loss within ``TOL`` of JAX's and
of the one process's, the same bits on every rank (every rank routes
alike); the gradients of this rank's parameter blocks and of the input
within ``TOL`` of JAX's (``jax.grad`` of the same loss) and the one
process's, cut to the block. TOL is 1e-5 (rtol and atol), as the
unsharded block's parity test: the ranks' partial combines and partial
input gradients are summed over tp in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_COEF, GROUPS, TIMEOUT = 0.01, 2, 300
SHAPE = (2, 9, 64)                      # (B, S, d_model): 9 tokens a group
MESHES = {"data2_model2": (2, 2), "model4": (1, 4)}


def _cfg(case):
    """(arch of the reduced config, its MoE config's replaced fields)."""
    name, patch = {
        "arctic": ("arctic-480b", {}),
        "deepseek": ("deepseek-v2-236b",
                     {"num_experts": 8, "top_k": 6, "num_shared_experts": 2,
                      "d_ff_expert": 32}),
        "jamba": ("jamba-v0.1-52b", {}),
        "indivisible": ("arctic-480b", {"num_experts": 6}),
    }[case]
    return name, patch


def _port_cfg(case):
    name, patch = _cfg(case)
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **patch))


CASES = ("arctic", "deepseek", "jamba", "indivisible")


def _inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=SHAPE).astype(np.float32)
    c = rng.normal(size=SHAPE).astype(np.float32)
    return x, c


def _loss(out, aux, c):
    return (out * c).sum() + AUX_COEF * aux


# ---------------------------------------------------------------------------
# rank side (no JAX)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _blocks(np_params, mesh):
    """This rank's compute-layout blocks of one layer's MoE parameters,
    through the specs of the layer-stacked tree."""
    from repro_torch.dist.sharding import compute_rules, shard_tree, tree_specs
    from repro_torch.models.model import params_from_jax
    p = params_from_jax(np_params)
    stacked = {"blocks": ({"ffn": _map(lambda t: t[None], p)},)}
    specs = tree_specs(stacked, compute_rules(mesh.shape))
    local = shard_tree(stacked, specs, mesh)["blocks"][0]["ffn"]
    return _map(lambda t: t[0].clone(), local)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _block_run(p, cfg, x, c, tp_mesh=None):
    """(out, aux, {path: grad}, dx) of the block under ``tp_context``
    (none: one process)."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.models.moe import apply_moe
    p = _map(lambda t: t.clone().requires_grad_(True), p)
    xs = torch.from_numpy(x).requires_grad_(True)
    with tp_context(tp_mesh):
        out, aux = apply_moe(p, xs, cfg, cfg.moe, n_groups=GROUPS)
        _loss(out, aux, torch.from_numpy(c)).backward()
    grads = {path: t.grad.numpy().copy() for path, t in _flat(p)}
    return (out.detach().numpy().copy(), float(aux.detach()), grads,
            xs.grad.numpy().copy())


def _rank(rank, world, np_params):
    from repro_torch.launch.mesh import Mesh
    torch.manual_seed(0)
    x, c = _inputs()
    out = {}
    for key, shape in MESHES.items():
        mesh = Mesh(shape, ("data", "model"), device="cpu")
        for case in CASES:
            cfg = _port_cfg(case)
            p = _blocks(np_params[case], mesh)
            res = _block_run(p, cfg, x, c, mesh)
            out[key, case] = res + (
                {path: tuple(t.shape) for path, t in _flat(p)},)
    return out


# ---------------------------------------------------------------------------
# the references (live JAX; the port in one process)


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import moe as jmoe
    out = {}
    for case in CASES:
        name, patch = _cfg(case)
        jcfg = jax_config(name).reduced()
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **patch))
        out[case] = jax.tree.map(np.asarray, jmoe.init_moe(
            jax.random.PRNGKey(3), jcfg, jcfg.moe))
    return out


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1, args=(jax_params,),
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _jax_block(case, jp):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import moe as jmoe
    name, patch = _cfg(case)
    jcfg = jax_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **patch))
    x, c = _inputs()

    def loss(p, xx):
        out, aux = jmoe.apply_moe(p, xx, jcfg, jcfg.moe, n_groups=GROUPS)
        return _loss(out, aux, jnp.asarray(c)), (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    grads = {path: np.asarray(g) for path, g in _flat(
        jax.tree.map(np.asarray, gp))}
    return np.asarray(out), float(aux), grads, np.asarray(gx)


def _one_process(case, jp):
    from repro_torch.models.model import params_from_jax
    x, c = _inputs()
    return _block_run(params_from_jax(jp), _port_cfg(case), x, c)


def _cut(whole, local_shape, rank, n):
    """The block of ``whole`` a rank of tp extent ``n`` (its index
    ``rank``) holds where ``local_shape`` is short of it along one
    dimension."""
    for dim, (w, l) in enumerate(zip(whole.shape, local_shape)):
        if w != l:
            assert w == l * n
            return np.take(whole, range(rank * l, (rank + 1) * l), axis=dim)
    return whole


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_expert_parallel_block_matches_jax_and_one_process(
        spawned, jax_params, key, case):
    data, model = MESHES[key]
    cfg = _port_cfg(case)
    want = _jax_block(case, jax_params[case])
    one = _one_process(case, jax_params[case])
    e = cfg.moe.num_experts
    for r, o in enumerate(spawned):
        out, aux, grads, dx, shapes = o[key, case]
        split = e % model == 0
        assert shapes[("w_gate",)][0] == (e // model if split else e)
        assert shapes[("router",)][-1] == (e // model if split else e)
        for ref in (want, one):
            np.testing.assert_allclose(out, ref[0], **TOL)
            np.testing.assert_allclose(aux, ref[1], **TOL)
            np.testing.assert_allclose(dx, ref[3], **TOL)
            for path, g in grads.items():
                np.testing.assert_allclose(
                    g, _cut(ref[2][path], shapes[path], r % model, model),
                    **TOL, err_msg=str(path))
        # every rank routes alike: the same output bits on every rank
        np.testing.assert_array_equal(out, spawned[0][key, case][0])
        assert aux == spawned[0][key, case][1]


def test_one_expert_a_rank_and_the_fallback_are_what_ran(spawned):
    """The jamba-shaped block at model 4 holds one expert a rank; the
    6-expert block holds all 6 at model 4 and 3 at model 2; arctic's
    dense residual and deepseek's shared experts hold this rank's hidden
    columns."""
    for o in spawned:
        assert o["model4", "jamba"][4][("w_up",)] == (1, 64, 64)
        assert o["model4", "indivisible"][4][("w_down",)] == (6, 64, 64)
        assert o["data2_model2", "indivisible"][4][("w_down",)] == (3, 64,
                                                                     64)
        assert o["model4", "arctic"][4][("dense", "w_gate")] == (64, 32)
        assert o["model4", "arctic"][4][("dense", "w_down")] == (32, 64)
        assert o["data2_model2", "deepseek"][4][("shared", "w_up")] == \
            (64, 32)


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "qwen2-0.5b",
                                  "rwkv6-3b", "whisper-base"])
@pytest.mark.parametrize("model", [2, 4])
def test_init_params_draws_place_params_blocks(name, model):
    """``launch.serve.init_params`` on every rank of a recording mesh:
    bit for bit ``place_params`` of the whole ``init_model`` from the
    same seed (arctic's, deepseek's and jamba's expert stacks cut to the
    rank's experts as they are drawn, deepseek's MLA, jamba's Mamba and
    rwkv6's and whisper's leaves, its encoder and cross-attention
    included, to their compute blocks)."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.launch.serve import init_params, place_params
    from repro_torch.models.model import init_model
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, n_layers=2 * cfg.period)
    for r in range(model):
        mesh = RecordingMesh((1, model), ("data", "model"), rank=r,
                             device="cpu")
        got = init_params(torch.Generator().manual_seed(0), cfg, mesh,
                          device="cpu", max_pos=64)
        want = place_params(init_model(torch.Generator().manual_seed(0),
                                       cfg, device="cpu", max_pos=64),
                            cfg, mesh)
        got, want = tree_flatten(got)[0], tree_flatten(want)[0]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
        if cfg.rwkv is not None:          # every weight a column weight
            local = init_params(torch.Generator().manual_seed(0), cfg, mesh,
                                device="meta", max_pos=64)
            assert local["blocks"][0]["mixer"]["w_o"].shape[-1] == \
                cfg.d_model // model
        if cfg.moe is not None:
            local = init_params(torch.Generator().manual_seed(0), cfg, mesh,
                                device="meta", max_pos=64)
            pos = next(i for i in range(cfg.period) if cfg.moe_on_layer(i))
            assert local["blocks"][pos]["ffn"]["w_up"].shape[1] == \
                cfg.moe.num_experts // model


def test_tp_compute_covers_the_gqa_decoders():
    """The one predicate admits every registered config: the dense GQA
    decoders, arctic (GQA with MoE), deepseek-v2 (MLA with MoE), the
    Mamba hybrid jamba (Mamba and GQA with MoE), rwkv6 and the
    encoder-decoder whisper."""
    from repro_torch.configs.registry import list_configs
    from repro_torch.dist.tp import tp_compute
    got = {n: tp_compute(get_config(n)) for n in list_configs()}
    assert {n for n, ok in got.items() if ok} == {
        "arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b", "qwen1.5-4b",
        "qwen2-0.5b", "qwen2-1.5b", "qwen2-vl-2b", "rwkv6-3b", "whisper-base",
        "yi-6b"} == set(got)
