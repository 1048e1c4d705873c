"""The placed (FSDP) masked train step, ``make_train_step(...,
param_specs=, mesh=)``, on 4 gloo ranks on the CPU, mesh data = 4 and
data 2 x model 2:

- ``shard_tree`` then ``gather_tree`` gives back every leaf bit for bit,
  ``-0.0``, infinities and NaN payloads (f32 and bf16) included;
- each rank's parameters and moments are the specs' share: their bytes
  equal ``state_bytes_per_rank``'s meta-device report;
- after 3 steps on reduced qwen2-0.5b (dense) and arctic-480b (MoE with
  a dense residual, 4 dispatch groups, remat on), f32 weights,
  SGD-momentum and AdamW, a mask dropping one of 4 agents: the gathered
  parameters are identical on every rank and within ``TOL`` of live
  JAX's unsharded ``make_train_step``;
- with ``accum_steps = 2`` (AdamW for qwen2-0.5b, SGD-momentum for
  arctic-480b), 3 steps, one of which masks both agents of the first
  microbatch (its denominator ``max(sum w, 1)`` is 1): the gathered
  parameters, losses and gradient norms within ``TOL`` of live JAX's
  ``make_train_step(accum_steps=2)`` and identical on every rank, the
  parameters gathered once a step (the reference's program gathers them
  before its microbatch loop) so the peak of gathered bytes is at least
  the one-microbatch step's;
- on a one-rank mesh (dp = 1) the placed step is bit-identical to
  ``make_train_step``, at ``accum_steps`` 1 and 2.

TOL is 1e-5 (rtol and atol): the gradients are summed over ranks in
another order than one process sums them; AdamW runs at lr 1e-4, where
its m / (sqrt(v) + eps) turns that reordering of near-zero gradient
elements into at most about lr of a parameter (test_torch_train.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
N_AGENTS, B, S, STEPS = 4, 8, 16, 3
TIMEOUT = 300
ARCHS = ("qwen2-0.5b", "arctic-480b")
OPTIMIZERS = ("sgdm", "adamw")
ACCUM = 2
ACCUM_OPT = {"qwen2-0.5b": "adamw", "arctic-480b": "sgdm"}
# agents masked a step (one-microbatch runs; the accumulating runs, whose
# second step masks agents 0 and 1, the whole first microbatch)
MASKED = ((1,), (3,), (0,))
ACCUM_MASKED = ((1,), (0, 1), (3,))
MESHES = {"data4": (4, 1), "data2_model2": (2, 2)}


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), n_layers=2)


def _tc_kwargs(name, optimizer):
    return dict(mode="masked", optimizer=optimizer,
                lr=3e-2 if optimizer == "sgdm" else 1e-4,
                lr_kind="cosine", lr_total=10, warmup=1,
                remat_policy="full" if name == "arctic-480b" else "none")


def _batches(masked=MASKED):
    from repro_torch.data.partition import mask_to_weights
    rng = np.random.default_rng(0)
    out = []
    for t in range(STEPS):
        x = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        mask = np.ones(N_AGENTS, bool)
        mask[list(masked[t])] = False
        out.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                    "weights": mask_to_weights(mask, B, S)})
    return out


def _special_tree():
    """A small state-like tree whose leaves hold -0.0, infinities and
    NaNs with payloads, in f32 and bf16."""
    g = torch.Generator().manual_seed(3)

    def leaf(shape, dtype):
        x = torch.randn(shape, generator=g).to(dtype)
        flat = x.view(-1)
        flat[0], flat[1], flat[2] = -0.0, float("inf"), float("-inf")
        ib = flat.view(torch.int32 if dtype == torch.float32
                       else torch.int16)
        ib[3] = 0x7fc01234 if dtype == torch.float32 else 0x7fc5
        ib[4] = 0x7f812345 if dtype == torch.float32 else 0x7f83
        ib[5] = -4194303 if dtype == torch.float32 else -61
        return x
    return {"blocks": ({"mixer": {"wq": leaf((2, 8, 12), torch.float32),
                                  "wk": leaf((2, 8, 4), torch.bfloat16),
                                  "wo": leaf((2, 12, 8), torch.bfloat16)},
                        "norm1": {"scale": leaf((2, 8), torch.float32)}},),
            "embed": {"tok": leaf((16, 8), torch.bfloat16)}}


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}
                  [t.dtype]).numpy().copy()


def _rank(rank, world, data, model, np_params, batches, accum_batches):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.dist.sharding import gather_tree, shard_tree, tree_specs
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import params_from_jax
    mesh = make_test_mesh(data=data, model=model, device="cpu")
    out = {}
    special = _special_tree()
    specs = tree_specs(special, T.state_rules(mesh.shape))
    local = shard_tree(special, specs, mesh)
    back = gather_tree(local, specs, mesh)
    out["roundtrip"] = [(_bits(a), _bits(b)) for a, b in zip(
        tree_flatten(back)[0], tree_flatten(special)[0])]
    out["local_shapes"] = [tuple(l.shape) for l in tree_flatten(local)[0]]
    for name in ARCHS:
        cfg = _cfg(name)
        for opt in OPTIMIZERS:
            tc = T.TrainConfig(**_tc_kwargs(name, opt))
            state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                                 max_pos=64, device="cpu")
            state["params"] = params_from_jax(np_params[name])
            state, st_specs = T.place_state(state, mesh)
            held = sum(l.numel() * l.element_size() for k in ("params", "opt")
                       for l in tree_flatten(state[k])[0])
            report = T.state_bytes_per_rank(cfg, tc, mesh.shape, max_pos=64)
            step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS, dp="data",
                                     tp="model", param_specs=st_specs["params"],
                                     sizes=mesh.shape, mesh=mesh)
            ms = []
            for b in batches:
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
                ms.append((float(m["loss"]), float(m["grad_norm"])))
            whole = gather_tree(state["params"], st_specs["params"], mesh)
            out[name, opt] = {
                "metrics": ms, "held": held, "report": report,
                "peak": step.placement.peak_bytes,
                "whole_params": sum(l.numel() * l.element_size()
                                    for l in tree_flatten(whole)[0]),
                "params": [l.numpy().copy() for l in tree_flatten(whole)[0]]}
    for name, opt in ACCUM_OPT.items():
        cfg = _cfg(name)
        tc = T.TrainConfig(**_tc_kwargs(name, opt), accum_steps=ACCUM)
        state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                             max_pos=64, device="cpu")
        state["params"] = params_from_jax(np_params[name])
        state, st_specs = T.place_state(state, mesh)
        step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS, dp="data",
                                 tp="model", param_specs=st_specs["params"],
                                 sizes=mesh.shape, mesh=mesh)
        ms = []
        for b in accum_batches:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        whole = gather_tree(state["params"], st_specs["params"], mesh)
        out[name, "accum"] = {
            "metrics": ms, "peak": step.placement.peak_bytes,
            "params": [l.numpy().copy() for l in tree_flatten(whole)[0]]}
    return out


def _jax_reference(name, opt, jparams, batches, accum_steps=1):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import train as jtrain
    jcfg = dataclasses.replace(jax_config(name).reduced(), n_layers=2)
    jtc = jtrain.TrainConfig(**_tc_kwargs(name, opt),
                             accum_steps=accum_steps)
    state = jtrain.init_state(jax.random.PRNGKey(0), jcfg, jtc, max_pos=64)
    state["params"] = jparams
    step = jax.jit(jtrain.make_train_step(jcfg, jtc, moe_groups=N_AGENTS))
    ms = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return ms, [np.asarray(l, np.float32)
                for l in jax.tree.leaves(state["params"])]


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jmodel
    out = {}
    for name in ARCHS:
        jcfg = dataclasses.replace(jax_config(name).reduced(), n_layers=2)
        out[name] = jmodel.init_model(jax.random.PRNGKey(0), jcfg, max_pos=64)
    return out


@pytest.fixture(scope="module", params=sorted(MESHES))
def spawned(request, jax_params, tmp_path_factory):
    import jax
    data, model = MESHES[request.param]
    batches = _batches()
    np_params = {k: jax.tree.map(np.asarray, v)
                 for k, v in jax_params.items()}
    res = run_ranks(_rank, data * model, backend="gloo", device="cpu",
                    timeout=TIMEOUT, threads=1,
                    args=(data, model, np_params, batches,
                          _batches(ACCUM_MASKED)),
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return request.param, batches, res


def test_shard_then_gather_is_bit_exact(spawned):
    mesh_name, _, res = spawned
    for o in res:
        for got, want in o["roundtrip"]:
            np.testing.assert_array_equal(got, want)
    # the blocks really are split (leaves in key order): wk over data
    # only, wo's fan-in over model and fan-out over data, wq over model x
    # data, the norm scale whole on every rank, tok's vocab over data
    data, model = MESHES[mesh_name]
    assert res[0]["local_shapes"] == [
        (2, 8, 4 // data), (2, 12 // model, 8 // data),
        (2, 8, 12 // (data * model)), (2, 8), (16 // data, 8 // model)]


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("name", ARCHS)
def test_rank_holds_the_specs_share(spawned, name, opt):
    mesh_name, _, res = spawned
    data, model = MESHES[mesh_name]
    for o in res:
        got = o[name, opt]
        assert got["held"] == got["report"]["total"]
        assert got["held"] < got["report"]["whole"] / (data * model) * 1.5
        # gathered leaves alive at once: at most the whole parameters;
        # with remat (arctic) one period's blocks and the embedding
        assert 0 < got["peak"] <= got["whole_params"]
        if name == "arctic-480b":
            assert got["peak"] < got["whole_params"]


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("name", ARCHS)
def test_placed_step_matches_live_reference(spawned, jax_params, name, opt):
    _, batches, res = spawned
    want_m, want_p = _jax_reference(name, opt, jax_params[name], batches)
    for o in res:
        got = o[name, opt]
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(want_m), **TOL)
        assert len(got["params"]) == len(want_p)
        for a, b in zip(got["params"], want_p):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("name", ARCHS)
def test_placed_params_identical_across_ranks(spawned, name, opt):
    *_, res = spawned
    for o in res[1:]:
        assert o[name, opt]["metrics"] == res[0][name, opt]["metrics"]
        for a, b in zip(o[name, opt]["params"], res[0][name, opt]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_accum(jax_params):
    """Live JAX's accumulating steps, shared by both meshes."""
    batches = _batches(ACCUM_MASKED)
    return {name: _jax_reference(name, opt, jax_params[name], batches,
                                 accum_steps=ACCUM)
            for name, opt in ACCUM_OPT.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_accumulating_placed_step_matches_live_reference(spawned, jax_accum,
                                                         name):
    *_, res = spawned
    want_m, want_p = jax_accum[name]
    # the masked microbatch really is empty: its loss adds nothing
    w = _batches(ACCUM_MASKED)[1]["weights"]
    assert not w[:B // ACCUM].any() and w[B // ACCUM:].all()
    for o in res:
        got = o[name, "accum"]
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(want_m), **TOL)
        assert len(got["params"]) == len(want_p)
        for a, b in zip(got["params"], want_p):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_accumulating_params_identical_across_ranks(spawned, name):
    *_, res = spawned
    for o in res[1:]:
        assert o[name, "accum"]["metrics"] == res[0][name, "accum"]["metrics"]
        for a, b in zip(o[name, "accum"]["params"],
                        res[0][name, "accum"]["params"]):
            np.testing.assert_array_equal(a, b)
    # gathered once a step and held across its microbatches: at least the
    # one-microbatch step's peak, at most the whole parameters
    for o in res:
        one = o[name, ACCUM_OPT[name]]
        assert one["peak"] <= o[name, "accum"]["peak"] <= one["whole_params"]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_one_rank_placed_step_is_make_train_step(name, remat):
    _one_rank_against_make_train_step(name, remat, 1)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_one_rank_accumulating_placed_step_is_make_train_step(name, remat):
    _one_rank_against_make_train_step(name, remat, ACCUM)


def _one_rank_against_make_train_step(name, remat, accum):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import Mesh
    cfg = _cfg(name)
    tc = T.TrainConfig(**{**_tc_kwargs(name, "adamw"),
                          "remat_policy": remat, "accum_steps": accum})
    mesh = Mesh((1, 1), ("data", "model"), device="cpu")
    plain = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, device="cpu")
    placed, specs = T.place_state(plain, mesh)
    step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS)
    pstep = T.make_train_step(cfg, tc, moe_groups=N_AGENTS, dp="data",
                              tp="model", param_specs=specs["params"],
                              sizes=mesh.shape, mesh=mesh)
    for b in _batches(MASKED if accum == 1 else ACCUM_MASKED):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        plain, m = step(plain, b)
        placed, pm = pstep(placed, b)
        assert float(pm["loss"]) == float(m["loss"])
        assert float(pm["grad_norm"]) == float(m["grad_norm"])
    for k in ("params", "opt"):
        for a, b in zip(tree_flatten(placed[k])[0],
                        tree_flatten(plain[k])[0]):
            assert torch.equal(a, b)
    assert pstep.placement.peak_bytes == 0     # one rank: nothing to gather


def test_placed_step_refuses_what_it_cannot_place():
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import Mesh
    cfg = _cfg("arctic-480b")
    mesh = Mesh((4, 1), ("data", "model"), device="cpu", groups=False)
    with pytest.raises(ValueError, match="mesh="):
        T.make_train_step(cfg, T.TrainConfig(), param_specs={})
    # microbatch accumulation is placed, but each microbatch must split
    # over the dp ranks: 8 rows in 4 microbatches of 2 do not over 4
    step = T.make_train_step(cfg, T.TrainConfig(accum_steps=4),
                             moe_groups=4, param_specs={}, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    with pytest.raises(ValueError, match="microbatch 0 of accum_steps=4"):
        step({"params": {}}, batch)
    with pytest.raises(ValueError, match="moe_groups"):
        T.make_train_step(cfg, T.TrainConfig(), moe_groups=2, param_specs={},
                          mesh=mesh)
