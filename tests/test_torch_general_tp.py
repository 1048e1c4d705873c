"""``repro_torch.launch.train.make_general_step`` tensor-parallel over
"model" (the twin of ``test_torch_general_step.py`` at model > 1), on 8
gloo ranks of the CPU, against an aggregate built here from live
``repro``: per-agent ``value_and_grad`` of JAX's ``make_loss_fn``, the
``repro.core.gradagg`` rule on the stacked gradients, JAX's clipping,
optimizer and ``apply_updates`` (the reference's numbers do not depend
on its layout). SGD with momentum, f = 1, tau = 1, 3 steps, reduced
configs cut to 2 layers (jamba to its period of 8), f32:

- reduced qwen2-0.5b (tied embeddings, QKV bias) and arctic-480b (MoE:
  4 experts over the tp ranks, top-2, the dense residual; untied), all
  four modes, and reduced yi-6b (untied unembedding, remat), cge, on
  data 4 x model 2, one agent masked per step;
- reduced qwen2-0.5b with 6 query heads on data 2 x model 4 (the heads
  over gcd(6, 4) = 2 groups of ranks), cge and quantized, and arctic
  with 6 query heads, cge (one expert a rank), every agent received but
  at step 1: CGE keeps the smaller whole-gradient norm and the quantizer
  scales by the whole gradient's max, so both must count each block
  once (the expert stacks split on their dimension 1);
- reduced deepseek-v2-236b (MLA over tp, 4 experts, a shared expert;
  remat), cge and quantized on data 4 x model 2 and cge with 6 query
  heads on data 2 x model 4 (``w_uk`` / ``w_uv`` split within every
  head, ``w_uq`` and ``wo`` across head boundaries);
- reduced jamba-v0.1-52b at one period of 8 layers (7 Mamba mixers over
  tp, one GQA layer, 4 MoE blocks; remat), cge and quantized on data 4 x
  model 2;
- reduced rwkv6-3b (every weight's columns over tp; remat), cge and
  quantized on data 4 x model 2.

For each: loss, grad norm and the gathered parameters within ``TOL`` of
the oracle; each tp block identical on every dp rank and each whole leaf
identical on every rank; the stale ledger row and the quantized residual
row whole and identical on every model rank of an agent; a rank's FLOPs
on the meta device below the same step's at model 1. A reduced
whisper-base computes tensor-parallel too: its rank FLOPs at data 2 x
model 2 fall below those at data 2 x model 1 (its steps against the one
process are ``tests/test_torch_whisper_tp.py``'s). ``dist.tp.tp_sq_norm``
and ``tp_abs_max`` are held on recording meshes (what each rank sends)
and on the 8 ranks (the whole tree's norm and max, the same on every
rank).

TOL is 1e-5 (rtol and atol), as the one-block step's parity tests: the
partial products are summed over ranks in another order (rwkv6 is held
to 1e-4 of JAX, the bound of the one-process port's RWKV against JAX,
and to TOL of the port's own one-process step). That order
moves the quantizer's argument x / scale by about 1e-5 of a step, so a
coordinate within ``TIE`` of a half-integer may round the other way than
the oracle's (the rule does not decide such ties at f32 precision): the
quantized oracle reads each agent's int8 values back from the port's
residual rows (q = round((x - err) / scale)), asserts they equal its own
at every received coordinate farther than ``TIE`` from a tie, and adopts
the port's there.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import RecordingMesh, run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
# rwkv6 against the oracle: the bound the one-process port's RWKV is held
# to against JAX (``test_torch_ssm.py``); its grad norm moves by 1.2e-5
# of itself between orders of the partial sums (quantized, step 2)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-3                  # |frac(x / scale) - 1/2| of a rounding tie
MODES = ("cge", "stale", "trimmed", "quantized")
B, S, STEPS = 8, 16, 3
WORLD, TIMEOUT = 8, 300
# name -> (data, model, n_heads patch)
MESHES = {"data4_model2": (4, 2, None), "data2_model4_h6": (2, 4, 6)}
CASES = ([("data4_model2", "qwen2-0.5b", m) for m in MODES]
         + [("data4_model2", "arctic-480b", m) for m in MODES]
         + [("data4_model2", "yi-6b", "cge")]
         + [("data2_model4_h6", "qwen2-0.5b", m) for m in ("cge",
                                                           "quantized")]
         + [("data2_model4_h6", "arctic-480b", "cge")]
         + [("data4_model2", "deepseek-v2-236b", m) for m in ("cge",
                                                             "quantized")]
         + [("data2_model4_h6", "deepseek-v2-236b", "cge")]
         + [("data4_model2", "jamba-v0.1-52b", m) for m in ("cge",
                                                           "quantized")]
         + [("data4_model2", "rwkv6-3b", m) for m in ("cge", "quantized")])
# the agent masked at each step, per agent count
MASKED = {4: (2, 2, 0), 2: (None, 1, None)}


def _patch(cfg, heads):
    """Two layers, or one period of a longer layer pattern (jamba's 8)."""
    return {"n_layers": max(2, len(cfg.layer_pattern)),
            **({"n_heads": heads} if heads else {})}


def _cfg(name, heads=None):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, **_patch(cfg, heads))


def _tc_kwargs(name, mode):
    return dict(mode=mode, optimizer="sgdm", lr=3e-2, lr_kind="cosine",
                lr_total=10, warmup=1, f=1, tau=1,
                remat_policy="full" if name in ("yi-6b", "arctic-480b",
                                                "deepseek-v2-236b",
                                                "jamba-v0.1-52b",
                                                "rwkv6-3b")
                else "none")


def _data(n):
    rng = np.random.default_rng(0)
    batches, masks = [], []
    for t in range(STEPS):
        x = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                        "weights": np.ones((B, S), np.float32)})
        m = np.ones(n, np.float32)
        if MASKED[n][t] is not None:
            m[MASKED[n][t]] = 0.0
        masks.append(m)
    return batches, masks


# ---------------------------------------------------------------------------
# rank side (no JAX)


def _whole(cfg):
    from repro_torch.models.model import init_model
    return init_model(None, cfg, device="meta", max_pos=64)


def _run(mesh, cfg, mode, np_params, n):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.dist.tp import TP, tp_abs_max, tp_sq_norm
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    tc = T.TrainConfig(**_tc_kwargs(cfg.name, mode))
    state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, n_agents=n, device="cpu", mesh=mesh)
    state["params"] = params_from_jax(np_params)
    state = T.place_general_state(state, mesh, cfg)
    specs = T.general_specs(cfg, _whole(cfg), mesh)
    out = {}
    if mode == "cge":           # module 1 on the placed parameters
        tp = TP(mesh, ("model",))
        blocks = tree_flatten(state["params"])[0]
        groups = [mesh.axis_size("model") if b.shape != w.shape else 1
                  for b, w in zip(blocks, tree_flatten(_whole(cfg))[0])]
        out["norm_max"] = (float(tp_sq_norm(blocks, groups, tp)),
                           float(tp_abs_max(blocks, groups, tp)))
    step = T.make_general_step(cfg, tc, mesh)
    batches, masks = _data(n)
    ms, err_rows = [], []
    for b, m in zip(batches, masks):
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, m)
        ms.append((float(met["loss"]), float(met["grad_norm"])))
        if mode == "quantized":
            err_rows.append(np.concatenate([
                e.numpy().reshape(-1) for e in tree_flatten(state["err"])[0]]))
    whole = gather_tree(state["params"], specs, mesh)
    out.update(
        metrics=ms, tp=step.tp_axes,
        params=[l.numpy().copy() for l in tree_flatten(whole)[0]],
        blocks=[l.numpy().copy() for l in tree_flatten(state["params"])[0]],
        err_rows=err_rows)
    if mode == "stale":
        out["rows"] = [state["ledger"]["g"].numpy().copy(),
                       state["ledger"]["ts"].numpy().copy()]
    if mode == "quantized":
        out["rows"] = [e.numpy().copy()
                       for e in tree_flatten(state["err"])[0]]
    return out


def _rank(rank, world, np_params):
    from repro_torch.launch.mesh import Mesh
    meshes = {k: Mesh(v[:2], ("data", "model"), device="cpu")
              for k, v in MESHES.items()}
    out = {}
    for key, name, mode in CASES:
        data, _, heads = MESHES[key]
        out[key, name, mode] = _run(meshes[key], _cfg(name, heads), mode,
                                    np_params[name, heads], data)
    return out


# ---------------------------------------------------------------------------
# the oracle (live JAX, one process)


def _adopt_ties(x, deq, rx, port_err):
    """The oracle's dequantized ``deq`` of ``x`` (n, P), with the port's
    int8 values (from its residual rows ``port_err``) at the received
    coordinates within ``TIE`` of a rounding tie; the port's values must
    equal the oracle's at every other received coordinate. Returns
    (deq, number of ties where the two rounded apart)."""
    scale = np.maximum(np.max(np.abs(x), axis=-1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-30))
    r = x / scale
    q = np.clip(np.round(r), -127, 127)
    q_port = np.clip(np.round((x - port_err) / scale), -127, 127)
    tie = np.abs(np.abs(r - np.floor(r)) - 0.5) < TIE
    rows = rx[:, None]
    assert np.array_equal(q_port[rows & ~tie], q[rows & ~tie]), \
        "the port's int8 values differ from the oracle's away from a tie"
    adopt = rows & tie
    return (np.where(adopt, (q_port * scale).astype(np.float32), deq),
            int(np.sum(adopt & (q_port != q))))


_VG = {}


def _jax_reference(name, heads, mode, jparams, n, port_err=None):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro.configs.registry import get_config as jax_config
    from repro.core import gradagg
    from repro.launch import train as jtrain
    from repro.optim.optimizers import apply_updates, clip_by_global_norm
    jcfg = jax_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, **_patch(jcfg, heads))
    tc = jtrain.TrainConfig(**_tc_kwargs(name, mode))
    opt = jtrain.make_optimizer(tc)
    # the loss reads the config, remat and aux_coef, not the mode: one
    # compilation per config
    if (name, heads) not in _VG:
        _VG[name, heads] = jax.jit(jax.value_and_grad(
            jtrain.make_loss_fn(jcfg, tc, 1)))
    vg = _VG[name, heads]
    params, ost = jparams, opt.init(jparams)
    flat0, unravel = ravel_pytree(params)
    ledger = np.zeros((n, flat0.size), np.float32)
    ts = np.full(n, -1)
    err = np.zeros((n, flat0.size), np.float32)
    per = B // n
    batches, masks = _data(n)
    metrics, flips = [], []
    for t, (b, m) in enumerate(zip(batches, masks)):
        losses, grads = [], []
        for j in range(n):
            l, g = vg(params, {k: jnp.asarray(v[j * per:(j + 1) * per])
                               for k, v in b.items()})
            losses.append(float(l))
            grads.append(np.asarray(ravel_pytree(g)[0], np.float32))
        g = np.stack(grads)
        rx = m > 0
        lsum = float(np.sum(np.float32(losses) * m))
        if mode == "cge":
            keep = np.asarray(gradagg.cge_mask(jnp.asarray(g),
                                               jnp.asarray(rx), tc.f))
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(g),
                                             jnp.asarray(keep)))
            denom = float(keep.sum())
        elif mode == "trimmed":
            agg = np.asarray(gradagg.agg_trimmed_mean(jnp.asarray(g),
                                                      jnp.asarray(rx), tc.f))
            denom = 1.0
        elif mode == "stale":
            ts = np.where(rx, t, ts)
            ledger = np.where(rx[:, None], g, ledger)
            usable = (t - ts) <= tc.tau
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(ledger),
                                             jnp.asarray(usable)))
            denom = float(usable.sum())
        else:
            x = g + err
            deq = np.asarray(gradagg.quantize_int8(jnp.asarray(x))[0])
            deq, apart = _adopt_ties(x, deq, rx, port_err[t])
            flips.append(apart)
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(deq),
                                             jnp.asarray(rx)))
            err = np.where(rx[:, None], x - deq, x)
            denom = float(m.sum())
        denom = max(denom, 1.0)
        agg = unravel(jnp.asarray(agg / np.float32(denom)))
        agg, gnorm = clip_by_global_norm(agg, tc.clip_norm)
        upd, ost = opt.update(agg, ost, params, jnp.asarray(t, jnp.int32))
        params = apply_updates(params, upd,
                               jtrain.lr_at(tc, jnp.asarray(t, jnp.int32)))
        metrics.append((lsum / denom, float(gnorm)))
    return metrics, [np.asarray(l, np.float32)
                     for l in jax.tree.leaves(params)], flips


_PORT = {}


def _port_reference(name, heads, mode, np_params, n, port_err=None):
    """The port's own one-process step, as ``_jax_reference`` builds the
    reference's: each agent's gradient by the port's loss, the rule of
    ``core.gradagg`` on the stacked flat gradients (the quantizer's ties
    adopted from ``port_err`` as there), then clipping, the optimizer and
    the update. Returns the metrics and the parameter leaves."""
    from repro_torch.core import gradagg
    from repro_torch.core.ledger import layout_of, tree_flatten, tree_map
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    from repro_torch.optim.optimizers import (apply_updates,
                                              clip_by_global_norm)
    key = (name, heads, mode)
    if key in _PORT:
        return _PORT[key]
    cfg = _cfg(name, heads)
    tc = T.TrainConfig(**_tc_kwargs(name, mode))
    opt = T.make_optimizer(tc)
    params = params_from_jax(np_params)
    ost = opt.init(params)
    loss_fn = T.make_loss_fn(cfg, tc, 1)
    per = B // n
    err = None
    metrics = []
    for t, (b, m) in enumerate(zip(*_data(n))):
        losses, grads, layout = [], [], None
        for j in range(n):
            loss, g = T.value_and_grad(loss_fn, params, {
                k: torch.from_numpy(v[j * per:(j + 1) * per])
                for k, v in b.items()})
            losses.append(float(loss))
            layout = layout_of(g)
            grads.append(layout.flatten(g))
        g = torch.stack(grads)
        rx = torch.from_numpy(m > 0)
        lsum = float(np.sum(np.float32(losses) * m))
        if mode == "cge":
            keep = gradagg.cge_mask(g, rx, tc.f)
            agg, denom = gradagg.agg_sum(g, keep), float(keep.sum())
        else:                                   # quantized
            x = g if err is None else g + err
            deq = gradagg.quantize_int8(x)[0].numpy()
            deq, _ = _adopt_ties(x.numpy(), deq, m > 0, port_err[t])
            deq = torch.from_numpy(deq)
            agg, denom = gradagg.agg_sum(deq, rx), float(m.sum())
            err = torch.where(rx[:, None], x - deq, x)
        denom = max(denom, 1.0)
        agg = layout.unflatten(agg / np.float32(denom), dtype=torch.float32)
        agg, gnorm = clip_by_global_norm(agg, tc.clip_norm)
        agg = tree_map(lambda a, p: a.to(p.dtype), agg, params)
        upd, ost = opt.update(agg, ost, params, t)
        params = apply_updates(params, upd, T.lr_at(tc, t))
        metrics.append((lsum / denom, float(gnorm)))
    _PORT[key] = (metrics, [l.detach().numpy().copy()
                            for l in tree_flatten(params)[0]])
    return _PORT[key]


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jmodel
    out = {}
    for key, name, _ in CASES:
        heads = MESHES[key][2]
        if (name, heads) not in out:
            jcfg = jax_config(name).reduced()
            jcfg = dataclasses.replace(jcfg, **_patch(jcfg, heads))
            out[name, heads] = jax.tree.map(
                np.asarray, jmodel.init_model(jax.random.PRNGKey(0), jcfg,
                                              max_pos=64))
    return out


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    return run_ranks(_rank, WORLD, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1, args=(jax_params,),
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _coords(key, rank):
    """(data, model) coordinates of ``rank`` on the mesh ``key``."""
    model = MESHES[key][1]
    return rank // model, rank % model


@pytest.mark.parametrize("key,name,mode", CASES)
def test_tp_general_step_matches_live_reference(spawned, jax_params, key,
                                                name, mode):
    data, model, heads = MESHES[key]
    port_err = None
    if mode == "quantized":         # each agent's rows, from model rank 0
        port_err = [np.stack([spawned[d * model][key, name, mode]
                              ["err_rows"][t] for d in range(data)])
                    for t in range(STEPS)]
    want_m, want_p, flips = _jax_reference(
        name, heads, mode, jax_params[name, heads], data, port_err)
    assert sum(flips) <= 2 * STEPS, flips       # ties are rare
    tol = RECURRENT_TOL if name == "rwkv6-3b" else TOL
    for o in spawned:
        got = o[key, name, mode]
        assert got["tp"] == ("model",)              # the TP path ran
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(want_m), **tol)
        assert len(got["params"]) == len(want_p)
        for a, b in zip(got["params"], want_p):
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("key,name,mode",
                         [c for c in CASES if c[1] == "rwkv6-3b"])
def test_tp_rwkv_general_step_matches_one_process(spawned, jax_params, key,
                                                  name, mode):
    """rwkv6's general step within TOL of the port's own one-process step
    (``_port_reference``) from the same parameters, where JAX is held to
    RECURRENT_TOL: loss, grad norm and every gathered parameter."""
    data, model, heads = MESHES[key]
    port_err = None
    if mode == "quantized":
        port_err = [np.stack([spawned[d * model][key, name, mode]
                              ["err_rows"][t] for d in range(data)])
                    for t in range(STEPS)]
    one_m, one_p = _port_reference(name, heads, mode,
                                   jax_params[name, heads], data, port_err)
    for o in spawned:
        got = o[key, name, mode]
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(one_m), **TOL)
        assert len(got["params"]) == len(one_p)
        for a, b in zip(got["params"], one_p):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("key,name,mode", CASES)
def test_tp_general_step_blocks_identical_across_ranks(spawned, key, name,
                                                       mode):
    """Metrics the same on every rank; each tp block the same on every dp
    rank, a whole leaf the same on every rank; the ledger and residual
    rows whole and the same on every model rank of an agent."""
    runs = [o[key, name, mode] for o in spawned]
    whole = [w.shape for w in runs[0]["params"]]
    for r, o in enumerate(runs):
        d, m = _coords(key, r)
        assert o["metrics"] == runs[0]["metrics"]
        twin = runs[m]                      # data 0, the same model rank
        lead = runs[d * MESHES[key][1]]     # the agent's model rank 0
        for blk, ref, full, ref0 in zip(o["blocks"], twin["blocks"], whole,
                                        runs[0]["blocks"]):
            np.testing.assert_array_equal(blk, ref)
            if blk.shape == full:
                np.testing.assert_array_equal(blk, ref0)
        for row, ref in zip(o.get("rows", []), lead.get("rows", [])):
            np.testing.assert_array_equal(row, ref)
        if "rows" in o and mode == "stale":
            assert o["rows"][0].shape == (1, sum(int(np.prod(s))
                                                 for s in whole))
        if "rows" in o and mode == "quantized":
            assert [r.shape[1:] for r in o["rows"]] == whole


@pytest.mark.parametrize("key", sorted(MESHES))
def test_tp_norm_and_max_of_the_placed_parameters(spawned, jax_params, key):
    """``tp_sq_norm`` / ``tp_abs_max`` of each rank's placed blocks: the
    whole tree's squared norm and max |x|, the same on every rank."""
    import jax
    heads = MESHES[key][2]
    leaves = [np.asarray(l, np.float32) for l in
              jax.tree.leaves(jax_params["qwen2-0.5b", heads])]
    sq = sum(float(np.sum(np.square(l, dtype=np.float64))) for l in leaves)
    mx = max(float(np.max(np.abs(l))) for l in leaves)
    got = {o[key, "qwen2-0.5b", "cge"]["norm_max"] for o in spawned}
    assert len(got) == 1
    (g_sq, g_mx), = got
    assert g_sq == pytest.approx(sq, rel=1e-6)
    assert g_mx == mx


# ---------------------------------------------------------------------------
# module 1 on recording meshes


class _Capture(RecordingMesh):
    """A recording mesh that keeps what this rank puts into each
    all-reduce."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.sent = []

    def all_reduce(self, x, axes):
        self.sent.append(x.clone())
        return super().all_reduce(x, axes)


@pytest.mark.parametrize("groups", [4, 2])
def test_tp_norm_and_max_count_each_block_once(groups):
    """A tree of one whole leaf and one leaf split into ``groups`` blocks
    over 4 tp ranks (2: head groups, each block on two ranks): what the
    ranks send sums to the split leaf's squares once, the whole leaf is
    added locally, non-leading ranks of a group send zero; the max
    vector holds every rank's local max, ``-0.0`` elsewhere, and its sum
    is exact. No tp, or a tp extent of 1: the plain sum and max."""
    from repro_torch.dist.tp import TP, tp_abs_max, tp_sq_norm
    g = torch.Generator().manual_seed(3)
    whole = torch.randn(5, 3, generator=g)
    split = torch.randn(8, 12, generator=g) * 3
    w_sq = torch.sum(torch.square(whole))
    parts, maxes = [], []
    for r in range(4):
        mesh = _Capture((1, 4), ("data", "model"), rank=r)
        tp = TP(mesh, ("model",))
        blk = split[:, tp.block(12, groups)]
        got = tp_sq_norm([whole, blk], [1, groups], tp)
        (part,) = mesh.sent
        assert part.shape == () and torch.equal(got, w_sq + part)
        if tp.leads(groups):
            assert torch.equal(part, torch.sum(torch.square(blk)))
        else:
            assert float(part) == 0.0
        parts.append(part)
        mx = tp_abs_max([whole, blk], [1, groups], tp)
        vec = mesh.sent[1]
        local = torch.max(torch.max(whole.abs()), torch.max(blk.abs()))
        assert torch.equal(mx, local) and vec[r] == local
        assert all(str(float(v)) == "-0.0" for i, v in enumerate(vec)
                   if i != r)
        maxes.append(vec)
    torch.testing.assert_close(w_sq + sum(parts),
                               torch.sum(torch.square(whole))
                               + torch.sum(torch.square(split)))
    assert torch.max(sum(maxes)) == max(whole.abs().max(), split.abs().max())
    one = TP(RecordingMesh((4, 1), ("data", "model")), ("model",))
    for tp in (None, one):
        assert torch.equal(tp_sq_norm([whole, split], [1, 1], tp),
                           torch.sum(torch.square(whole))
                           + torch.sum(torch.square(split)))
        assert torch.equal(tp_abs_max([whole, split], [1, 1], tp),
                           torch.max(whole.abs().max(), split.abs().max()))


# ---------------------------------------------------------------------------
# FLOPs per rank on the meta device


def _rank_flops(cfg, mode, data, model):
    from repro_torch.launch import train as T
    from repro_torch.launch.hlo_analysis import OpCounter, analyze
    mesh = RecordingMesh((data, model), ("data", "model"))
    tc = T.TrainConfig(**{**_tc_kwargs(cfg.name, mode),
                          "remat_policy": "none"})
    state = T.init_state(None, cfg, tc, max_pos=64, n_agents=data,
                         device="meta", mesh=mesh)
    state["step"] = torch.tensor(0, dtype=torch.int32)
    meta = torch.device("meta")
    batch = {k: torch.empty((B, S), dtype=dt, device=meta)
             for k, dt in (("tokens", torch.int32), ("targets", torch.int32),
                           ("weights", torch.float32))}
    step = T.make_general_step(cfg, tc, mesh, moe_groups=data)
    with OpCounter() as cnt:
        step(T.place_general_state(state, mesh, cfg), batch,
             np.ones(data, np.float32))
    return analyze(cnt)["flops"], step.tp_axes


@pytest.mark.parametrize("key,name,mode", CASES)
def test_tp_general_rank_flops_below_model_one(key, name, mode):
    data, model, heads = MESHES[key]
    cfg = _cfg(name, heads)
    tp_flops, axes = _rank_flops(cfg, mode, data, model)
    one, none = _rank_flops(cfg, mode, data, 1)
    assert axes == ("model",) and none == ()
    assert 0 < tp_flops < one


def test_non_dense_general_step_computes_whole_on_every_rank():
    """whisper-base's general step, once computed whole on every rank (the
    name is kept from then), is tensor-parallel over "model": its rank
    FLOPs at data 2 x model 2 fall below data 2 x model 1's."""
    cfg = _cfg("whisper-base")
    tp_flops, axes = _rank_flops(cfg, "cge", 2, 2)
    assert axes == ("model",)
    assert 0 < tp_flops < _rank_flops(cfg, "cge", 2, 1)[0]


def test_row_join_sums_in_its_own_buffer():
    """``Mesh.all_reduce(..., inplace=True)``, the row join's: the sum
    lands in the buffer given and that buffer comes back, the collective
    reported as the copying form reports it; the copying form leaves its
    input alone; a strided buffer is refused."""
    from repro_torch.launch.mesh import watch_collectives
    mesh = RecordingMesh((2, 2), ("data", "model"), device="cpu")
    seen = []
    buf = torch.arange(6, dtype=torch.float32)
    with watch_collectives(lambda *a: seen.append(a)):
        same = mesh.all_reduce(buf, ("model",), inplace=True)
        copy = mesh.all_reduce(buf, ("model",))
    assert same is buf and copy is not buf and torch.equal(copy, buf)
    assert seen[0] == seen[1] == ("all-reduce", ("model",), 2, 24)
    with pytest.raises(ValueError, match="contiguous"):
        mesh.all_reduce(torch.zeros(4, 4).T, ("model",), inplace=True)
