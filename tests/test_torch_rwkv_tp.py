"""RWKV-6 tensor-parallel over "model" (``repro_torch.models.ssm``'s
``apply_rwkv_time`` and ``apply_rwkv_channel`` under ``dist.tp``) on
gloo ranks of the CPU, against live JAX ``repro.models.ssm`` and against
the port's own layers in one process, in f32.

Each rank holds its block of one layer's time-mix and channel-mix
parameters in the reference's compute layout (``tree_specs(...,
compute_rules(...))``: every weight a column weight, ``w_o`` and
``cm_wv`` too, so ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o``,
``dd_w1``, ``dd_w2``, ``w_a``, ``w_b``, ``mu``, ``mu_x``, ``w0``,
``cm_wr``, ``cm_wk``, ``cm_wv``, ``cm_mu_k`` and ``cm_mu_r`` split on
their last dimension, ``u`` whole) and runs the layers under
``tp_context`` on four meshes of one 4-rank process group, on reduced
rwkv6-3b (d 64, 4 heads of 16, d_ff 128, LoRA widths 8):

- data 2 x model 2 and data 1 x model 4: whole heads a rank, or one;
- data 1 x model 4 at d 96: 6 heads over gcd(6, 4) = 2 groups of 3,
  a rank's 24 columns one and a half heads;
- data 1 x model 4 with LoRA widths 6: ``dd_w1``'s 30 and ``w_a``'s 6
  columns, which 4 does not divide, whole.

Three calls of each layer:

- train: the outputs, and the gradients of this rank's parameter blocks
  and of the input of ``sum(y * c)`` over both layers;
- prefill: the outputs and the cache in ``cache_specs``' layout: ``wkv``
  every head and this rank's block of value columns, ``tm_x`` and
  ``cm_x`` this rank's columns;
- dense decode: one token after a 6-token prefill, its cache in that
  layout: the outputs and the updated cache.

On every rank each is within ``TOL`` of JAX's and of the one process's
(cut to the rank's block), and the outputs have the same bits on every
rank.

Then the decode of a batch of one, which leaves the "data" axis idle:
reduced rwkv6-3b at 2 layers through ``launch.serve``'s
``make_prefill_step`` and ``make_decode_step(..., dp=())`` on data 2 x
model 2 and data 4 x model 1 (every projection's fan-in split over
"data", ``dist.tp.fan_in_dot``), ``NEW`` tokens after a
``PROMPT``-token prefill: the tokens equal JAX's ``make_decode_step``'s,
the logits (gathered whole) and the cache within ``TOL`` of the port's
one process, and that within ``TOL`` of JAX's; the collectives of a
decode step on a ``RecordingMesh`` of each rank equal the real mesh's,
op by op (10 all-reduces a layer over data x model, or 5 over data at
model 1). TOL is 1e-5 (rtol and atol): the partial products are summed over
tp in another order. A parameter gradient's atol is 1e-5 of its leaf's
largest entry where that is above 1: ``u``'s gradient sums the group
norm's backward over every token and value, its entries reach 11.4 at
d 96, and there the one process itself is 2.55e-5 from JAX.
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
          "model4_d96": (1, 4, "d96"), "model4_lora6": (1, 4, "lora6")}
# variant -> (fields of the reduced config, fields of its ``rwkv``)
VARIANTS = {None: ({}, {}), "d96": ({"d_model": 96, "n_heads": 6}, {}),
            "lora6": ({}, {"ddlerp_lora": 6, "decay_lora": 6})}
CALLS = ("train", "prefill", "decode")
# the batch-of-one decode: name -> (data, model)
ONE_MESHES = {"one_data2_model2": (2, 2), "one_data4_model1": (4, 1)}
ONE_LAYERS, PROMPT, NEW = 2, 6, 4


def _patched(cfg, variant):
    top, rw = VARIANTS[variant]
    return dataclasses.replace(
        cfg, rwkv=dataclasses.replace(cfg.rwkv, **rw), **top)


def _cfg(variant=None):
    return _patched(get_config("rwkv6-3b").reduced(), variant)


def _inputs(d):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    c = rng.normal(size=(2, B, S, d)).astype(np.float32)
    return x, c


# ---------------------------------------------------------------------------
# the port (no JAX): one process, or a rank's blocks under tp_context


def _blocks(p, mesh):
    """This rank's compute-layout blocks of one layer's parameters,
    through the specs of the layer-stacked tree."""
    from repro_torch.dist.sharding import compute_rules, shard_tree, tree_specs
    stacked = {"blocks": ({m: {k: v[None] for k, v in p[m].items()}
                           for m in p},)}
    specs = tree_specs(stacked, compute_rules(mesh.shape))
    local = shard_tree(stacked, specs, mesh)["blocks"][0]
    return {m: {k: v[0].clone() for k, v in local[m].items()} for m in p}


def _numpy(tree):
    return {k: v.numpy().copy() for k, v in tree.items()}


def _apply(p, x, cfg, **kw):
    from repro_torch.models.ssm import apply_rwkv_channel, apply_rwkv_time
    yt, ct = apply_rwkv_time(p["mixer"], x, cfg, **{
        k: (v["mixer"] if k == "cache" else v) for k, v in kw.items()})
    yc, cc = apply_rwkv_channel(p["ffn"], x, cfg, **{
        k: (v["ffn"] if k == "cache" else v) for k, v in kw.items()})
    return (yt, yc), (ct, cc)


def _port(p, cfg, x, c, mesh=None):
    """{call: results} of the three calls on parameters ``p`` (whole, or
    this rank's blocks under ``tp_context(mesh)``)."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.launch.serve import place_cache
    from repro_torch.models.model import init_cache
    out = {}
    with tp_context(mesh):
        pg = {m: {k: v.clone().requires_grad_(True) for k, v in q.items()}
              for m, q in p.items()}
        xs = torch.from_numpy(x).requires_grad_(True)
        ys, _ = _apply(pg, xs, cfg)
        sum((y * torch.from_numpy(cc)).sum()
            for y, cc in zip(ys, c)).backward()
        out["train"] = (
            [y.detach().numpy().copy() for y in ys],
            {m: {k: v.grad.numpy().copy() for k, v in q.items()}
             for m, q in pg.items()}, xs.grad.numpy().copy())
        with torch.no_grad():
            ys, caches = _apply(p, torch.from_numpy(x), cfg,
                                return_cache=True)
            out["prefill"] = ([y.numpy().copy() for y in ys],
                              [_numpy(q) for q in caches])
            _, pre = _apply(p, torch.from_numpy(x[:, :PRE]), cfg,
                            return_cache=True)
            dense = init_cache(cfg, B, 1, device="cpu")
            if mesh is not None:
                dense = place_cache(dense, cfg, mesh)
            cache = {m: {k: v[0] for k, v in dense[0][m].items()}
                     for m in ("mixer", "ffn")}
            for m, q in zip(("mixer", "ffn"), pre):
                for k in q:
                    cache[m][k].copy_(q[k])
            ys, new = _apply(p, torch.from_numpy(x[:, PRE:PRE + 1]), cfg,
                             cache=cache)
            assert new[0] is cache["mixer"] and new[1] is cache["ffn"]
            out["decode"] = ([y.numpy().copy() for y in ys],
                             [_numpy(cache[m]) for m in ("mixer", "ffn")])
    return out


def _one_cfg():
    return dataclasses.replace(get_config("rwkv6-3b").reduced(),
                               n_layers=ONE_LAYERS)


def _one_prompt():
    return np.random.default_rng(7).integers(
        0, _one_cfg().vocab_size, (1, PROMPT)).astype(np.int32)


@torch.no_grad()
def _one_decode(params, cfg, mesh=None, dp=None):
    """A batch of one on ``launch.serve``'s steps (``params`` whole, or
    this rank's ``place_params`` blocks): the prefill, then ``NEW`` decode
    steps fed their own tokens. Each step's logits come from the decode
    step's own body (``apply_model`` under the context it installs) on a
    copy of the cache. Returns (tokens, logits (NEW, V), cache)."""
    from repro_torch.dist.tp import gather_from_tp, tp_context
    from repro_torch.launch import serve as V
    from repro_torch.models.layers import vocab_split
    from repro_torch.models.model import apply_model
    from repro_torch.core.ledger import tree_flatten
    tok, cache = V.make_prefill_step(cfg, mesh=mesh)(
        params, {"tokens": torch.from_numpy(_one_prompt())})
    decode = V.make_decode_step(cfg, mesh=mesh, dp=dp)
    toks, logits = [tok], []
    for i in range(NEW):
        copy = [{m: {k: v.clone() for k, v in q.items()} for m, q in blk.items()}
                for blk in cache]
        with tp_context(mesh, V._tp_axes(cfg, mesh),
                        idle=V._idle_axes(mesh, dp)):
            lg, _, _ = apply_model(params, tok[:, None], cfg, mode="decode",
                                   cache=copy, cache_index=PROMPT + i,
                                   remat_policy="none")
            lg = lg[:, -1]
            if vocab_split(lg, cfg):
                lg = gather_from_tp(lg, -1)
        tok, cache = decode(params, {"tokens": tok[:, None], "cache": cache,
                                     "pos": PROMPT + i})
        for a, b in zip(tree_flatten(copy)[0], tree_flatten(cache)[0]):
            assert torch.equal(a, b)      # the step's body, bit for bit
        assert torch.equal(tok, torch.argmax(lg, -1).to(torch.int32))
        toks.append(tok)
        logits.append(lg[0].numpy().copy())
    return (torch.stack(toks, 1).numpy(), np.stack(logits),
            [{m: _numpy(q) for m, q in blk.items()} for blk in cache])


def _one_collectives(params, cfg, mesh, cache, tok):
    """The collectives ``(kind, axes, group size, bytes)`` of one decode
    step of a batch of one on ``mesh``, in order."""
    from repro_torch.launch import serve as V
    from repro_torch.launch.mesh import watch_collectives
    seen = []
    with watch_collectives(lambda *c: seen.append(c)):
        V.make_decode_step(cfg, mesh=mesh, dp=())(
            params, {"tokens": tok, "cache": cache, "pos": PROMPT})
    return seen


def _one_rank(rank, np_model):
    """The batch-of-one decode on each of ``ONE_MESHES``: its results,
    and one step's collectives on the real mesh and on a recording mesh
    of this rank."""
    from repro_torch.launch import serve as V
    from repro_torch.launch.mesh import Mesh, RecordingMesh
    from repro_torch.models.model import params_from_jax
    cfg, out = _one_cfg(), {}
    for key, (data, model) in ONE_MESHES.items():
        mesh = Mesh((data, model), ("data", "model"), device="cpu")
        params = V.place_params(params_from_jax(np_model), cfg, mesh)
        toks, logits, cache = _one_decode(params, cfg, mesh, dp=())
        tok = torch.from_numpy(toks[:, -1:])
        _, pre = V.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": torch.from_numpy(_one_prompt())})
        real = _one_collectives(params, cfg, mesh, pre, tok)
        rec = RecordingMesh((data, model), ("data", "model"), rank=rank,
                            device="cpu")
        _, pre = V.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": torch.from_numpy(_one_prompt())})
        recorded = _one_collectives(params, cfg, rec, pre, tok)
        out[key] = dict(tokens=toks, logits=logits, cache=cache, real=real,
                        recorded=recorded)
    return out


def _rank(rank, world, np_params, np_model):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import params_from_jax
    torch.manual_seed(0)
    out = {"one": _one_rank(rank, np_model)}
    for key, (data, model, variant) in MESHES.items():
        cfg = _cfg(variant)
        x, c = _inputs(cfg.d_model)
        mesh = Mesh((data, model), ("data", "model"), device="cpu")
        p = _blocks(params_from_jax(np_params[variant]), mesh)
        out[key] = _port(p, cfg, x, c, mesh)
        out[key, "shapes"] = {m: {k: tuple(v.shape) for k, v in q.items()}
                              for m, q in p.items()}
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
        jcfg = _patched(jax_config("rwkv6-3b").reduced(), variant)
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        out[variant] = jax.tree.map(np.asarray, {
            "mixer": jssm.init_rwkv(k1, jcfg),
            "ffn": jssm.init_rwkv_channel(k2, jcfg)})
    return out


@pytest.fixture(scope="module")
def one_model():
    """Reduced rwkv6-3b at ``ONE_LAYERS`` layers, JAX's parameters."""
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models.model import init_model
    jcfg = dataclasses.replace(jax_config("rwkv6-3b").reduced(),
                               n_layers=ONE_LAYERS)
    return jax.tree.map(np.asarray,
                        init_model(jax.random.PRNGKey(3), jcfg, max_pos=64))


@pytest.fixture(scope="module")
def spawned(jax_params, one_model, tmp_path_factory):
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1,
                     args=(jax_params, one_model),
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _jax(variant, jp):
    """{call: results} of live JAX's layers, as ``_port``'s."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import ssm as jssm
    jcfg = _patched(jax_config("rwkv6-3b").reduced(), variant)
    x, c = _inputs(jcfg.d_model)
    p = jax.tree.map(jnp.asarray, jp)

    def both(pp, xx, cache=None, return_cache=False):
        kw = dict(return_cache=return_cache)
        yt, ct = jssm.apply_rwkv_time(
            pp["mixer"], xx, jcfg, cache=cache and cache[0], **kw)
        yc, cc = jssm.apply_rwkv_channel(
            pp["ffn"], xx, jcfg, cache=cache and cache[1], **kw)
        return (yt, yc), (ct, cc)

    def loss(pp, xx):
        ys, _ = both(pp, xx)
        return sum((y * jnp.asarray(cc)).sum() for y, cc in zip(ys, c)), ys

    (_, ys), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    np_ = lambda t: jax.tree.map(np.asarray, t)
    out = {"train": (np_(list(ys)), np_(gp), np.asarray(gx))}
    prefill = jax.jit(lambda pp, xx: both(pp, xx, return_cache=True))
    decode = jax.jit(lambda pp, xx, cache: both(pp, xx, cache=cache))
    ys, caches = prefill(p, jnp.asarray(x))
    out["prefill"] = (np_(list(ys)), np_(list(caches)))
    _, pre = prefill(p, jnp.asarray(x[:, :PRE]))
    ys, new = decode(p, jnp.asarray(x[:, PRE:PRE + 1]), pre)
    out["decode"] = (np_(list(ys)), np_(list(new)))
    return out


@pytest.fixture(scope="module")
def references(jax_params):
    from repro_torch.models.model import params_from_jax
    out = {}
    for variant, jp in jax_params.items():
        cfg = _cfg(variant)
        x, c = _inputs(cfg.d_model)
        out[variant] = (_jax(variant, jp),
                        _port(params_from_jax(jp), cfg, x, c))
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
def test_rwkv_tp_matches_jax_and_one_process(spawned, references, key,
                                             call):
    data, model, variant = MESHES[key]
    for r, o in enumerate(spawned):
        got, tr = o[key][call], r % model
        for ref in references[variant]:
            want = ref[call]
            for a, b in zip(got[0], want[0]):
                np.testing.assert_allclose(a, b, **TOL)
            trees = (got[1].items() if call == "train"
                     else zip(("mixer", "ffn"), got[1]))
            for i, (m, tree) in enumerate(trees):
                ref_tree = want[1][m] if call == "train" else want[1][i]
                for name, g in tree.items():
                    ref_g = np.asarray(ref_tree[name])
                    tol = TOL
                    if call == "train":
                        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * max(
                            1.0, float(np.abs(ref_g).max())))
                    np.testing.assert_allclose(
                        g, _cut(ref_g, g.shape, tr, model), **tol,
                        err_msg=f"{m}/{name}")
            if call == "train":
                np.testing.assert_allclose(got[2], want[2], **TOL)
        # the outputs' bits are the same on every rank
        for a, b in zip(got[0], spawned[0][key][call][0]):
            np.testing.assert_array_equal(a, b)


def test_blocks_are_the_compute_layout(spawned):
    """What each rank ran on: every weight's columns, ``u`` whole, and
    where tp does not divide them ``dd_w1`` and ``w_a`` whole; caches in
    ``cache_specs``' layout (``wkv`` every head, a block of value
    columns; ``tm_x`` and ``cm_x`` a block of d)."""
    for o in spawned:
        for key, (data, model, variant) in MESHES.items():
            cfg = _cfg(variant)
            d, hd, rw = cfg.d_model, cfg.rwkv.head_dim, cfg.rwkv
            h, blk = d // hd, d // model

            def cut(n):
                return n // model if n % model == 0 else n

            assert o[key, "shapes"] == {
                "mixer": {"mu_x": (blk,), "mu": (5, blk),
                          "dd_w1": (d, cut(5 * rw.ddlerp_lora)),
                          "dd_w2": (5, rw.ddlerp_lora, blk),
                          "w_r": (d, blk), "w_k": (d, blk), "w_v": (d, blk),
                          "w_g": (d, blk), "w_o": (d, blk), "w0": (blk,),
                          "w_a": (d, cut(rw.decay_lora)),
                          "w_b": (rw.decay_lora, blk), "u": (h, hd)},
                "ffn": {"cm_mu_k": (blk,), "cm_mu_r": (blk,),
                        "cm_wr": (d, blk), "cm_wk": (d, cfg.d_ff // model),
                        "cm_wv": (cfg.d_ff, blk)}}, key
            for call in ("prefill", "decode"):
                mix, ffn = o[key][call][1]
                assert mix["wkv"].shape == (B, h, hd, hd // model)
                assert mix["tm_x"].shape == ffn["cm_x"].shape == (B, blk)
    assert spawned[0]["model4_lora6", "shapes"]["mixer"]["w_a"] == (64, 6)


def test_prefill_over_a_state_under_tp_compute_raises():
    """A prefill that continues a given RWKV state has no
    tensor-parallel form (no step of the port runs one under
    ``dist.tp``); it raises rather than compute on mismatched blocks."""
    from repro_torch.dist.tp import tp_context
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.models.ssm import apply_rwkv_time, init_rwkv
    cfg = _cfg()
    mesh = RecordingMesh((1, 2), ("data", "model"), rank=0, device="cpu")
    p = _blocks({"mixer": init_rwkv(torch.Generator().manual_seed(0), cfg,
                                    "cpu")}, mesh)["mixer"]
    cache = {"wkv": torch.zeros(B, 4, 16, 8), "tm_x": torch.zeros(B, 32)}
    with tp_context(mesh), pytest.raises(NotImplementedError):
        apply_rwkv_time(p, torch.zeros(B, 4, 64), cfg, cache=cache)


# ---------------------------------------------------------------------------
# the batch-of-one decode, its fan-in split over the idle "data" axis


@pytest.fixture(scope="module")
def one_references(one_model):
    """(JAX's, the port's one process's) tokens, logits (NEW, V) and
    cache of the batch-of-one decode."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import serve as jserve
    from repro.models import model as jmodel
    from repro_torch.models.model import params_from_jax
    jcfg = dataclasses.replace(jax_config("rwkv6-3b").reduced(),
                               n_layers=ONE_LAYERS)
    jp = jax.tree.map(jnp.asarray, one_model)
    tok, cache = jserve.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(_one_prompt())})
    decode = jax.jit(jserve.make_decode_step(jcfg))
    body = jax.jit(lambda p, t, c, i: jmodel.apply_model(
        p, t, jcfg, mode="decode", cache=c, cache_index=i,
        remat_policy="none")[0][:, -1])
    toks, logits = [np.asarray(tok)], []
    for i in range(NEW):
        logits.append(np.asarray(body(jp, tok[:, None], cache,
                                      jnp.asarray(PROMPT + i, jnp.int32)))[0])
        tok, cache = decode(jp, {"tokens": tok[:, None], "cache": cache,
                                 "pos": jnp.asarray(PROMPT + i, jnp.int32)})
        toks.append(np.asarray(tok))
    ref = (np.stack(toks, 1), np.stack(logits),
           [{m: {k: np.asarray(v) for k, v in q.items()}
             for m, q in blk.items()} for blk in cache])
    return ref, _one_decode(params_from_jax(one_model), _one_cfg())


def _same_cache(got, want, rank, model):
    for blk, ref_blk in zip(got, want):
        for m, tree in blk.items():
            for name, g in tree.items():
                np.testing.assert_allclose(
                    g, _cut(np.asarray(ref_blk[m][name]), g.shape, rank,
                            model), **TOL, err_msg=f"{m}/{name}")


def test_one_process_decode_of_one_matches_jax(one_references):
    """The port's one process against JAX's ``make_decode_step``: the
    same tokens, logits and cache within ``TOL``."""
    (jt, jl, jc), (tt, tl, tc) = one_references
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, **TOL)
    _same_cache(tc, jc, 0, 1)


@pytest.mark.parametrize("key", sorted(ONE_MESHES))
def test_decode_of_one_splits_fan_in_over_data(spawned, one_references,
                                               key):
    """Every rank's batch-of-one decode, its fan-ins split over the idle
    "data" axis: the tokens equal the one process's (and JAX's), the
    logits and this rank's block of the cache within ``TOL`` of the one
    process's, the logits' bits the same on every rank."""
    data, model = ONE_MESHES[key]
    (jt, _, _), (tt, tl, tc) = one_references
    for r, o in enumerate(spawned):
        got = o["one"][key]
        np.testing.assert_array_equal(got["tokens"], tt)
        np.testing.assert_array_equal(got["tokens"], jt)
        np.testing.assert_allclose(got["logits"], tl, **TOL)
        _same_cache(got["cache"], tc, r % model, model)
        np.testing.assert_array_equal(got["logits"],
                                      spawned[0]["one"][key]["logits"])


@pytest.mark.parametrize("key", sorted(ONE_MESHES))
def test_decode_of_one_collectives_on_a_recording_mesh(spawned, key):
    """A decode step's all-reduces on a ``RecordingMesh`` of each rank
    equal the real mesh's op by op (axes, group size, bytes): at model 2
    the 10 a layer over data x model (the partial products summed and
    gathered in one) and the embedding's and the logits' gathers over
    model; at model 1 the 5 a layer that sum partial products, over
    data."""
    data, model = ONE_MESHES[key]
    layers = _one_cfg().n_layers
    for o in spawned:
        got = o["one"][key]
        assert got["recorded"] == got["real"]
        kinds = [(c[0], c[1], c[2]) for c in got["real"]]
        if model == 1:
            assert kinds == [("all-reduce", ("data",), data)] * 5 * layers
        else:
            assert len(kinds) == 10 * layers + 2
            assert kinds.count(("all-reduce", ("data", "model"),
                                data * model)) == 5 * layers
            assert kinds.count(("all-reduce", ("model",), model)) == \
                5 * layers + 2
