"""whisper-base's encoder-decoder tensor-parallel over "model" (the
encoder, the decoder's self- and cross-attention, its GELU MLPs, under
``dist.tp``) on gloo ranks of the CPU, against the port's own one
process and that against live ``repro``, in f32, on reduced whisper-base
(2 encoder and 2 decoder layers, d 64, d_ff 128, 24 frames, vocabulary
256, MHA with head_dim 16) on four meshes:

- data 1 x model 2 and data 2 x model 2: 2 of 4 heads a rank;
- data 1 x model 4 with 6 heads: gcd(6, 4) = 2 head groups of 2 ranks,
  ``wq``'s 24 columns a rank crossing head boundaries;
- data 1 x model 4 with 2 heads: one head over 2 ranks, a rank's 8 of
  its 16 columns, the layout of the 8 heads at model 16 (the values and
  ``wo``'s fan-in on the rank's columns; under the general step's
  program the query and K too, the partial scores summed over the
  head's ranks).

Each rank holds its blocks of the reference's compute layout
(``launch.serve.place_params``: ``wq`` / ``w_in`` column blocks, ``wo``
/ ``w_out`` row blocks, ``tok`` its model columns, ``unembed`` its
vocabulary block, ``wk`` / ``wv``, ``enc_pos`` and the norms whole). The
cases, each on every rank within ``TOL`` of the one process, and the one
process within ``TOL`` of JAX:

- the encoder's output;
- a train forward's logits, cross-attention over the encoder's output;
- a prefill: logits, and every layer's cross ``ck`` / ``cv`` equal to
  ``cache_specs``' slice (this rank's head_dim block) of the one
  process's;
- decode logits over that cache, and ``launch.serve``'s steps' tokens;
- the placed masked step (AdamW, remat) with ``enc_embed`` in the batch,
  and the general step's cge and quantized modes (SGD-momentum): loss,
  grad norm and the gathered parameters.

The regression case holds one cross-attention block under ``tp_context``
against the whole one: attending over ``kv_x`` (a prefill, its cache) and
a decode reading ``ck`` / ``cv``; a dispatch that drops ``kv_x`` or the
cross cache computes self-attention there.

TOL is 1e-5 (rtol and atol), as the other tensor-parallel parity tests:
the partial products are summed over ranks in another order. The
quantized step's ties (a coordinate within ``TIE`` of a half-integer of
x / scale, which the rule does not decide at f32 precision) are adopted
from the rank's residual rows, as ``tests/test_torch_general_tp.py``
does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-3
TIMEOUT = 300
N_AGENTS, B, S, STEPS = 4, 8, 16, 3
PROMPT, NEW, MAX_LEN = 6, 4, 12
# name -> (data, model, heads patch)
MESHES = {"model2": (1, 2, None), "data2_model2": (2, 2, None),
          "model4_h6": (1, 4, 6), "model4_h2": (1, 4, 2)}
GENERAL = {"data2_model2": ("cge", "quantized"),
           "model4_h2": ("cge", "quantized")}
GENERAL_CASES = [(k, m) for k, ms in GENERAL.items() for m in ms]


def _cfg(heads=None):
    cfg = get_config(ARCH).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    return cfg


def _jcfg(heads=None):
    from repro.configs.registry import get_config as jax_config
    jcfg = jax_config(ARCH).reduced()
    if heads:
        jcfg = dataclasses.replace(jcfg, n_heads=heads, n_kv_heads=heads)
    return jcfg


def _enc(b, seed=11):
    cfg = _cfg()
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _prompt():
    return np.random.default_rng(7).integers(
        0, 256, (2, PROMPT)).astype(np.int32)


def _cross_inputs():
    rng = np.random.default_rng(3)
    d = _cfg().d_model
    return (rng.normal(size=(2, 5, d)).astype(np.float32),
            rng.normal(size=(2, _cfg().encoder_seq, d)).astype(np.float32))


def _batches():
    from repro_torch.data.partition import mask_to_weights
    rng = np.random.default_rng(0)
    out = []
    for t in range(STEPS):
        x = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        mask = np.ones(N_AGENTS, bool)
        mask[[1, 3, 0][t]] = False
        out.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                    "weights": mask_to_weights(mask, B, S),
                    "enc_embed": _enc(B, seed=20 + t)})
    return out


def _general_data(n):
    """The general step's batches (every token weighted) and agent masks:
    with 2 agents, agent 1 missing at step 1; with one, none missing."""
    rng = np.random.default_rng(0)
    batches, masks = [], []
    for t in range(STEPS):
        x = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                        "weights": np.ones((B, S), np.float32),
                        "enc_embed": _enc(B, seed=30 + t)})
        m = np.ones(n, np.float32)
        if n > 1 and t == 1:
            m[1] = 0.0
        masks.append(m)
    return batches, masks


def _placed_tc():
    return dict(mode="masked", optimizer="adamw", lr=1e-4,
                lr_kind="cosine", lr_total=10, warmup=1,
                remat_policy="full")


def _general_tc(mode, n):
    return dict(mode=mode, optimizer="sgdm", lr=3e-2, lr_kind="cosine",
                lr_total=10, warmup=1, f=1 if n > 1 else 0, tau=1,
                remat_policy="full")


def _fill_all(cache, pre):
    """A dense decode cache (in place) from a prefill's: the prompt's rows
    of the self-attention K/V, the encoder's K/V whole."""
    for c, p in zip(cache, pre):
        for key in c["mixer"]:
            c["mixer"][key][:, :, :PROMPT] = p["mixer"][key]
        for key in c["cross"]:
            c["cross"][key].copy_(p["cross"][key])


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the port: one process (mesh None) or a rank's blocks (no JAX)


def _serve(mesh, cfg, np_params):
    """Encoder output, train logits, prefill logits and cross cache, decode
    logits and the serving steps' tokens, and the regression block."""
    from repro_torch.dist.tp import gather_from_tp, tp_context
    from repro_torch.launch import serve as V
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.layers import vocab_split
    params = M.params_from_jax(np_params)
    if mesh is not None:
        params = V.place_params(params, cfg, mesh)
    enc, prompt = torch.from_numpy(_enc(2)), torch.from_numpy(_prompt())

    def whole(logits):
        return (gather_from_tp(logits, -1) if vocab_split(logits, cfg)
                else logits).numpy().copy()

    out = {}
    with tp_context(mesh), torch.no_grad():
        out["encoder"] = M._apply_encoder(params, enc, cfg).numpy().copy()
        out["train"] = whole(M.apply_model(params, prompt, cfg,
                                           enc_embed=enc)[0])
        logits, _, pc = M.apply_model(params, prompt, cfg, mode="prefill",
                                      enc_embed=enc)
        logits = [whole(logits)]
        out["cross"] = [{k: v.numpy().copy() for k, v in c["cross"].items()}
                        for c in pc]
        cache = M.init_cache(cfg, 2, MAX_LEN, device="cpu")
        if mesh is not None:
            cache = V.place_cache(cache, cfg, mesh)
        _fill_all(cache, pc)
        for i in range(NEW):
            tok = logits[-1][:, -1].argmax(-1)
            step, _, _ = M.apply_model(
                params, torch.from_numpy(tok[:, None].astype(np.int32)),
                cfg, mode="decode", cache=cache, cache_index=PROMPT + i)
            logits.append(whole(step))
        out["logits"] = logits
        # the regression block: layer 0's cross-attention alone
        hx, kv = (torch.from_numpy(a) for a in _cross_inputs())
        p = _layer0(params["blocks"][0]["cross"])
        y, c = A.apply_gqa(p, hx, cfg, kv_x=kv, causal=False,
                           return_cache=True)
        y1, _ = A.apply_gqa(p, hx[:, :1], cfg, cache=c, causal=False)
        out["block"] = (y.numpy().copy(), y1.numpy().copy())
    out["wq"] = (params["blocks"][0]["cross"]["wq"].shape[-1],
                 params["encoder"]["mixer"]["wq"].shape[-1])
    if mesh is not None:
        batch = {"tokens": prompt, "enc_embed": enc}
        tok, pc = V.make_prefill_step(cfg, mesh=mesh)(params, batch)
        toks = [tok.numpy().copy()]
        big = V.place_cache(M.init_cache(cfg, 2, MAX_LEN, device="cpu"),
                            cfg, mesh)
        _fill_all(big, pc)
        dec = V.make_decode_step(cfg, mesh=mesh)
        for i in range(NEW):
            tok, _ = dec(params, {"tokens": tok[:, None], "cache": big,
                                  "pos": PROMPT + i})
            toks.append(tok.numpy().copy())
        out["tokens"] = toks
        out["cache_hd"] = [{k: v.shape[-1] for part in ("mixer", "cross")
                            for k, v in c[part].items()} for c in big]
    return out


def _placed(mesh, cfg, np_params):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    tc = T.TrainConfig(**_placed_tc())
    state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, device="cpu")
    state["params"] = params_from_jax(np_params)
    state, specs = T.place_state(state, mesh)
    step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS, dp="data",
                             tp="model", param_specs=specs["params"],
                             sizes=mesh.shape, mesh=mesh)
    ms = []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    whole = gather_tree(state["params"], specs["params"], mesh)
    return {"metrics": ms, "tp": step.placement.tp,
            "params": [l.numpy().copy() for l in tree_flatten(whole)[0]]}


def _general(mesh, cfg, mode, np_params):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.models.model import init_model, params_from_jax
    n = mesh.shape["data"]
    tc = T.TrainConfig(**_general_tc(mode, n))
    state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, n_agents=n, device="cpu", mesh=mesh)
    state["params"] = params_from_jax(np_params)
    state = T.place_general_state(state, mesh, cfg)
    specs = T.general_specs(
        cfg, init_model(None, cfg, device="meta", max_pos=64), mesh)
    step = T.make_general_step(cfg, tc, mesh)
    ms, err_rows = [], []
    for b, m in zip(*_general_data(n)):
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, m)
        ms.append((float(met["loss"]), float(met["grad_norm"])))
        if mode == "quantized":
            err_rows.append(np.concatenate([
                e.numpy().reshape(-1) for e in tree_flatten(state["err"])[0]]))
    whole = gather_tree(state["params"], specs, mesh)
    return {"metrics": ms, "tp": step.tp_axes, "err_rows": err_rows,
            "params": [l.numpy().copy() for l in tree_flatten(whole)[0]]}


def _rank(rank, world, meshes, np_params):
    from repro_torch.launch.mesh import Mesh
    out = {}
    for key in meshes:
        data, model, heads = MESHES[key]
        mesh = Mesh((data, model), ("data", "model"), device="cpu")
        cfg = _cfg(heads)
        out["serve", key] = _serve(mesh, cfg, np_params[heads])
        out["placed", key] = _placed(mesh, cfg, np_params[heads])
        for mode in GENERAL.get(key, ()):
            out[mode, key] = _general(mesh, cfg, mode, np_params[heads])
    return out


# ---------------------------------------------------------------------------
# the references: the port in one process, live JAX


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.models import model as jmodel
    return {h: jax.tree.map(np.asarray, jmodel.init_model(
        jax.random.PRNGKey(0), _jcfg(h), max_pos=64))
        for h in {m[2] for m in MESHES.values()}}


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    out = {}
    for world, meshes in ((2, ("model2",)),
                          (4, ("data2_model2", "model4_h6", "model4_h2"))):
        for rank, o in enumerate(run_ranks(
                _rank, world, backend="gloo", device="cpu", timeout=TIMEOUT,
                threads=1, args=(meshes, jax_params),
                store_dir=str(tmp_path_factory.mktemp("store")))):
            for k, v in o.items():
                out.setdefault(k, []).append(v)
    return out


_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _jax_serve(heads, jparams):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro.models import model as jmodel
    jcfg = _jcfg(heads)
    p = jax.tree.map(jnp.asarray, jparams)
    enc, prompt = jnp.asarray(_enc(2)), jnp.asarray(_prompt())
    out = {"encoder": np.asarray(jmodel._apply_encoder(p, enc, jcfg)),
           "train": np.asarray(jmodel.apply_model(p, prompt, jcfg,
                                                  enc_embed=enc)[0])}
    logits, _, pc = jmodel.apply_model(p, prompt, jcfg, mode="prefill",
                                       enc_embed=enc)
    out["cross"] = [{k: np.asarray(v) for k, v in c["cross"].items()}
                    for c in pc]
    logits = [np.asarray(logits)]
    cache = jmodel.init_cache(jcfg, 2, MAX_LEN)
    cache = jax.tree.map(lambda c, q: q if c.shape == q.shape
                         else c.at[:, :, :PROMPT].set(q), cache, pc)
    for i in range(NEW):
        tok = logits[-1][:, -1].argmax(-1)
        step, _, cache = jmodel.apply_model(
            p, jnp.asarray(tok[:, None].astype(np.int32)), jcfg,
            mode="decode", cache=cache, cache_index=PROMPT + i)
        logits.append(np.asarray(step))
    out["logits"] = logits
    hx, kv = (jnp.asarray(a) for a in _cross_inputs())
    blk = jax.tree.map(lambda a: a[0], p["blocks"][0]["cross"])
    y, c = jattn.apply_gqa(blk, hx, jcfg, kv_x=kv, causal=False,
                           return_cache=True)
    y1, _ = jattn.apply_gqa(blk, hx[:, :1], jcfg, cache=c, causal=False)
    out["block"] = (np.asarray(y), np.asarray(y1))
    return out


def _jax_placed(heads, jparams):
    import jax
    import jax.numpy as jnp
    from repro.launch import train as jtrain
    jcfg = _jcfg(heads)
    jtc = jtrain.TrainConfig(**_placed_tc())
    state = jtrain.init_state(jax.random.PRNGKey(0), jcfg, jtc, max_pos=64)
    state["params"] = jax.tree.map(jnp.asarray, jparams)
    step = jax.jit(jtrain.make_train_step(jcfg, jtc, moe_groups=N_AGENTS))
    ms = []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": ms, "params": [np.asarray(l, np.float32) for l in
                                      jax.tree.leaves(state["params"])]}


def _port_placed(heads, np_params):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    cfg = _cfg(heads)
    tc = T.TrainConfig(**_placed_tc())
    state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, device="cpu")
    state["params"] = params_from_jax(np_params)
    step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS)
    ms = []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": ms, "params": [l.numpy().copy() for l in
                                      tree_flatten(state["params"])[0]]}


def _adopt_ties(x, deq, rx, port_err):
    """The reference's dequantized ``deq`` of ``x`` (n, P), with the
    rank's int8 values (from its residual rows ``port_err``) at the
    received coordinates within ``TIE`` of a rounding tie; the two must
    agree at every other received coordinate."""
    scale = np.maximum(np.max(np.abs(x), axis=-1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-30))
    r = x / scale
    q = np.clip(np.round(r), -127, 127)
    q_port = np.clip(np.round((x - port_err) / scale), -127, 127)
    tie = np.abs(np.abs(r - np.floor(r)) - 0.5) < TIE
    rows = rx[:, None]
    assert np.array_equal(q_port[rows & ~tie], q[rows & ~tie])
    return np.where(rows & tie, (q_port * scale).astype(np.float32), deq)


def _jax_general(heads, mode, n, jparams, port_err):
    """The general step from live ``repro``: per-agent ``value_and_grad``
    of JAX's loss, the ``repro.core.gradagg`` rule, JAX's clipping,
    optimizer and update."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from repro.core import gradagg
    from repro.launch import train as jtrain
    from repro.optim.optimizers import apply_updates, clip_by_global_norm
    tc = jtrain.TrainConfig(**_general_tc(mode, n))
    opt = jtrain.make_optimizer(tc)
    vg = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(_jcfg(heads), tc,
                                                        1)))
    params, ost = jparams, opt.init(jparams)
    unravel = ravel_pytree(params)[1]
    err, per, ms = None, B // n, []
    for t, (b, m) in enumerate(zip(*_general_data(n))):
        losses, grads = [], []
        for j in range(n):
            loss, g = vg(params, {k: jnp.asarray(v[j * per:(j + 1) * per])
                                  for k, v in b.items()})
            losses.append(float(loss))
            grads.append(np.asarray(ravel_pytree(g)[0], np.float32))
        g, rx = np.stack(grads), m > 0
        lsum = float(np.sum(np.float32(losses) * m))
        if mode == "cge":
            keep = np.asarray(gradagg.cge_mask(jnp.asarray(g),
                                               jnp.asarray(rx), tc.f))
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(g),
                                             jnp.asarray(keep)))
            denom = float(keep.sum())
        else:
            x = g if err is None else g + err
            deq = np.asarray(gradagg.quantize_int8(jnp.asarray(x))[0])
            deq = _adopt_ties(x, deq, rx, port_err[t])
            agg = np.asarray(gradagg.agg_sum(jnp.asarray(deq),
                                             jnp.asarray(rx)))
            err = np.where(rx[:, None], x - deq, x)
            denom = float(m.sum())
        denom = max(denom, 1.0)
        agg, gnorm = clip_by_global_norm(
            unravel(jnp.asarray(agg / np.float32(denom))), tc.clip_norm)
        upd, ost = opt.update(agg, ost, params, jnp.asarray(t, jnp.int32))
        params = apply_updates(params, upd,
                               jtrain.lr_at(tc, jnp.asarray(t, jnp.int32)))
        ms.append((lsum / denom, float(gnorm)))
    return {"metrics": ms, "params": [np.asarray(l, np.float32)
                                      for l in jax.tree.leaves(params)]}


def _port_general(heads, mode, n, np_params, port_err):
    """The same step from the port in one process: each agent's gradient
    by the port's loss, ``core.gradagg``'s rule, the port's clipping,
    optimizer and update."""
    from repro_torch.core import gradagg
    from repro_torch.core.ledger import layout_of, tree_flatten, tree_map
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    from repro_torch.optim.optimizers import (apply_updates,
                                              clip_by_global_norm)
    cfg = _cfg(heads)
    tc = T.TrainConfig(**_general_tc(mode, n))
    opt = T.make_optimizer(tc)
    params = params_from_jax(np_params)
    ost = opt.init(params)
    loss_fn = T.make_loss_fn(cfg, tc, 1)
    err, per, ms = None, B // n, []
    for t, (b, m) in enumerate(zip(*_general_data(n))):
        losses, grads = [], []
        for j in range(n):
            loss, g = T.value_and_grad(loss_fn, params, {
                k: torch.from_numpy(v[j * per:(j + 1) * per])
                for k, v in b.items()})
            losses.append(float(loss))
            layout = layout_of(g)
            grads.append(layout.flatten(g))
        g, rx = torch.stack(grads), torch.from_numpy(m > 0)
        lsum = float(np.sum(np.float32(losses) * m))
        if mode == "cge":
            keep = gradagg.cge_mask(g, rx, tc.f)
            agg, denom = gradagg.agg_sum(g, keep), float(keep.sum())
        else:
            x = g if err is None else g + err
            deq = torch.from_numpy(_adopt_ties(
                x.numpy(), gradagg.quantize_int8(x)[0].numpy(), m > 0,
                port_err[t]))
            agg, denom = gradagg.agg_sum(deq, rx), float(m.sum())
            err = torch.where(rx[:, None], x - deq, x)
        denom = max(denom, 1.0)
        agg, gnorm = clip_by_global_norm(
            layout.unflatten(agg / np.float32(denom), dtype=torch.float32),
            tc.clip_norm)
        agg = tree_map(lambda a, p: a.to(p.dtype), agg, params)
        upd, ost = opt.update(agg, ost, params, t)
        params = apply_updates(params, upd, T.lr_at(tc, t))
        ms.append((lsum / denom, float(gnorm)))
    return {"metrics": ms, "params": [l.detach().numpy().copy()
                                      for l in tree_flatten(params)[0]]}


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# the tests


@pytest.mark.parametrize("heads", [None, 6, 2])
def test_one_process_matches_live_reference(jax_params, heads):
    """The port's one process against JAX: encoder output, train, prefill
    and decode logits, the prefill's cross cache, the regression block."""
    one = _memo(("serve", heads), lambda: _serve(None, _cfg(heads),
                                                 jax_params[heads]))
    ref = _memo(("jax_serve", heads), lambda: _jax_serve(heads,
                                                         jax_params[heads]))
    for key in ("encoder", "train", "cross", "logits", "block"):
        _close(one[key], ref[key])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", ["encoder", "train", "prefill", "decode"])
def test_tp_serving_matches_one_process(spawned, jax_params, mesh, case):
    """Every rank within TOL of the one process. The prefill's logits and
    its cross ``ck`` / ``cv``, this rank's head_dim block of the one
    process's; decode logits over that cache and the steps' tokens at
    the one process's argmax; every cache leaf's head_dim block."""
    heads = MESHES[mesh][2]
    cfg = _cfg(heads)
    one = _memo(("serve", heads), lambda: _serve(None, cfg,
                                                 jax_params[heads]))
    hd, n = cfg.resolved_head_dim, MESHES[mesh][1]
    for r, got in enumerate(spawned["serve", mesh]):
        if case in ("encoder", "train"):
            _close(got[case], one[case])
        elif case == "prefill":
            _close(got["logits"][0], one["logits"][0])
            blk = slice(r % n * hd // n, (r % n + 1) * hd // n)
            _close(got["cross"], [{k: v[..., blk] for k, v in c.items()}
                                  for c in one["cross"]])
        else:
            _close(got["logits"], one["logits"])
            want = [w[:, -1].argmax(-1) for w in one["logits"]]
            for a, b in zip(got["tokens"], want):
                np.testing.assert_array_equal(a, b)
            assert got["cache_hd"] == [{k: hd // n for k in
                                        ("k", "v", "ck", "cv")}]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_cross_attention_block_attends_over_the_encoder(spawned,
                                                           jax_params,
                                                           mesh):
    """The regression: one cross-attention block on a rank's split
    weights (``wq`` narrower than H x head_dim, as in every encoder
    layer, so ``apply_gqa`` dispatches to its tensor-parallel form)
    attends over ``kv_x``, and its decode over ``ck`` / ``cv``, as the
    whole block does."""
    heads = MESHES[mesh][2]
    cfg = _cfg(heads)
    one = _memo(("serve", heads), lambda: _serve(None, cfg,
                                                 jax_params[heads]))
    width = cfg.n_heads * cfg.resolved_head_dim
    assert one["wq"] == (width, width)
    for got in spawned["serve", mesh]:
        assert got["wq"] == (width // MESHES[mesh][1],) * 2
        _close(got["block"], one["block"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_placed_step_matches_one_process(spawned, jax_params, mesh):
    """The placed masked step (AdamW, remat, ``enc_embed`` in the batch):
    every rank's loss, grad norm and gathered parameters within TOL of
    the port's one process, which is within TOL of JAX's."""
    heads = MESHES[mesh][2]
    one = _memo(("placed", heads), lambda: _port_placed(heads,
                                                        jax_params[heads]))
    ref = _memo(("jax_placed", heads), lambda: _jax_placed(
        heads, jax_params[heads]))
    _close(one, ref)
    for got in spawned["placed", mesh]:
        assert got["tp"] == ("model",)
        _close(got["metrics"], one["metrics"])
        _close(got["params"], one["params"])
    first = spawned["placed", mesh][0]
    for got in spawned["placed", mesh][1:]:
        assert got["metrics"] == first["metrics"]


@pytest.mark.parametrize("mesh,mode", GENERAL_CASES)
def test_tp_general_step_matches_one_process(spawned, jax_params, mesh,
                                             mode):
    """The general step, cge and quantized (SGD-momentum, remat,
    ``enc_embed`` in the batch; model 4 with 2 heads runs the general
    program's partial scores): every rank within TOL of the port's one
    process, which is within TOL of JAX's."""
    data, model, heads = MESHES[mesh]
    runs = spawned[mode, mesh]
    port_err = None
    if mode == "quantized":      # each agent's rows, from its model rank 0
        port_err = [np.stack([runs[d * model]["err_rows"][t]
                              for d in range(data)]) for t in range(STEPS)]
    one = _port_general(heads, mode, data, jax_params[heads], port_err)
    _close(one, _jax_general(heads, mode, data, jax_params[heads],
                             port_err))
    for got in runs:
        assert got["tp"] == ("model",)
        _close(got["metrics"], one["metrics"])
        _close(got["params"], one["params"])
