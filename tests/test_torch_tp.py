"""Tensor-parallel compute over "model" for the attention decoders, GQA
and MLA, dense and MoE, jamba's Mamba hybrid and RWKV-6
(``repro_torch.dist.tp`` and the layers, steps
and placement that read it), on gloo ranks of the CPU, against live
``repro`` run unsharded (the reference's numbers do not depend on its
layout):

- the four tp Functions (``copy_to_tp``, ``reduce_from_tp``,
  ``gather_from_tp``, ``scatter_to_tp``, with and without head groups)
  give one process's autograd values and gradients;
- the placed masked step of reduced qwen2-0.5b (tied embeddings, QKV
  bias), yi-6b (untied unembedding), arctic-480b (4 experts over the tp
  ranks, top-2, the dense residual, untied; 4 dispatch groups) and
  deepseek-v2-236b (MLA: its latents, ``w_uk`` / ``w_uv`` and ``wo``
  over tp; 4 experts, top-2, a shared expert; remat), 2 layers, and
  jamba-v0.1-52b (one period of 8 layers: 7 Mamba mixers over tp, one
  GQA layer, 4 MoE blocks of 4 experts; remat) and rwkv6-3b (2 layers,
  every weight's columns over tp; remat), f32,
  SGD-momentum and AdamW, 3 steps with a mask dropping one of 4 agents,
  on data 1 x model 2 (H % tp = 0: each rank its own heads), data 2 x
  model 2, and data 1 x model 4 with 6 query heads (``wq`` split across
  head boundaries, the heads over gcd(6, 4) = 2 groups), jamba and
  rwkv6 on the last two only (AdamW, then SGD-momentum): loss, grad norm
  and the gathered parameters within ``TOL`` of the reference's
  ``make_train_step``, and identical on every rank;
- ``launch.serve``'s prefill and decode at model 2 and 4 (arctic at
  model 4: one expert a rank; deepseek's cache holds this rank's latent
  and rope-key columns, jamba's its block of each Mamba state's d_state
  and conv rows' di, rwkv6's every head's block of value columns and its
  token-shift rows' columns): logits within ``TOL`` of the reference's,
  greedy tokens equal;
- a rank's matmul FLOPs (``OpCounter`` on the meta device) are 1/tp of
  the one-process step's, but for the whole leaves ``wk`` / ``wv`` (a
  rank projects the KV heads its query heads read) and the tied
  unembedding's input gradient where many tokens gathered the weight
  (whole on every rank, as the reference's compiled step computes it),
  arctic's and deepseek's experts and router, deepseek's MLA, jamba's
  Mamba and rwkv6's time and channel mixes included: the step does not
  gather whole and compute whole;
- at model = 1 the dense step is bit for bit the placed step as it was
  before tensor-parallel compute (a digest of the same run on a tree
  without it); reduced whisper-base, which computed whole on every rank
  until its own slice, now computes tensor-parallel on data 2 x model 2
  (its batches carry no frames here, so its decoder runs alone; the
  encoder and cross-attention are ``tests/test_torch_whisper_tp.py``'s):
  within TOL of its one-process step, and its rank FLOPs below the
  one-rank step's.

TOL is 1e-5 (rtol and atol), as the placed step's own parity tests:
the partial products are summed over ranks in another order. jamba's
and rwkv6's serving logits are held within TOL of the port's one process
and within 1e-4 of JAX's, the bound ``test_torch_families.py`` holds the
one process to (their scans and f32 states against the reference's);
rwkv6's placed step is held to that bound against JAX too, which its
one-process step misses TOL by, and within TOL of the port's own
one-process step (its AdamW grad norms within ``ADAMW_NORM_TOL``).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
N_AGENTS, B, S, STEPS = 4, 8, 16, 3
TIMEOUT = 300
JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
ARCHS = ("qwen2-0.5b", "yi-6b", "arctic-480b", "deepseek-v2-236b", JAMBA,
         RWKV)
WHOLE = "whisper-base"      # once computed whole on every rank
OPTIMIZERS = ("sgdm", "adamw")
# name -> (data, model, n_heads patch)
MESHES = {"model2": (1, 2, None), "data2_model2": (2, 2, None),
          "model4_h6": (1, 4, 6)}
# every mesh and optimizer, but jamba's 8-layer period (about 20 s of JAX
# compilation a step) and rwkv6 on two: data 2 x model 2 with AdamW,
# model 4 with SGD-momentum
PLACED = ([(m, n, o) for m in sorted(MESHES) for n in ARCHS
           if n not in (JAMBA, RWKV) for o in OPTIMIZERS]
          + [("data2_model2", n, "adamw") for n in (JAMBA, RWKV)]
          + [("model4_h6", n, "sgdm") for n in (JAMBA, RWKV)])
SERVE = (("model2", "qwen2-0.5b"), ("model2", "yi-6b"),
         ("model4_h6", "qwen2-0.5b"), ("model2", "arctic-480b"),
         ("model4_h6", "arctic-480b"), ("model2", "deepseek-v2-236b"),
         ("model4_h6", "deepseek-v2-236b"), ("model4_h6", JAMBA),
         ("model2", RWKV), ("model4_h6", RWKV))
# logits of a recurrent family against JAX's: the bound the one-process
# port is held to (``test_torch_families.py``), the TP run within TOL of
# the one process's. rwkv6's placed step is held to it against JAX too:
# the one-process port's own step misses TOL there (AdamW: grad norm
# 1.545e-3 of 39.07 at step 3, parameters 3.12e-5)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-4)
# rwkv6's AdamW grad norms against the port's one process (measured 1.3e-5
# of the norm at step 3; test_tp_rwkv_placed_step_matches_one_process)
ADAMW_NORM_TOL = dict(rtol=2e-5, atol=1e-5)
PROMPT, NEW, MAX_LEN = 6, 4, 12


def _patch(cfg, heads):
    """Two layers, or one period of a longer layer pattern (jamba's 8)."""
    return {"n_layers": max(2, len(cfg.layer_pattern)),
            **({"n_heads": heads} if heads else {})}


def _cfg(name, heads=None):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, **_patch(cfg, heads))


def _tc_kwargs(name, optimizer):
    return dict(mode="masked", optimizer=optimizer,
                lr=3e-2 if optimizer == "sgdm" else 1e-4,
                lr_kind="cosine", lr_total=10, warmup=1,
                remat_policy=("full" if name in ("yi-6b", "arctic-480b",
                                                 "deepseek-v2-236b",
                                                 "jamba-v0.1-52b", RWKV)
                              else "none"))


def _batches():
    from repro_torch.data.partition import mask_to_weights
    rng = np.random.default_rng(0)
    out = []
    for t in range(STEPS):
        x = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        mask = np.ones(N_AGENTS, bool)
        mask[[1, 3, 0][t]] = False
        out.append({"tokens": x[:, :-1], "targets": x[:, 1:],
                    "weights": mask_to_weights(mask, B, S)})
    return out


def _prompt():
    return np.random.default_rng(7).integers(
        0, 256, (2, PROMPT)).astype(np.int32)


def _fill(buf, pre):
    """A dense decode cache's leaf (in place) from the prefill's: the
    prompt's rows of an attention cache, a Mamba or RWKV layer's whole
    state."""
    if buf.shape == pre.shape:
        buf.copy_(pre)
    else:
        buf[:, :, :PROMPT] = pre


def _fill_all(cache, pre):
    """Every layer's mixer and FFN (RWKV's channel mix) cache from the
    prefill's."""
    for c, p in zip(cache, pre):
        for part in ("mixer", "ffn"):
            for key in c[part]:
                _fill(c[part][key], p[part][key])


# ---------------------------------------------------------------------------
# rank side (no JAX)


def _train(mesh, cfg, tc, np_params, batches):
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.dist.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                         max_pos=64, device="cpu")
    state["params"] = params_from_jax(np_params)
    state, specs = T.place_state(state, mesh)
    step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS, dp="data",
                             tp="model", param_specs=specs["params"],
                             sizes=mesh.shape, mesh=mesh)
    ms = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    whole = gather_tree(state["params"], specs["params"], mesh)
    return {"metrics": ms, "tp": step.placement.tp,
            "params": [l.numpy().copy() for l in tree_flatten(whole)[0]]}


def _serve(mesh, cfg, np_params):
    from repro_torch.dist.tp import gather_from_tp, tp_context
    from repro_torch.launch import serve as V
    from repro_torch.models.layers import vocab_split
    from repro_torch.models.model import (apply_model, init_cache,
                                          params_from_jax)
    params = V.place_params(params_from_jax(np_params), cfg, mesh)
    prompt = torch.from_numpy(_prompt())

    def whole(logits):
        return (gather_from_tp(logits, -1) if vocab_split(logits, cfg)
                else logits)

    with tp_context(mesh), torch.no_grad():
        logits, _, pc = apply_model(params, prompt, cfg, mode="prefill")
        out = [whole(logits).numpy().copy()]
        cache = V.place_cache(init_cache(cfg, 2, MAX_LEN, device="cpu"),
                              cfg, mesh)
        _fill_all(cache, pc)
        tok = out[0][:, -1].argmax(-1)
        for i in range(NEW):
            logits, _, _ = apply_model(
                params, torch.from_numpy(tok[:, None].astype(np.int32)),
                cfg, mode="decode", cache=cache, cache_index=PROMPT + i)
            out.append(whole(logits).numpy().copy())
            tok = out[-1][:, -1].argmax(-1)
    # the steps' own tokens
    tok, cache = V.make_prefill_step(cfg, mesh=mesh)(params,
                                                     {"tokens": prompt})
    steps = [tok.numpy().copy()]
    dec = V.make_decode_step(cfg, mesh=mesh)
    big = V.place_cache(init_cache(cfg, 2, MAX_LEN, device="cpu"), cfg,
                        mesh)
    _fill_all(big, cache)
    for i in range(NEW):
        tok, _ = dec(params, {"tokens": tok[:, None], "cache": big,
                              "pos": PROMPT + i})
        steps.append(tok.numpy().copy())
    return {"logits": out, "tokens": steps,
            "cache_hd": [{k: v.shape[-1] for part in ("mixer", "ffn")
                          for k, v in c[part].items()} for c in big]}


def _rank(rank, world, meshes, np_params, batches):
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import Mesh
    out = {}
    built = {k: Mesh(MESHES[k][:2], ("data", "model"), device="cpu")
             for k in meshes}
    for key in meshes:
        heads = MESHES[key][2]
        for name, opt in ((n, o) for m, n, o in PLACED if m == key):
            tc = T.TrainConfig(**_tc_kwargs(name, opt))
            out[key, name, opt] = _train(built[key], _cfg(name, heads), tc,
                                         np_params[name, heads], batches)
        for skey, name in SERVE:
            if skey == key:
                out["serve", key, name] = _serve(
                    built[key], _cfg(name, heads), np_params[name, heads])
    if world == 4:
        # model = 1, and whisper-base (once computed whole) at model 2
        tc = T.TrainConfig(**_tc_kwargs("qwen2-0.5b", "adamw"))
        out["model1"] = _train(Mesh((4, 1), ("data", "model"),
                                    device="cpu"),
                               _cfg("qwen2-0.5b"), tc,
                               np_params["qwen2-0.5b", None], batches)
        out["whisper"] = _train(built["data2_model2"], _cfg(WHOLE),
                                T.TrainConfig(**_tc_kwargs(WHOLE, "adamw")),
                                np_params[WHOLE, None], batches)
    return out


# ---------------------------------------------------------------------------
# the four Functions


def _inputs():
    g = torch.Generator().manual_seed(1)
    return [torch.randn(*shape, generator=g, dtype=torch.float64)
            for shape in ((3, 8), (8, 12), (12, 8), (3, 12))]


def _functions_rank(rank, world):
    from repro_torch.dist.tp import (copy_to_tp, gather_from_tp,
                                     reduce_from_tp, scatter_to_tp,
                                     tp_context)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, world), ("data", "model"), device="cpu")
    x, w1, w2, c = _inputs()
    out = {}
    cols = slice(rank * 12 // world, (rank + 1) * 12 // world)
    with tp_context(mesh):
        # column then row parallel: copy_to_tp, reduce_from_tp
        xs = x.clone().requires_grad_(True)
        a = w1[:, cols].clone().requires_grad_(True)
        bb = w2[cols].clone().requires_grad_(True)
        y = reduce_from_tp(torch.tanh(copy_to_tp(xs) @ a) @ bb)
        y.square().sum().backward()
        out["mlp"] = (y.detach(), xs.grad, a.grad, bb.grad)
        # gather to the whole / to a group's block, compute there, scatter
        # back to this rank's block, sum over tp
        for groups in (1, 2):
            xs = (x @ w1)[:, cols].clone().requires_grad_(True)
            z = gather_from_tp(xs, -1, groups)
            v = scatter_to_tp(torch.tanh(z), -1, groups)
            reduce_from_tp((v * c[:, cols]).sum()).backward()
            out["gather", groups] = (z.detach(), v.detach(), xs.grad)
        # copy_to_tp over 2 groups: a column block each group computes
        xs = x.clone().requires_grad_(True)
        grp = slice(rank // (world // 2) * 6, (rank // (world // 2) + 1) * 6)
        h = scatter_to_tp(copy_to_tp(xs, 2) @ w1[:, grp], -1, 2)
        reduce_from_tp((h * c[:, cols]).sum()).backward()
        out["copy_groups"] = (h.detach(), xs.grad)
        # the tied unembedding on both of its paths: few tokens (partial
        # logits) and many (the weight gathered)
        from repro_torch.dist.tp import current_tp
        from repro_torch.models.layers import _TiedUnembed
        for n_tok in (4, 12):
            xs = w2[:n_tok].clone().requires_grad_(True)      # (n, 8)
            tok = w1.T[:, rank * 8 // world:(rank + 1) * 8 // world]
            tok = tok.clone().requires_grad_(True)          # (12, 8 / n)
            rows = slice(rank * 12 // world, (rank + 1) * 12 // world)
            y = _TiedUnembed.apply(current_tp(), xs, tok, 12)
            reduce_from_tp((y * c.repeat(4, 1)[:n_tok, rows])
                           .sum()).backward()
            out["tied", n_tok] = (y.detach(), xs.grad, tok.grad)
    return out


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    return run_ranks(_functions_rank, 4, backend="gloo", device="cpu",
                     timeout=TIMEOUT, threads=1,
                     store_dir=str(tmp_path_factory.mktemp("store")))


def test_tp_functions_equal_one_process_autograd(functions):
    x, w1, w2, c = _inputs()
    n = len(functions)
    xs, a, bb = (t.clone().requires_grad_(True) for t in (x, w1, w2))
    y = torch.tanh(xs @ a) @ bb
    y.square().sum().backward()
    h = x @ w1
    dz = c * (1 - torch.tanh(h) ** 2)
    for r, o in enumerate(functions):
        cols = slice(r * 12 // n, (r + 1) * 12 // n)
        got_y, got_x, got_a, got_b = o["mlp"]
        torch.testing.assert_close(got_y, y.detach())
        torch.testing.assert_close(got_x, xs.grad)
        torch.testing.assert_close(got_a, a.grad[:, cols])
        torch.testing.assert_close(got_b, bb.grad[cols])
        for groups in (1, 2):
            j = r // (n // groups)
            blk = slice(j * 12 // groups, (j + 1) * 12 // groups)
            z, v, gx = o["gather", groups]
            assert torch.equal(z, h[:, blk])           # exact: -0.0 pads
            assert torch.equal(v, torch.tanh(h)[:, cols])
            torch.testing.assert_close(gx, dz[:, cols])
        got_h, got_x = o["copy_groups"]
        assert torch.equal(got_h, h[:, cols])
        torch.testing.assert_close(got_x, c @ w1.T)  # each group once
        for n_tok in (4, 12):
            tx = w2[:n_tok].clone().requires_grad_(True)
            tok = w1.T.clone().requires_grad_(True)
            ty = tx @ tok.T
            (ty * c.repeat(4, 1)[:n_tok]).sum().backward()
            got_y, got_x, got_t = o["tied", n_tok]
            dcols = slice(r * 8 // n, (r + 1) * 8 // n)
            torch.testing.assert_close(got_y, ty.detach()[:, cols])
            torch.testing.assert_close(got_x, tx.grad)
            torch.testing.assert_close(got_t, tok.grad[:, dcols])


# ---------------------------------------------------------------------------
# the placed step and serving against live JAX


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jmodel
    out = {}
    for name in ARCHS + (WHOLE,):
        for heads in ((None, 6) if name in ARCHS else (None,)):
            jcfg = jax_config(name).reduced()
            jcfg = dataclasses.replace(jcfg, **_patch(jcfg, heads))
            out[name, heads] = jax.tree.map(
                np.asarray, jmodel.init_model(jax.random.PRNGKey(0), jcfg,
                                              max_pos=64))
    return out


@pytest.fixture(scope="module")
def spawned(jax_params, tmp_path_factory):
    batches = _batches()
    out = {}
    for world, meshes in ((2, ("model2",)),
                          (4, ("data2_model2", "model4_h6"))):
        res = run_ranks(_rank, world, backend="gloo", device="cpu",
                        timeout=TIMEOUT, threads=1,
                        args=(meshes, jax_params, batches),
                        store_dir=str(tmp_path_factory.mktemp("store")))
        out[world] = res
    return batches, out


def _ranks_of(spawned, key):
    return spawned[1][2 if key == "model2" else 4]


_JAX_TRAIN = {}


def _jax_train(name, heads, opt, jparams, batches):
    """The reference's loss, grad norm and parameters after the steps
    (one run per config and optimizer, shared by the meshes)."""
    if (name, heads, opt) not in _JAX_TRAIN:
        _JAX_TRAIN[name, heads, opt] = _run_jax_train(name, heads, opt,
                                                      jparams, batches)
    return _JAX_TRAIN[name, heads, opt]


def _run_jax_train(name, heads, opt, jparams, batches):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.launch import train as jtrain
    jcfg = jax_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, **_patch(jcfg, heads))
    jtc = jtrain.TrainConfig(**_tc_kwargs(name, opt))
    state = jtrain.init_state(jax.random.PRNGKey(0), jcfg, jtc, max_pos=64)
    state["params"] = jax.tree.map(jnp.asarray, jparams)
    step = jax.jit(jtrain.make_train_step(jcfg, jtc, moe_groups=N_AGENTS))
    ms = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return ms, [np.asarray(l, np.float32)
                for l in jax.tree.leaves(state["params"])]


_ONE_TRAIN = {}


def _one_process_train(name, heads, opt, np_params, batches):
    """The port's own one-process ``make_train_step`` from the same
    parameters: its metrics and parameters after the steps."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.launch import train as T
    from repro_torch.models.model import params_from_jax
    key = (name, heads, opt)
    if key not in _ONE_TRAIN:
        cfg = _cfg(name, heads)
        tc = T.TrainConfig(**_tc_kwargs(name, opt))
        state = T.init_state(torch.Generator().manual_seed(0), cfg, tc,
                             max_pos=64, device="cpu")
        state["params"] = params_from_jax(np_params)
        step = T.make_train_step(cfg, tc, moe_groups=N_AGENTS)
        ms = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        _ONE_TRAIN[key] = (ms, [l.numpy().copy() for l in
                                tree_flatten(state["params"])[0]])
    return _ONE_TRAIN[key]


@pytest.mark.parametrize("mesh,name,opt", PLACED)
def test_tp_placed_step_matches_live_reference(spawned, jax_params, mesh,
                                               name, opt):
    batches, _ = spawned
    heads = MESHES[mesh][2]
    want_m, want_p = _jax_train(name, heads, opt,
                                jax_params[name, heads], batches)
    ranks = _ranks_of(spawned, mesh)
    tol = RECURRENT_TOL if name == RWKV else TOL
    for o in ranks:
        got = o[mesh, name, opt]
        assert got["tp"] == ("model",)              # the TP path ran
        np.testing.assert_allclose(np.array(got["metrics"]),
                                   np.array(want_m), **tol)
        assert len(got["params"]) == len(want_p)
        for a, b in zip(got["params"], want_p):
            np.testing.assert_allclose(a, b, **tol)
    for o in ranks[1:]:                             # identical on every rank
        assert o[mesh, name, opt]["metrics"] == \
            ranks[0][mesh, name, opt]["metrics"]
        for a, b in zip(o[mesh, name, opt]["params"],
                        ranks[0][mesh, name, opt]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh,name,opt",
                         [c for c in PLACED if c[1] == RWKV])
def test_tp_rwkv_placed_step_matches_one_process(spawned, jax_params, mesh,
                                                 name, opt):
    """rwkv6's placed step within TOL of the port's own one-process step
    from the same parameters (where JAX is held to RECURRENT_TOL): every
    parameter, the losses and, with SGD-momentum, the grad norms. With
    AdamW the grad norm moves by 1.3e-5 of itself over 3 steps (step 1's
    bit for bit, 5.2e-4 of 39.07 at step 3, where the one process is
    1.5e-3 from JAX): AdamW's normalised update carries the partial sums'
    order into the next gradient. It is held at ADAMW_NORM_TOL."""
    batches, _ = spawned
    heads = MESHES[mesh][2]
    one_m, one_p = _one_process_train(name, heads, opt,
                                      jax_params[name, heads], batches)
    norm_tol = ADAMW_NORM_TOL if opt == "adamw" else TOL
    for o in _ranks_of(spawned, mesh):
        got = o[mesh, name, opt]
        loss, norm = np.array(got["metrics"]).T
        np.testing.assert_allclose(loss, np.array(one_m)[:, 0], **TOL)
        np.testing.assert_allclose(norm, np.array(one_m)[:, 1], **norm_tol)
        assert len(got["params"]) == len(one_p)
        for a, b in zip(got["params"], one_p):
            np.testing.assert_allclose(a, b, **TOL)


def _jax_serve(name, heads, jparams):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import model as jmodel
    jcfg = jax_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, **_patch(jcfg, heads))
    p = jax.tree.map(jnp.asarray, jparams)
    prompt = jnp.asarray(_prompt())
    logits, _, pc = jmodel.apply_model(p, prompt, jcfg, mode="prefill")
    out = [np.asarray(logits)]
    cache = jmodel.init_cache(jcfg, 2, MAX_LEN)
    cache = jax.tree.map(lambda c, q: q if c.shape == q.shape
                         else c.at[:, :, :PROMPT].set(q), cache, pc)
    tok = out[0][:, -1].argmax(-1)
    for i in range(NEW):
        logits, _, cache = jmodel.apply_model(
            p, jnp.asarray(tok[:, None].astype(np.int32)), jcfg,
            mode="decode", cache=cache, cache_index=PROMPT + i)
        out.append(np.asarray(logits))
        tok = out[-1][:, -1].argmax(-1)
    return out


def _one_process_serve(cfg, np_params):
    """The port's logits in one process, as ``_serve``'s first part
    computes them on a rank's blocks."""
    from repro_torch.models.model import (apply_model, init_cache,
                                          params_from_jax)
    params = params_from_jax(np_params)
    with torch.no_grad():
        logits, _, pc = apply_model(params, torch.from_numpy(_prompt()), cfg,
                                    mode="prefill")
        out = [logits.numpy().copy()]
        cache = init_cache(cfg, 2, MAX_LEN, device="cpu")
        _fill_all(cache, pc)
        for i in range(NEW):
            tok = out[-1][:, -1].argmax(-1)
            logits, _, _ = apply_model(
                params, torch.from_numpy(tok[:, None].astype(np.int32)),
                cfg, mode="decode", cache=cache, cache_index=PROMPT + i)
            out.append(logits.numpy().copy())
    return out


@pytest.mark.parametrize("mesh,name", SERVE)
def test_tp_prefill_and_decode_match_live_reference(spawned, jax_params,
                                                    mesh, name):
    heads = MESHES[mesh][2]
    want = _jax_serve(name, heads, jax_params[name, heads])
    tp = MESHES[mesh][1]
    cfg = _cfg(name, heads)
    tol, one = TOL, None
    if cfg.sub_quadratic:
        tol, one = RECURRENT_TOL, _one_process_serve(
            cfg, jax_params[name, heads])
    # every layer's cache: head_dim over tp; MLA's latent and rope key
    # columns; Mamba's state h over d_state, its conv rows over di;
    # RWKV's state over its value columns, its token-shift rows over d
    def cols(kind):
        if kind == "mamba":
            return {"h": cfg.ssm.d_state // tp,
                    "conv": cfg.ssm.expand * cfg.d_model // tp}
        if kind == "rwkv":
            return {"wkv": cfg.rwkv.head_dim // tp,
                    "tm_x": cfg.d_model // tp, "cm_x": cfg.d_model // tp}
        if cfg.mla:
            return {"ckv": cfg.mla.kv_lora_rank // tp,
                    "kr": cfg.mla.qk_rope_head_dim // tp}
        return {"k": cfg.resolved_head_dim // tp,
                "v": cfg.resolved_head_dim // tp}

    want_cols = [cols(kind) for kind in cfg.layer_pattern]
    for o in _ranks_of(spawned, mesh):
        got = o["serve", mesh, name]
        assert got["cache_hd"] == want_cols
        for a, b in zip(got["logits"], want):
            np.testing.assert_allclose(a, b, **tol)
        for a, b in zip(got["logits"], one or ()):
            np.testing.assert_allclose(a, b, **TOL)
        toks = [w[:, -1].argmax(-1) for w in want]
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)


# sha256 of (metrics, gathered parameters) after the 3 steps, as the
# placed step computed them before tensor-parallel compute existed (the
# same run on the parent tree of this module, torch 2.13 CPU, gloo);
# whisper's placed step is held against its one-process step since it
# computes tensor-parallel
BEFORE_TP = {
    "model1": "65ffb24061fc2a877bfbdaaf222b22536a2c2ed2"
              "b862b605836e972f0f8c110d",
    "whisper": None,
}


def _digest(run):
    h = hashlib.sha256(repr(run["metrics"]).encode())
    for p in run["params"]:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(BEFORE_TP))
def test_model_one_and_other_families_are_bit_for_bit_unchanged(spawned,
                                                                 jax_params,
                                                                 key):
    """Dense qwen2-0.5b on data 4 x model 1: no tp axis engaged, and
    every rank's result bit for bit the step's before this layer existed.
    Reduced whisper-base on data 2 x model 2, whose digest was the step
    before tensor-parallel compute until it computed tensor-parallel
    itself: the tp axis engaged, every rank within TOL of the port's
    one-process step and identical on every rank."""
    ranks = _ranks_of(spawned, "data2_model2")
    if BEFORE_TP[key] is not None:
        for o in ranks:
            assert o[key]["tp"] == ()
            assert _digest(o[key]) == BEFORE_TP[key]
        return
    batches, _ = spawned
    one_m, one_p = _one_process_train(WHOLE, None, "adamw",
                                      jax_params[WHOLE, None],
                                      batches)
    for o in ranks:
        assert o[key]["tp"] == ("model",)
        np.testing.assert_allclose(np.array(o[key]["metrics"]),
                                   np.array(one_m), **TOL)
        for a, b in zip(o[key]["params"], one_p):
            np.testing.assert_allclose(a, b, **TOL)
        assert o[key]["metrics"] == ranks[0][key]["metrics"]


# ---------------------------------------------------------------------------
# FLOPs per rank on the meta device


def _flops(step, *args):
    from repro_torch.launch.hlo_analysis import OpCounter, analyze
    with OpCounter() as cnt:
        step(*args)
    return analyze(cnt)["flops"]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("model", [2, 4])
def test_rank_flops_are_one_tp_th_of_the_whole_step(name, model):
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import RecordingMesh
    cfg = _cfg(name)
    tc = T.TrainConfig(optimizer="sgdm", remat_policy="none")
    meta = torch.device("meta")

    def batch():
        return {"tokens": torch.empty((B, S), dtype=torch.int32, device=meta),
                "targets": torch.empty((B, S), dtype=torch.int32,
                                       device=meta),
                "weights": torch.empty((B, S), device=meta)}

    def state():
        st = T.abstract_state(cfg, tc, max_pos=64)
        st["step"] = torch.tensor(0, dtype=torch.int32)
        return st

    whole = _flops(T.make_train_step(cfg, tc), state(), batch())
    mesh = RecordingMesh((1, model), ("data", "model"))
    st = state()
    specs = T.tree_specs(st, T.state_rules(mesh.shape))
    step = T.make_train_step(cfg, tc, dp="data", tp="model",
                             param_specs=specs["params"], sizes=mesh.shape,
                             mesh=mesh)
    rank = _flops(step, shard_tree(st, specs, mesh), batch())
    # the tied unembedding's input gradient is whole on every rank where
    # the forward gathered the weight (tokens x vocab at least the whole
    # weight's vocab x d_model), as the reference's compiled step does
    gathered = B * S >= cfg.d_model
    extra = (2 * B * S * cfg.vocab_size * cfg.d_model * (1 - 1 / model)
             if cfg.tie_embeddings and gathered else 0)
    # wk / wv are whole leaves: a rank projects the KV heads its query
    # heads read, at least one (forward and two backward matmuls, K and V);
    # MLA has none, its every weight split over tp
    if cfg.attention != "mla":
        hd, rep = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        kv_heads = (cfg.n_heads // model - 1) // rep + 1
        n_attn = cfg.n_layers // cfg.period * cfg.layer_pattern.count("attn")
        kv = 3 * 2 * (2 * B * S * cfg.d_model * cfg.n_kv_heads * hd) \
            * n_attn
        extra += kv * (kv_heads / cfg.n_kv_heads - 1 / model)
    assert rank == whole / model + extra


def test_non_dense_rank_flops_stay_whole():
    """Reduced whisper-base, the family that computed whole on every rank
    before its encoder-decoder was split over tp, now computes
    tensor-parallel: its rank FLOPs at model 2 fall below model 1's (the
    name is kept from then)."""
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import RecordingMesh
    cfg = _cfg(WHOLE)
    tc = T.TrainConfig(optimizer="sgdm", remat_policy="none")
    meta = torch.device("meta")
    flops = []
    for model in (1, 2):
        mesh = RecordingMesh((1, model), ("data", "model"))
        st = T.abstract_state(cfg, tc, max_pos=64)
        st["step"] = torch.tensor(0, dtype=torch.int32)
        specs = T.tree_specs(st, T.state_rules(mesh.shape))
        step = T.make_train_step(cfg, tc, moe_groups=2, dp="data",
                                 tp="model", param_specs=specs["params"],
                                 sizes=mesh.shape, mesh=mesh)
        batch = {k: torch.empty((B, S), dtype=dt, device=meta)
                 for k, dt in (("tokens", torch.int32),
                               ("targets", torch.int32),
                               ("weights", torch.float32))}
        flops.append(_flops(step, shard_tree(st, specs, mesh), batch))
    assert 0 < flops[1] < flops[0]
