"""Port parity for tensor-parallel serving on 2 gloo ranks on the CPU
(mesh data = 1, model = 2): ``ServeEngine(mesh=...)`` streams and
``stats`` identical to JAX's replicated ``ServeEngine`` and to the
port's one-rank engine, for reduced qwen2-0.5b (GQA, 2 KV heads: one
per rank) at superstep k = 1 and 4 and with the prefix cache, for
reduced deepseek-v2 (MLA: the absorbed decode split over query heads),
where tp divides neither Hkv = 1 nor H = 3 (the fallback: whole pools,
the unsharded decode), and with ``rules=`` whose axis sizes are not the
mesh's (the mesh decides the split); each rank's pools hold its KV-head
block; ``tp_paged_decode``'s plain path bit-identical to the unsharded
one."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_ranks

CCFG = dict(num_slots=2, page_size=4, num_pages=24, max_pages_per_seq=8)
TIMEOUT = 180
# (name, arch, config overrides, engine kwargs)
CASES = [
    ("gqa_k1", "qwen2-0.5b", {}, dict(superstep_k=1)),
    ("gqa_k4", "qwen2-0.5b", {}, dict(superstep_k=4)),
    ("gqa_prefix", "qwen2-0.5b", {}, dict(superstep_k=4,
                                          prefix_cache="on")),
    ("mla_k4", "deepseek-v2-236b", {}, dict(superstep_k=4)),
    ("fallback", "qwen2-0.5b", dict(n_heads=3, n_kv_heads=1),
     dict(superstep_k=4)),
    # rules whose axis sizes are the defaults (16 x 16), not the mesh's:
    # the mesh's own tp extent decides the split
    ("gqa_rules", "qwen2-0.5b", {}, dict(superstep_k=4, rules=True)),
]


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _workload(seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 8).astype(np.int32)
    prompts = [rng.integers(0, 256, s).astype(np.int32) for s in (5, 9, 3)]
    prompts += [np.concatenate([shared, [7]]).astype(np.int32),
                np.concatenate([shared, [9, 4]]).astype(np.int32)]
    return prompts, [4, 7, 2, 5, 3]


def _serve(params, cfg, kw, mesh=None):
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.serve import PagedCacheConfig, ServeEngine
    kw = dict(kw)
    if kw.pop("rules", False) and mesh is not None:
        kw["rules"] = MeshRules(fsdp_axes=())
    eng = ServeEngine(params, cfg, PagedCacheConfig(**CCFG), device="cpu",
                      mesh=mesh, **kw)
    prompts, budgets = _workload()
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    out = eng.run()
    return ({r: np.asarray(out[r]) for r in rids}, dict(eng.stats),
            [tuple(l.shape) for l in _pool_leaves(eng)])


def _pool_leaves(eng):
    return [leaf for blk in eng.kv.cache for leaf in blk["mixer"].values()]


def _rank(rank, world, np_params):
    from repro_torch.dist.sharding import kv_head_block
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import tp_paged_decode
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import params_from_jax
    mesh = make_test_mesh(data=1, model=2, device="cpu")
    out = {}
    for name, arch, over, kw in CASES:
        out[name] = _serve(params_from_jax(np_params[name]),
                           _cfg(arch, over), kw, mesh=mesh)
    # the decode alone: this rank's KV-head block of random pools
    rng = np.random.default_rng(5)
    b, h, hkv, d, n, ps, pmax = 3, 8, 4, 16, 12, 4, 3
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(n, ps, hkv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n, ps, hkv, d)).astype(np.float32))
    tbl = torch.from_numpy(rng.integers(-1, n, size=(b, pmax)).astype(
        np.int32))
    lens = torch.tensor([0, 5, 12], dtype=torch.int32)
    whole = ops.paged_decode_attention(q, kp, vp, tbl, lens)
    blk = kv_head_block(mesh, ("model",), hkv, h)
    split = tp_paged_decode(q, kp[:, :, blk[0]:blk[1]].contiguous(),
                            vp[:, :, blk[0]:blk[1]].contiguous(), tbl, lens,
                            mesh=mesh, kv_block=blk, n_kv_heads=hkv)
    # tp = 2 divides neither Hkv = 3 nor H = 6: whole pools, no collective
    fb_block = kv_head_block(mesh, ("model",), 3, 6)
    fallback = tp_paged_decode(q[:, :6], kp[:, :, :3].contiguous(),
                               vp[:, :, :3].contiguous(), tbl, lens,
                               mesh=mesh, kv_block=fb_block, n_kv_heads=3)
    out["decode"] = (whole.numpy(), split.numpy(), fallback.numpy(),
                     ops.paged_decode_attention(
                         q[:, :6], kp[:, :, :3], vp[:, :, :3], tbl,
                         lens).numpy(), (blk, fb_block))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models.model import init_model as jax_init
    np_params = {}
    for name, arch, over, _ in CASES:
        jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
        np_params[name] = jax.tree.map(
            np.asarray, jax_init(jax.random.PRNGKey(0), jcfg, max_pos=64))
    res = run_ranks(_rank, 2, backend="gloo", device="cpu", timeout=TIMEOUT,
                    threads=1, args=(np_params,),
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return np_params, res


def _jax_serve(np_params, arch, over, kw):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.serve import kv_cache as jkv
    from repro.serve.engine import ServeEngine as JaxEngine
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    kw = {k: v for k, v in kw.items() if k != "rules"}
    eng = JaxEngine(jp, jcfg, jkv.PagedCacheConfig(**CCFG), **kw)
    prompts, budgets = _workload()
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    out = eng.run()
    return {r: np.asarray(out[r]) for r in rids}, dict(eng.stats)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_tp_streams_and_stats_match_jax_and_one_rank(spawned, case):
    from repro_torch.models.model import params_from_jax
    np_params, res = spawned
    name, arch, over, kw = CASES[case]
    want, want_stats = _jax_serve(np_params[name], arch, over, kw)
    one, one_stats, _ = _serve(params_from_jax(np_params[name]),
                               _cfg(arch, over), kw)
    assert one_stats == want_stats
    for rid in want:
        np.testing.assert_array_equal(one[rid], want[rid])
    for rank_out in res:
        streams, stats, _ = rank_out[name]
        assert stats == want_stats
        assert sorted(streams) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(streams[rid], want[rid])


def test_tp_pools_hold_the_rank_block(spawned):
    _, res = spawned
    cfg = get_config("qwen2-0.5b").reduced()
    for rank_out in res:
        for name in ("gqa_k4", "gqa_rules"):
            _, _, shapes = rank_out[name]
            assert all(s[-2] == cfg.n_kv_heads // 2 for s in shapes)
        _, _, shapes = rank_out["fallback"]
        assert all(s[-2] == 1 for s in shapes)             # whole pools
        _, _, shapes = rank_out["mla_k4"]                  # latents whole
        m = get_config("deepseek-v2-236b").reduced().mla
        assert sorted({s[-1] for s in shapes}) == sorted(
            {m.kv_lora_rank, m.qk_rope_head_dim})


def test_tp_paged_decode_plain_bit_identical(spawned):
    _, res = spawned
    for rank, rank_out in enumerate(res):
        whole, split, fallback, fb_whole, blocks = rank_out["decode"]
        assert blocks == ((2 * rank, 2 * rank + 2), None)
        np.testing.assert_array_equal(split.view(np.uint32),
                                      whole.view(np.uint32))
        np.testing.assert_array_equal(fallback, fb_whole)


def test_engine_mesh_refusals():
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import init_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=64)
    with pytest.raises(ValueError, match="without mesh"):
        ServeEngine(params, cfg, device="cpu", rules=MeshRules())
    one = Mesh((1, 1), ("data", "model"), device="cpu")
    eng = ServeEngine(params, cfg, device="cpu", mesh=one)
    assert eng.kv.kv_block is None and eng.rules.tp_axes == ("model",)
