"""Port parity for ``repro_torch.dist.sharding``: ``tree_specs`` of the
whole train state (parameters, AdamW moments, step; the stale ledger and
quantized residuals), ``batch_specs`` and ``cache_specs`` (dense caches
and paged pools) equal the reference's ``PartitionSpec``s, as tuples,
for every config of the registry under the storage, compute, multi-pod
and small-mesh rules; the kv-head predicate of the page pools; the
``serve_tp`` context (as ``tests/test_sharding_rules.py``)."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as jax_config
from repro.dist import sharding as jsh
from repro.launch.train import TrainConfig as JTC
from repro.launch.train import abstract_state
from repro.models.model import init_cache as jax_init_cache
from repro.serve.kv_cache import PagedCacheConfig as JCC
from repro.serve.kv_cache import PagedKVCache as JKV
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.dist import sharding as tsh
from repro_torch.launch.train import TrainConfig, init_state
from repro_torch.models.model import init_cache
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache

SIZES = {"data": 16, "model": 16}
RULES = {
    "storage": dict(axis_sizes=SIZES),
    "compute": dict(fsdp_axes=(), axis_sizes=SIZES),
    "multipod": dict(multi_pod=True, fsdp_axes=("data", "pod")),
    "small": dict(axis_sizes={"data": 4, "model": 2}),
}


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _tspecs(specs, like):
    """The spec of every leaf of ``like``, in the reference's leaf order
    (a spec is itself a tuple, so the walk follows ``like``)."""
    out = []
    for names, _ in tsh._leaves_with_path(like):
        node = specs
        for k in names:
            node = node[k] if isinstance(node, dict) else node[int(k)]
        out.append(node)
    return out


@pytest.fixture(scope="module", params=list_configs())
def states(request):
    name = request.param
    out = {}
    for mode in ("masked", "stale", "quantized"):
        js = abstract_state(jax_config(name), JTC(mode=mode), max_pos=4096,
                            n_agents=2)
        ts = init_state(None, get_config(name), TrainConfig(mode=mode),
                        max_pos=4096, n_agents=2, device="meta")
        out[mode] = (js, ts)
    return name, out


@pytest.mark.parametrize("rules", list(RULES))
def test_tree_specs_match_reference(states, rules):
    _, by_mode = states
    for js, ts in by_mode.values():
        want = _jspecs(jsh.tree_specs(js, jsh.MeshRules(**RULES[rules])))
        got = _tspecs(tsh.tree_specs(ts, tsh.MeshRules(**RULES[rules])), ts)
        assert got == want


def test_tree_specs_overrides(states):
    _, by_mode = states
    js, ts = by_mode["masked"]
    ov = {"params/embed/*": ("model", None)}
    want = _jspecs(jsh.tree_specs(js, jsh.MeshRules(
        axis_sizes=SIZES, overrides={k: P(*v) for k, v in ov.items()})))
    got = _tspecs(tsh.tree_specs(ts, tsh.MeshRules(axis_sizes=SIZES,
                                                   overrides=ov)), ts)
    assert got == want


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("batch", [1, 8, 64, 96])
def test_batch_specs_match_reference(rules, batch):
    jb = {"tokens": jax.ShapeDtypeStruct((batch, 128), jnp.int32),
          "weights": jax.ShapeDtypeStruct((batch, 128), jnp.float32),
          "scalar": jax.ShapeDtypeStruct((), jnp.float32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    want = _jspecs(jsh.batch_specs(jsh.MeshRules(**RULES[rules]), jb))
    got = _tspecs(tsh.batch_specs(tsh.MeshRules(**RULES[rules]), tb), tb)
    assert got == want


@pytest.mark.parametrize("name", list_configs())
@pytest.mark.parametrize("rules", ["storage", "small"])
def test_dense_cache_specs_match_reference(name, rules):
    jcfg, cfg = jax_config(name), get_config(name)
    jc = jax_init_cache(jcfg, 32, 256, abstract=True)
    tc = init_cache(cfg, 32, 256, device="meta")
    want = _jspecs(jsh.cache_specs(jsh.MeshRules(**RULES[rules]), jc))
    got = _tspecs(tsh.cache_specs(tsh.MeshRules(**RULES[rules]), tc), tc)
    assert got == want


@pytest.mark.parametrize("name", ["qwen2-0.5b", "yi-6b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "rwkv6-3b"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_paged_pool_specs_match_reference(name, tp):
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jkv = JKV(jcfg, JCC(page_size=4, num_pages=8, max_pages_per_seq=4,
                        num_slots=2))
    tkv = PagedKVCache(cfg, PagedCacheConfig(page_size=4, num_pages=8,
                                             max_pages_per_seq=4,
                                             num_slots=2), device="cpu")
    sizes = {"data": 1, "model": tp}
    for h in (None, cfg.n_heads, 6):
        want = _jspecs(jsh.cache_specs(
            jsh.MeshRules(fsdp_axes=(), axis_sizes=sizes), jkv.cache, h))
        got = _tspecs(tsh.cache_specs(
            tsh.MeshRules(fsdp_axes=(), axis_sizes=sizes), tkv.cache, h),
            tkv.cache)
        assert got == want


def test_pages_predicate_matches_kernel_dispatch():
    pools = torch.empty((2, 16, 8, 4, 64), device="meta")
    cache = ({"mixer": {"k_pages": pools, "v_pages": pools}, "ffn": {}},)
    rules = tsh.MeshRules(fsdp_axes=(), axis_sizes={"model": 4})
    kp = tsh.cache_specs(rules, cache, n_query_heads=8)[0]["mixer"]["k_pages"]
    assert kp == (None, None, None, "model", None)
    kp = tsh.cache_specs(rules, cache, n_query_heads=6)[0]["mixer"]["k_pages"]
    assert kp == (None,) * 5
    assert tsh.kv_head_split(rules.size(rules.tp_axes), 4, 8) == 4
    assert tsh.kv_head_split(rules.size(rules.tp_axes), 4, 6) == 1
    rules = tsh.MeshRules(fsdp_axes=(), tp_axes=("model", "pod"),
                          axis_sizes={"model": 2, "pod": 2})
    kp = tsh.cache_specs(rules, cache, n_query_heads=6)[0]["mixer"]["k_pages"]
    assert kp == (None,) * 5


@pytest.mark.parametrize("axes,dim", [(("model", "data"), 896),
                                      (("model", "data"), 4096),
                                      (("data",), 3), (("model",), 0)])
def test_fit_matches_reference(axes, dim):
    assert (tsh.MeshRules(axis_sizes=SIZES).fit(axes, dim)
            == jsh.MeshRules(axis_sizes=SIZES).fit(axes, dim))


def test_serve_tp_context_nests():
    assert tsh.current_serve_tp() is None
    with tsh.serve_tp("m1", ("model",)):
        with tsh.serve_tp("m2", ("model", "pod"), (2, 4)):
            assert tsh.current_serve_tp() == ("m2", ("model", "pod"), (2, 4))
        assert tsh.current_serve_tp() == ("m1", ("model",), None)
    assert tsh.current_serve_tp() is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_a_shape_without_its_world(multi_pod):
    """(16, 16) / (2, 16, 16), the reference's axes; with no process
    group of that size it makes no groups and its collectives refuse."""
    from repro_torch.launch.mesh import (dp_axis_names, make_production_mesh,
                                         n_agents_of)
    m = make_production_mesh(multi_pod=multi_pod, device="cpu")
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert m.shape == want and m.axis_names == tuple(want)
    assert dp_axis_names(m) == (("pod", "data") if multi_pod else ("data",))
    assert n_agents_of(m) == (32 if multi_pod else 16)
    assert not m.has_groups and m.axis_index(("data",)) == 0
    with pytest.raises(RuntimeError, match="without process groups"):
        m.all_reduce(torch.zeros(2), ("data",))
