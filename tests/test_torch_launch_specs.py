"""Port parity for ``repro_torch.launch.specs``, ``launch.train.
abstract_state`` and the per-rank memory report against live ``repro``:
every spec function's shapes and dtypes (meta tensors) equal the
reference's ``ShapeDtypeStruct``s for all ten configs and every ``SHAPES``
entry; ``abstract_state`` equals ``jax.eval_shape`` of the reference's for
every mode; ``state_bytes_per_rank`` equals the bytes summed from the
reference's own ``tree_specs`` of its abstract state, for qwen2-0.5b and
arctic-480b on the 16 x 16 and 2 x 16 x 16 meshes. Nothing is allocated:
every tensor here is on the meta device."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import list_configs
from repro.dist import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain

CONFIGS = sorted(n for n in list_configs() if n != "paper-lenet")
MODES = ["masked", "sync", "cge", "stale", "trimmed", "quantized"]
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _struct(tree):
    """[(path, shape, dtype name)] of a tree of meta tensors or of
    ShapeDtypeStructs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    out = []
    for path, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type in ("meta", "cpu")
            dt = str(leaf.dtype).replace("torch.", "")
        else:
            dt = str(leaf.dtype)
        out.append((jax.tree_util.keystr(path), tuple(leaf.shape), dt))
    return out


def test_configs_and_shapes_are_the_references():
    assert len(CONFIGS) == 10
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in JSHAPES]


@pytest.mark.parametrize("name", CONFIGS)
def test_input_and_state_specs_match_reference(name):
    cfg, jcfg = get_config(name), jax_config(name)
    for shape, jshape in zip(SHAPES, JSHAPES):
        assert tspecs.max_pos_for(shape) == jspecs.max_pos_for(jshape)
        for kind in ("train", "prefill", "decode", None):
            ours = tspecs.input_specs(cfg, shape, 8, kind)
            ref = jspecs.input_specs(jcfg, jshape, 8, kind)
            assert _struct(ours) == _struct(ref), (shape.name, kind)
    shape, jshape = SHAPES[0], JSHAPES[0]
    for opt in ("adamw", "sgdm", "none"):
        assert _struct(tspecs.state_specs(cfg, shape, opt)) == \
            _struct(jspecs.state_specs(jcfg, jshape, opt)), opt
    with pytest.raises(ValueError):
        tspecs.input_specs(cfg, shape, 8, "serve")


@pytest.mark.parametrize("mode", MODES)
def test_abstract_state_matches_eval_shape(mode):
    for name in ("qwen2-0.5b", "jamba-v0.1-52b"):
        tc = ttrain.TrainConfig(mode=mode)
        jtc = jtrain.TrainConfig(mode=mode)
        ours = ttrain.abstract_state(get_config(name), tc, max_pos=4097,
                                     n_agents=4)
        ref = jtrain.abstract_state(jax_config(name), jtc, max_pos=4097,
                                    n_agents=4)
        assert _struct(ours) == _struct(ref), name
        for leaf in jax.tree.leaves(
                ours, is_leaf=lambda t: isinstance(t, torch.Tensor)):
            assert leaf.device.type == "meta" or leaf.dim() == 0


def _reference_bytes(name, sizes, optimizer):
    jtc = jtrain.TrainConfig(optimizer=optimizer)
    state = jtrain.abstract_state(jax_config(name), jtc)
    specs = jsharding.tree_specs(
        state, jsharding.MeshRules(axis_sizes=dict(sizes)))
    out = {}
    for key in ("params", "opt"):
        total = 0
        for leaf, spec in zip(
                jax.tree.leaves(state[key]),
                jax.tree.leaves(specs[key], is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
            n = math.prod(leaf.shape)
            for e in tuple(spec):
                axes = () if e is None else ((e,) if isinstance(e, str)
                                             else tuple(e))
                n //= math.prod(sizes.get(a, 1) for a in axes)
            total += n * np.dtype(leaf.dtype).itemsize
        out[key] = total
    return out


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
@pytest.mark.parametrize("sizes", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "arctic-480b"])
def test_state_bytes_per_rank_match_reference_specs(name, sizes, optimizer):
    ours = ttrain.state_bytes_per_rank(
        get_config(name), ttrain.TrainConfig(optimizer=optimizer), sizes)
    ref = _reference_bytes(name, sizes, optimizer)
    assert ours["params"] == ref["params"]
    assert ours["opt"] == ref["opt"]
    assert ours["total"] == ref["params"] + ref["opt"]
    assert ours["total"] < ours["whole"]


def test_state_bytes_per_rank_qwen2_data4():
    """494,032,768 bf16 parameters and f32 AdamW moments (4.94 GB whole)
    on data = 4: a quarter a rank, plus the norms and biases every rank
    keeps whole."""
    cfg = get_config("qwen2-0.5b")
    rep = ttrain.state_bytes_per_rank(cfg, ttrain.TrainConfig(),
                                      {"data": 4, "model": 1})
    n = 494_032_768
    assert rep["whole"] == n * (2 + 8)
    assert rep["whole"] / 4 <= rep["total"] < rep["whole"] / 4 * 1.01
