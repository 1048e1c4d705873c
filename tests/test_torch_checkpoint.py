"""Port parity for ``repro_torch.checkpoint``: the checkpointer's round
trip, atomic ``.tmp`` rename, ``keep`` and async ``wait``; checkpoints
written by ``repro.checkpoint`` restore through the port and the port's
through the reference, with the same flat keys and arrays (bf16 tensors
are widened to f32 exactly, as ``ServeEngine.snapshot()`` widens them);
and the ``elastic`` functions equal the reference's on seeded inputs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.checkpoint import elastic as jel
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.checkpoint import elastic as tel


def _numpy_state(seed=0):
    """A train-state-like tree: nested dicts (unsorted keys), a tuple of
    blocks, a list, mixed dtypes, a scalar and a ``None`` subtree. 32-bit
    leaves only: JAX without x64 narrows 64-bit ones."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                   "blocks": ({"a": np.ones((2, 3), np.float32)},
                              {"a": rng.standard_normal((2, 3)).astype(
                                  np.float32)})},
        "opt": {"m": {"w": np.zeros((4, 8), np.float32)},
                "count": np.int32(3)},
        "ledger_ts": np.arange(5, dtype=np.int32),
        "lists": [np.arange(3, dtype=np.int32), np.float32(2.5)],
        "skip": None,
        "step": np.int32(7),
    }


def _torch_state(tree):
    if isinstance(tree, dict):
        return {k: _torch_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch_state(v) for v in tree)
    if isinstance(tree, list):
        return [_torch_state(v) for v in tree]
    return None if tree is None else torch.as_tensor(np.asarray(tree))


def _jax_state(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_flat_keys_equal_reference():
    st = _numpy_state()
    ours = tck._flatten(_torch_state(st))
    _assert_flat_equal(ours, tck._flatten(st))
    _assert_flat_equal(ours, jck._flatten(_jax_state(st)))
    assert "params/blocks/1/a" in ours and "lists/1" in ours
    assert not any(k.startswith("skip") for k in ours)


def test_bf16_tensors_widen_exactly():
    x = torch.randn(3, 5).bfloat16()
    flat = tck._flatten({"x": x})
    assert flat["x"].dtype == np.float32
    np.testing.assert_array_equal(flat["x"], x.float().numpy())


def test_roundtrip_into_tensor_and_array_templates(tmp_path):
    st = _numpy_state(1)
    ck = Checkpointer(str(tmp_path))
    ck.save(_torch_state(st), 7, blocking=True)
    restored, step = ck.restore(_torch_state(_numpy_state(2)))
    assert step == 7
    assert isinstance(restored["params"]["blocks"], tuple)
    assert isinstance(restored["lists"], list)
    assert restored["params"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  st["params"]["w"])
    assert int(restored["step"]) == 7
    back, _ = ck.restore(_numpy_state(2))           # numpy templates
    _assert_flat_equal(tck._flatten(back), tck._flatten(st))
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"nope": np.zeros(2)})


def test_atomic_tmp_rename_and_manifest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_torch_state(_numpy_state()), 5, blocking=True,
            meta={"run": "a"})
    os.makedirs(tmp_path / ".tmp_step_9_999")
    with open(tmp_path / ".tmp_step_9_999" / "arrays.npz", "w") as f:
        f.write("garbage")
    assert ck.latest_step() == 5                    # the partial is unseen
    man = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert man["step"] == 5 and man["meta"] == {"run": "a"}
    assert man["keys"] == sorted(tck._flatten(_numpy_state()))
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith(".tmp_step_5")]


def test_keep_and_async_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(_torch_state(_numpy_state(s)), s, blocking=False)
    ck.wait()
    assert ck._steps() == [3, 4] and ck.latest_step() == 4
    flat, step = ck.restore_flat()
    assert step == 4
    _assert_flat_equal(flat, tck._flatten(_numpy_state(4)))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({})


def test_checkpoints_cross_between_packages(tmp_path):
    st = _numpy_state(3)
    jck.Checkpointer(str(tmp_path / "ref")).save(_jax_state(st), 2,
                                                 blocking=True)
    Checkpointer(str(tmp_path / "port")).save(_torch_state(st), 2,
                                              blocking=True)
    ref_by_port, s1 = Checkpointer(str(tmp_path / "ref")).restore_flat()
    port_by_ref, s2 = jck.Checkpointer(str(tmp_path / "port")).restore_flat()
    assert s1 == s2 == 2
    _assert_flat_equal(ref_by_port, port_by_ref)
    # templated restores through the other package, same leaves
    tree, _ = Checkpointer(str(tmp_path / "ref")).restore(_torch_state(st))
    _assert_flat_equal(tck._flatten(tree), tck._flatten(st))
    tree, _ = jck.Checkpointer(str(tmp_path / "port")).restore(
        jax.tree.map(np.asarray, _jax_state(st)))
    _assert_flat_equal(jck._flatten(tree), jck._flatten(_jax_state(st)))


# ---------------------------------------------------------------------------
# elastic: numpy, identical on the same inputs


@pytest.mark.parametrize("seed", range(3))
def test_elastic_functions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    flat = {
        "params/w": rng.standard_normal((4, 8)),
        "ledger/g/w": rng.standard_normal((n, 3)).astype(np.float32),
        "ledger/x": rng.standard_normal((n, 2)),
        "ledger_ts": rng.integers(0, 9, n),
        "train/ledger_ts": rng.integers(0, 9, n).astype(np.int32),
        "err/w": rng.standard_normal((n, 2, 2)),
        "agent_state": rng.integers(0, 4, n).astype(np.int8),
    }
    for new_n in (1, n, n + 3):
        _assert_flat_equal(tel.reshard_agent_state(flat, new_n),
                           jel.reshard_agent_state(flat, new_n))
        for fill in ("zero", "mean"):
            a = tel.resize_agent_axis(flat["ledger/g/w"], new_n, fill)
            b = jel.resize_agent_axis(flat["ledger/g/w"], new_n, fill)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    batch = rng.standard_normal((5, 3))
    for b in (2, 5, 7, 12):
        np.testing.assert_array_equal(tel.rebatch_global(batch, b),
                                      jel.rebatch_global(batch, b))
    grown = tel.reshard_agent_state(flat, n + 2)
    assert list(grown["ledger_ts"][n:]) == [-1, -1]     # joiners excluded
