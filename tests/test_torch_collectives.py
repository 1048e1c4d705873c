"""Port parity for ``repro_torch.dist.collectives`` and the registry's
``collective``/``spmd`` columns on 4 gloo ranks on the CPU, meshes
(data = 4) and (pod = 2, data = 2): every rule's SPMD wrapper with
|S^t| = n - r received agents against live ``repro.core.gradagg`` on the
stacked inputs (the reference's registry suite holds its collectives to
the same), within 1e-5; the CGE keep-set; the quantized collective's
error feedback; the axis bookkeeping; and ``ledger_all_rows`` bit-exact,
a ``-0.0`` element included.

The ranks are spawned once per mesh shape (``launch.mesh.run_ranks``,
a ``FileStore`` under the test's temporary directory and a time limit);
the rank side imports no JAX, the comparisons run in the test process.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ATOL = 1e-5
RULES = ("sum", "mean", "cge", "trimmed_mean", "quantized")
SHAPES = {"data4": dict(data=4, model=1), "pod2xdata2": dict(pod=2, data=2,
                                                              model=1)}
TIMEOUT = 120


def _cases(n=4, d=37):
    rng = np.random.default_rng(0)
    out = []
    for rule in RULES:
        for r in (0, 1):
            g = (rng.normal(size=(n, d))
                 * rng.uniform(0.5, 3.0, size=(n, 1))).astype(np.float32)
            mask = np.zeros(n, np.float32)
            mask[rng.choice(n, size=n - r, replace=False)] = 1.0
            out.append((rule, r, g, mask))
    return out


def _tree_of(row):
    """An agent's flat row as a two-leaf tree (a layout of two leaves)."""
    return {"w": torch.from_numpy(row[:30].reshape(5, 6).copy()),
            "b": torch.from_numpy(row[30:].copy())}


def _flat(tree):
    return np.concatenate([tree["b"].numpy().ravel(),
                           tree["w"].numpy().ravel()])


def _rank(rank, world, shape, cases):
    from repro_torch.dist import collectives as C
    from repro_torch.dist.registry import get_rule
    from repro_torch.launch.mesh import dp_axis_names, make_test_mesh
    mesh = make_test_mesh(**shape, device="cpu")
    dp = dp_axis_names(mesh)
    me = C.agent_index(dp, mesh=mesh)
    n = C.axis_count(dp, mesh=mesh)
    out = {"me": me, "n": n, "coords": mesh.coords(),
           "rows": C.shard_row_slice(dp, 8, mesh=mesh)}
    for i, (rule, r, g, mask) in enumerate(cases):
        f = 1 if get_rule(rule).needs_f else 0
        res = get_rule(rule).spmd(_tree_of(g[me]), torch.tensor(mask[me]),
                                  f, dp, mesh=mesh)
        out[i] = _flat(res)
    # CGE's keep-set and the quantized error feedback
    rule, r, g, mask = cases[5]
    _, keep = C.cge_psum(_tree_of(g[me]), torch.tensor(mask[me] > 0), 1, dp,
                         mesh=mesh)
    out["keep"] = keep.numpy()
    err = _tree_of(np.full(37, 0.01 * (me + 1), np.float32))
    agg, new_err = C.quantized_psum(_tree_of(g[me]), torch.tensor(mask[me]),
                                    err, dp, mesh=mesh)
    out["q_agg"], out["q_err"] = _flat(agg), _flat(new_err)
    # the bit-exact rebuild: -0.0, +0.0 and a NaN survive
    x = np.arange(2 * 3, dtype=np.float32).reshape(2, 3) + 10 * me
    x[0, 0], x[1, 1], x[1, 2] = -0.0, 0.0, np.nan if me == 1 else x[1, 2]
    out["local_rows"] = x
    out["all_rows"] = C.ledger_all_rows(torch.from_numpy(x), dp, 2 * n,
                                        mesh=mesh).numpy()
    out["per_agent"] = C._per_agent(torch.tensor(float(me) * 1.5), dp,
                                    mesh=mesh).numpy()
    return out


@pytest.fixture(scope="module", params=list(SHAPES))
def spawned(request, tmp_path_factory):
    cases = _cases()
    res = run_ranks(_rank, 4, backend="gloo", device="cpu", timeout=TIMEOUT,
                    threads=1, args=(SHAPES[request.param], cases),
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return request.param, cases, res


def _reference(rule, g, mask, f):
    import jax.numpy as jnp
    from repro.dist.registry import get_rule as jrule
    ref = jrule(rule).bind_reference(f)
    out = np.asarray(ref(jnp.asarray(g), jnp.asarray(mask > 0)))
    # the flat order of the two-leaf tree: "b" (sorted first), then "w"
    return np.concatenate([out[30:], out[:30]])


@pytest.mark.parametrize("idx", range(2 * len(RULES)))
def test_spmd_rule_matches_live_gradagg(spawned, idx):
    _, cases, res = spawned
    rule, r, g, mask = cases[idx]
    f = 1 if rule in ("cge", "trimmed_mean") else 0
    want = _reference(rule, g, mask, f)
    for rank_out in res:
        got = rank_out[idx]
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
        # every rank holds the same aggregate, bit for bit
        np.testing.assert_array_equal(got, res[0][idx])


def test_axis_bookkeeping(spawned):
    name, _, res = spawned
    assert sorted(o["me"] for o in res) == [0, 1, 2, 3]
    assert all(o["n"] == 4 for o in res)
    for rank, o in enumerate(res):          # row-major over the axes
        assert o["me"] == rank
        assert o["rows"] == (2 * rank, 2)
        if name == "pod2xdata2":
            assert o["coords"] == {"pod": rank // 2, "data": rank % 2,
                                   "model": 0}


def test_cge_keep_set_matches_reference(spawned):
    import jax.numpy as jnp
    from repro.core import gradagg as jg
    _, cases, res = spawned
    _, _, g, mask = cases[5]
    want = np.asarray(jg.cge_mask(jnp.asarray(g), jnp.asarray(mask > 0), 1))
    for o in res:
        np.testing.assert_array_equal(o["keep"], want)


def test_quantized_error_feedback(spawned):
    """New residual = x - deq(x) where the agent sent, the whole x where
    it was masked out; the aggregate sums the sent dequantized rows."""
    _, cases, res = spawned
    _, _, g, mask = cases[5]
    agg = np.zeros(37, np.float32)
    for me, o in enumerate(res):
        x = np.concatenate([g[me][30:], g[me][:30]]) + np.float32(
            0.01 * (me + 1))
        scale = np.maximum(np.abs(x).max() / np.float32(127.0),
                           np.float32(1e-30))
        deq = np.clip(np.round(x / scale), -127, 127) * scale
        want_err = x - deq if mask[me] > 0 else x
        np.testing.assert_allclose(o["q_err"], want_err, rtol=1e-6,
                                   atol=1e-7)
        agg += deq * mask[me]
    for o in res:
        np.testing.assert_allclose(o["q_agg"], agg, rtol=ATOL, atol=ATOL)


def test_ledger_all_rows_is_bit_exact(spawned):
    _, _, res = spawned
    want = np.concatenate([o["local_rows"] for o in res])
    for o in res:
        assert o["all_rows"].shape == (8, 3)
        np.testing.assert_array_equal(o["all_rows"].view(np.uint32),
                                      want.view(np.uint32))
    assert np.signbit(res[0]["all_rows"][0, 0])       # -0.0 kept
    assert not np.signbit(res[0]["all_rows"][1, 1])   # +0.0 kept
    for o in res:
        np.testing.assert_array_equal(o["per_agent"],
                                      np.arange(4, dtype=np.float32) * 1.5)


# ---------------------------------------------------------------------------
# the rank runner itself


def _returns_tensor(rank, world):
    return torch.arange(4) * (rank + 1)


def _raises_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()            # rank 0 waits in a collective
    return rank


def _sleeps(rank, world):
    import time
    time.sleep(60)


def test_run_ranks_returns_tensors_by_value(tmp_path):
    out = run_ranks(_returns_tensor, 2, backend="gloo", device="cpu",
                    timeout=TIMEOUT, threads=1, store_dir=str(tmp_path))
    assert [t.tolist() for t in out] == [[0, 1, 2, 3], [0, 2, 4, 6]]


def test_run_ranks_raises_on_a_failed_or_late_rank(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one"):
        run_ranks(_raises_on_rank_1, 2, backend="gloo", device="cpu",
                  timeout=TIMEOUT, threads=1, store_dir=str(tmp_path))
    with pytest.raises(TimeoutError, match="2 of 2 ranks"):
        run_ranks(_sleeps, 2, backend="gloo", device="cpu", timeout=8,
                  threads=1, store_dir=str(tmp_path))
