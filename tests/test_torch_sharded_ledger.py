"""Port parity for the dp-sharded, double-buffered ``ShardedGradLedger``
and ``make_sharded_aggregate_apply`` on 4 gloo ranks on the CPU, meshes
(data = 4) and (pod = 2, data = 2): the invariants of the reference's
``sharded-ledger`` suite (``tests/helpers/parity_checks.py``), which the
reference cannot run live under jax 0.9.0.

- the host image is exact mid-swap, every round;
- ``combine="gather"`` is bit-identical to the port's single-buffer
  device step (``GradLedger`` + ``make_aggregate_apply``) and within
  1e-5 * max(|x|, 1) of live JAX's ``make_aggregate_apply``;
  ``combine="partial"`` is held to the same tolerance;
- an ``AsyncEngine`` run of 30 iterations with ``agg_backend="sharded"``
  is bit-identical to ``"device"`` (cge, f = 1, redundant quadratics);
- the two buffers have distinct storage after ``__init__`` and ``load``,
  a snapshot restores mid-swap exactly and survives a swap.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ATOL = 1e-5
N, D, ITERS = 8, 1000, 4
RULES = ("cge", "mean", "quantized", "sum", "trimmed_mean")
SHAPES = {"data4": dict(data=4, model=1), "pod2xdata2": dict(pod=2, data=2,
                                                              model=1)}
TIMEOUT = 150


def _schedule(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in RULES:
        its = []
        for _ in range(ITERS):
            ups = rng.choice(N, size=rng.integers(1, N + 1), replace=False)
            rows = rng.normal(size=(ups.size, D)).astype(np.float32)
            recv = np.zeros(N, bool)
            recv[rng.choice(N, size=6, replace=False)] = True
            its.append((ups, rows, recv))
        out.append(its)
    return out


def _rank(rank, world, shape, schedule):
    from repro_torch.core.async_engine import AsyncEngine, EngineConfig
    from repro_torch.core.ledger import (GradLedger, ShardedGradLedger,
                                         make_aggregate_apply,
                                         make_sharded_aggregate_apply)
    from repro_torch.core.redundancy import make_redundant_quadratics
    from repro_torch.dist.registry import get_rule
    from repro_torch.launch.mesh import dp_axis_names, make_test_mesh
    mesh = make_test_mesh(**shape, device="cpu")
    axes = dp_axis_names(mesh)
    out = {"x": {}, "host_exact": []}
    for rule, its in zip(RULES, schedule):
        f = 1 if get_rule(rule).needs_f else 0
        ref = GradLedger(N, D, "cpu")
        step_r = make_aggregate_apply(rule, f, 1e6)
        x_r = torch.zeros(D)
        combines = ("gather", "partial")
        leds = {c: ShardedGradLedger(N, D, "cpu", mesh=mesh, axes=axes)
                for c in combines}
        steps = {c: make_sharded_aggregate_apply(rule, f, 1e6, mesh, axes, N,
                                                 c) for c in combines}
        xs = {c: torch.zeros(D) for c in combines}
        for ups, rows, recv in its:
            ref.upload(ups, rows)
            for c in combines:
                leds[c].upload(ups, rows)
            x_r = step_r(x_r, ref.front_for_aggregate(),
                         torch.from_numpy(recv), 0.01)
            for c in combines:
                xs[c] = steps[c](xs[c], leds[c].front_for_aggregate(),
                                 torch.from_numpy(recv), 0.01)
            out["host_exact"].append(
                np.array_equal(leds["gather"].host(), ref.host()))
        out["x"][rule] = {"device": x_r.numpy(), "gather": xs["gather"].numpy(),
                          "partial": xs["partial"].numpy()}

    costs = make_redundant_quadratics(N, 12, spread=0.02, cond=1.5, seed=0)
    eng_x = {}
    for backend in ("device", "sharded"):
        eng = AsyncEngine(
            lambda j, x, r: costs.grad(j, x), np.zeros(12),
            EngineConfig(n_agents=N, r=2, rule="cge", f=1,
                         step_size=lambda t: 0.02, proj_gamma=30.0, seed=1,
                         agg_backend=backend, device="cpu"),
            loss_fn=costs.loss,
            mesh=mesh if backend == "sharded" else None)
        eng.run(30)
        eng_x[backend] = eng.x.copy()
    out["engine"] = eng_x

    rng = np.random.default_rng(7)

    def distinct(led):
        return (led._bufs[0].data_ptr() != led._bufs[1].data_ptr()
                and led._bufs[0].untyped_storage().data_ptr()
                != led._bufs[1].untyped_storage().data_ptr())

    led = ShardedGradLedger(N, D, "cpu", mesh=mesh, axes=axes)
    out["init_distinct"] = distinct(led)
    led.upload([0, 3], rng.normal(size=(2, D)).astype(np.float32))
    led.front_for_aggregate()                        # swap once
    led.upload([5], rng.normal(size=(1, D)).astype(np.float32))
    snap = led.host()
    led2 = ShardedGradLedger(N, D, "cpu", mesh=mesh, axes=axes)
    led2.load(snap)
    out["load_distinct"] = distinct(led2)
    out["restore_exact"] = np.array_equal(led2.host(), snap)
    led2.front_for_aggregate()
    out["swap_keeps"] = np.array_equal(led2.host(), snap)
    out["swaps"] = led2.swaps
    out["block"] = (led2.row0, led2.n_loc, tuple(led2.data.shape))
    return out


@pytest.fixture(scope="module", params=list(SHAPES))
def spawned(request, tmp_path_factory):
    schedule = _schedule()
    res = run_ranks(_rank, 4, backend="gloo", device="cpu", timeout=TIMEOUT,
                    threads=1, args=(SHAPES[request.param], schedule),
                    store_dir=str(tmp_path_factory.mktemp("store")))
    return schedule, res


def _jax_x(rule, its):
    import jax.numpy as jnp
    from repro.core.ledger import GradLedger, make_aggregate_apply
    from repro.dist.registry import get_rule
    f = 1 if get_rule(rule).needs_f else 0
    led = GradLedger(N, D)
    step = make_aggregate_apply(rule, f, 1e6)
    x = jnp.zeros(D, jnp.float32)
    for ups, rows, recv in its:
        led.upload(ups, rows)
        x = step(x, led.front_for_aggregate(), jnp.asarray(recv), 0.01)
    return np.asarray(x)


def test_host_image_exact_mid_swap_every_round(spawned):
    _, res = spawned
    for o in res:
        assert len(o["host_exact"]) == len(RULES) * ITERS
        assert all(o["host_exact"])


@pytest.mark.parametrize("rule", RULES)
def test_gather_bit_identical_to_device_and_near_jax(spawned, rule):
    schedule, res = spawned
    want = _jax_x(rule, schedule[RULES.index(rule)])
    bound = ATOL * max(float(np.max(np.abs(want))), 1.0)
    for o in res:
        x = o["x"][rule]
        np.testing.assert_array_equal(x["gather"], x["device"])
        np.testing.assert_array_equal(x["gather"], res[0]["x"][rule]["gather"])
        assert float(np.max(np.abs(x["gather"] - want))) <= bound


@pytest.mark.parametrize("rule", RULES)
def test_partial_within_atol(spawned, rule):
    schedule, res = spawned
    want = _jax_x(rule, schedule[RULES.index(rule)])
    bound = ATOL * max(float(np.max(np.abs(want))), 1.0)
    for o in res:
        x = o["x"][rule]
        assert float(np.max(np.abs(x["partial"] - want))) <= bound
        assert float(np.max(np.abs(x["partial"] - x["device"]))) <= bound
        # the same on every rank, bit for bit
        np.testing.assert_array_equal(x["partial"],
                                      res[0]["x"][rule]["partial"])


def test_engine_sharded_bit_identical_to_device(spawned):
    _, res = spawned
    for o in res:
        np.testing.assert_array_equal(o["engine"]["sharded"],
                                      o["engine"]["device"])


def test_buffers_distinct_and_restore_mid_swap(spawned):
    _, res = spawned
    for rank, o in enumerate(res):
        assert o["init_distinct"] and o["load_distinct"]
        assert o["restore_exact"] and o["swap_keeps"]
        assert o["swaps"] == 1
        assert o["block"] == (2 * rank, 2, (2, D))


def test_sharded_ledger_refusals():
    from repro_torch.core.async_engine import AsyncEngine, EngineConfig
    from repro_torch.core.ledger import ShardedGradLedger
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(ValueError, match="needs a mesh"):
        AsyncEngine(lambda j, x, r: x, np.zeros(3),
                    EngineConfig(n_agents=8, agg_backend="sharded",
                                 device="cpu"))
    shape_only = Mesh((3,), ("data",), device="cpu", groups=False)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedGradLedger(4, 10, "cpu", mesh=shape_only, axes=("data",))
    one = Mesh((1, 1), ("data", "model"), device="cpu")
    led = ShardedGradLedger(3, 5, "cpu", mesh=one, axes=("data",))
    led.upload([1], np.ones((1, 5), np.float32))
    np.testing.assert_array_equal(led.host()[1], np.ones(5))
    assert led.n_loc == 3
