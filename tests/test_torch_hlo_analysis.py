"""``repro_torch.launch.hlo_analysis``: the counter of one rank's
dispatched ops (the port's counterpart of the reference's optimized-HLO
analysis), on small hand-checked programs.

- A 7-step loop of ``tanh(c @ w)`` on 64 x 64 f32 counts exactly
  7 * 2 * 64^3 FLOPs, on the CPU and on the meta device; the reference's
  analysis of the same loop as a ``lax.scan`` holds it to 1% (its own
  test's tolerance).
- ``hbm_bytes`` equals operand plus result bytes summed by hand; views
  are free and a copy is not.
- One recorded all-reduce of N bytes counts 2N (the ring convention),
  ``collective_count`` 1; a group of one rank counts nothing; a real
  ``Mesh`` reports through the same hook.
- ``breakdown`` orders ops by FLOPs and by bytes; ``analyze`` of the
  saved (JSON) table equals that of the counter.
- The peak of live temporaries is what a hand trace gives.
- A reduced train step dispatches the same ops with the same FLOPs and
  bytes on the meta device as on the CPU (``diff`` names none, and names
  an op whose bytes were changed).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze as jax_analyze
from repro_torch.launch.hlo_analysis import (OpCounter, analyze, breakdown,
                                            diff)
from repro_torch.launch.mesh import Mesh, RecordingMesh, watch_collectives

N, STEPS = 64, 7
F32 = 4


def _loop(c, w):
    x = c
    for _ in range(STEPS):
        x = torch.tanh(x @ w)
    return x.sum()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_flops_exact_and_reference_within_one_percent(device):
    rng = np.random.default_rng(0)
    c, w = (torch.from_numpy(rng.standard_normal((N, N), np.float32))
            .to(device) for _ in range(2))
    with OpCounter() as cnt:
        _loop(c, w)
    a = analyze(cnt)
    assert a["flops"] == STEPS * 2 * N ** 3
    assert a["unknown_trip_counts"] == 0

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=STEPS)
        return jnp.sum(y)
    sds = jax.ShapeDtypeStruct((N, N), jnp.float32)
    ref = jax_analyze(jax.jit(f).lower(sds, sds).compile().as_text())
    assert ref["flops"] == pytest.approx(a["flops"], rel=0.01)


def test_hbm_bytes_hand_summed():
    m = N * N * F32
    c, w = torch.ones(N, N), torch.ones(N, N)
    with OpCounter() as cnt:
        _loop(c, w)
    # mm: two operands and a result; tanh: one of each; sum: to 4 bytes
    assert analyze(cnt)["hbm_bytes"] == STEPS * 3 * m + STEPS * 2 * m + m + 4
    with OpCounter() as cnt:
        y = c.t().view(-1, N).reshape(N, N)[1:]   # views: free
        y.detach()
        torch.empty(10)
        z = y.clone()                             # a copy reads and writes
        c.t().reshape(-1)                         # a reshape that copies
    assert analyze(cnt)["hbm_bytes"] == 2 * (N - 1) * N * F32 + 2 * m
    assert z.shape == (N - 1, N)


def test_all_reduce_counts_twice_its_bytes():
    mesh = RecordingMesh((16, 16), ("data", "model"))
    x = torch.empty(1000, dtype=torch.bfloat16, device="meta")
    with OpCounter() as cnt:
        y = mesh.all_reduce(x, ("model", "data"))
        mesh.all_reduce(x[:10], ())                # one rank: no collective
    a = analyze(cnt)
    assert a["collectives"]["all-reduce"] == 2 * 2000
    assert a["collective_bytes"] == 2 * 2000
    assert a["collective_count"] == 1
    assert [c["axes"] for c in cnt.table()["collectives"]] == \
        [["data", "model"]]
    assert y.shape == x.shape and y.device.type == "meta"
    assert all(v == 0 for k, v in a["collectives"].items()
               if k != "all-reduce")

    seen = []
    real = Mesh((1, 1), ("data", "model"), device="cpu")
    with watch_collectives(lambda *r: seen.append(r)):
        real.all_reduce(torch.zeros(3), "data")
    assert seen == [("all-reduce", ("data",), 1, 12)]


def test_breakdown_orders_and_saved_table_reanalyzes():
    a, b = torch.ones(32, 16), torch.ones(16, 8)
    c, d = torch.ones(2, 8, 64), torch.ones(2, 64, 64)
    with OpCounter() as cnt:
        (a @ b)
        torch.bmm(c, d)
        a + 1
    rows = breakdown(cnt)
    assert [r[1] for r in rows["flops"]] == ["aten.bmm.default",
                                             "aten.mm.default"]
    assert [r[0] for r in rows["flops"]] == [2 * 2 * 8 * 64 * 64,
                                             2 * 32 * 16 * 8]
    by_bytes = [r[0] for r in rows["bytes"]]
    assert by_bytes == sorted(by_bytes, reverse=True) and len(by_bytes) == 3
    assert len(breakdown(cnt, top=1)["bytes"]) == 1
    table = json.loads(json.dumps(cnt.table()))
    assert analyze(table) == analyze(cnt)


def test_peak_of_live_temporaries():
    kb = 256 * F32
    with OpCounter() as cnt:
        x = torch.ones(256)                  # 1 KB alive
        y = x * 2                            # 2 KB
        del x                                # 1 KB
        z = y + 1                            # 2 KB
        y.add_(1)                            # in place: no new storage
        v = z.view(16, 16)                   # a view: none either
    assert cnt.peak_temp_bytes == 2 * kb
    assert cnt.live_bytes == 2 * kb
    assert v.shape == (16, 16)


def test_meta_and_cpu_dispatch_the_same_ops():
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import (TrainConfig, abstract_state,
                                          init_state, make_train_step)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              n_layers=2)
    tc = TrainConfig(remat_policy="full")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    tables = {}
    for dev in ("cpu", "meta"):
        state = (init_state(torch.Generator().manual_seed(0), cfg, tc,
                            max_pos=17, device="cpu") if dev == "cpu"
                 else abstract_state(cfg, tc, max_pos=17))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "targets": torch.from_numpy(toks[:, 1:]),
                 "weights": torch.ones(4, 16)}
        batch = {k: v.to(dev) for k, v in batch.items()}
        with OpCounter() as cnt:
            make_train_step(cfg, tc, moe_groups=2)(state, batch)
        tables[dev] = cnt.table()
    assert diff(tables["meta"], tables["cpu"]) == {}
    assert analyze(tables["meta"]) == analyze(tables["cpu"])
    assert analyze(tables["cpu"])["flops"] > 0
    changed = {op: {**r, "bytes": r["bytes"] + 2}
               for op, r in tables["cpu"]["ops"].items()
               if op == "aten.mm.default"}
    assert list(diff(tables["cpu"], {"ops": {**tables["cpu"]["ops"],
                                             **changed}})) == \
        ["aten.mm.default"]


def test_train_step_leaves_no_tensor_in_a_reference_cycle():
    """Every temporary of a step is freed when its last reference goes,
    not when the garbage collector next runs: the peak of live bytes is
    then a property of the step, the same on the meta device and on a
    card (``tree_unflatten`` once built trees with a recursive closure,
    a cycle that held every leaf)."""
    import gc
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import (TrainConfig, abstract_state,
                                          make_train_step)
    cfg = get_config("qwen2-0.5b").reduced()
    tc = TrainConfig()
    step = make_train_step(cfg, tc, moe_groups=2)
    batch = {k: torch.empty((4, 16), dtype=dt, device="meta") for k, dt in
             (("tokens", torch.int32), ("targets", torch.int32),
              ("weights", torch.float32))}
    step(abstract_state(cfg, tc, max_pos=17), batch)   # lazy imports
    gc.collect()
    flags = gc.get_debug()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = step(abstract_state(cfg, tc, max_pos=17), batch)
        del out
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.enable()
    assert held == []
