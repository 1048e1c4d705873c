"""Port parity for the serving slice: the page allocator and the
scheduler against ``repro.serve`` on the same operation sequences, and
the port's ``ServeEngine`` against JAX's on the same requests and weights
(reduced qwen2-0.5b and yi-6b, f32): token streams and ``stats`` identical
for ``superstep_k`` 1 and 8, under ``fifo`` and under ``sla`` with a
preemption; ``snapshot()`` keys, shapes and values, and ``restart(image)``
resuming the same streams; ``abort``/``crash``. Then the other families
(reduced rwkv6-3b, deepseek-v2-236b, jamba-v0.1-52b, arctic-480b,
qwen2-vl-2b): streams and ``stats`` identical to JAX's for
``superstep_k`` 1 and 4, jamba under preemption (its Mamba slot rows in
the swap image within 1e-4), the reference's 1-, 2-, 3-, 5- and
300-token Mamba prompts, and the refusal to page an encoder-decoder."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.model import init_model as jax_init
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs.registry import get_config
from repro_torch.models.model import init_model, params_from_jax
from repro_torch.serve import (PageAllocator, PagedCacheConfig, Request,
                               Scheduler, ServeEngine,
                               SnapshotInFlightError)

CCFG = dict(num_slots=2, page_size=4, num_pages=24, max_pages_per_seq=8)


@pytest.fixture(scope="module", params=["qwen2-0.5b", "yi-6b"])
def arch(request):
    jcfg = jax_config(request.param).reduced()
    jp = jax_init(jax.random.PRNGKey(0), jcfg, max_pos=64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (get_config(request.param).reduced(), tp), (jcfg, jp)


def _engines(arch, **kw):
    (cfg, tp), (jcfg, jp) = arch
    ccfg = kw.pop("ccfg", CCFG)
    return (ServeEngine(tp, cfg, PagedCacheConfig(**ccfg), device="cpu",
                        **kw),
            JaxEngine(jp, jcfg, jkv.PagedCacheConfig(**ccfg), **kw))


def _workload(seed=3):
    """Mixed prompt lengths and budgets on two slots: retirements stagger,
    so supersteps of every length down to 1 occur and admissions
    interleave with in-flight decodes."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, s).astype(np.int32)
               for s in (5, 9, 3, 6)]
    return prompts, [4, 7, 2, 5]


def _same_streams(out_t, out_j):
    assert sorted(out_t) == sorted(out_j)
    for rid in out_j:
        np.testing.assert_array_equal(out_t[rid], np.asarray(out_j[rid]))


# ---------------------------------------------------------------------------
# bookkeeping: same operations, same answers


def test_allocator_matches_reference():
    ours, ref = PageAllocator(9), jkv.PageAllocator(9)
    ops = [("alloc", 3), ("alloc", 2), ("share", [1, 2]), ("release", [1]),
           ("free", [4, 5]), ("release", [1, 2]), ("free", [2]),
           ("alloc", 6), ("alloc", 9), ("free", [2]), ("share", [8]),
           ("release", [7])]
    for op, arg in ops:
        results = []
        for a in (ours, ref):
            try:
                results.append(("ok", getattr(a, op)(arg)))
            except (MemoryError, ValueError) as e:
                results.append((type(e), None))
        assert results[0] == results[1], (op, arg)
        assert (ours.n_free, ours.n_used) == (ref.n_free, ref.n_used)
        assert [ours.refcount(p) for p in range(9)] == \
            [ref.refcount(p) for p in range(9)]
        assert ours.check_invariants() and ref.check_invariants()
    assert ours._free == ref._free


@pytest.mark.parametrize("policy", ["fifo", "sla"])
def test_scheduler_matches_reference(policy):
    ccfg = dict(num_slots=2, page_size=4, num_pages=12, max_pages_per_seq=6)
    ours = Scheduler(PagedCacheConfig(**ccfg), policy=policy)
    ref = jsched.Scheduler(jkv.PagedCacheConfig(**ccfg), policy=policy)
    rng = np.random.default_rng(0)
    specs = [(5, 4, 0, None), (9, 8, 1, 6.0), (3, 2, 2, 2.0), (30, 1, 0, None),
             (12, 6, 1, None), (4, 3, 0, 1.0)]

    def state(s):
        return ([st.req.rid for st in s.waiting],
                {slot: st.req.rid for slot, st in s.active.items()},
                sorted(s.finished), sorted(s.aborted),
                [(r.rid, why) for r, why in s.rejected], s.peak_active,
                s.total_admitted, s.total_preempted)

    for rid, (s0, new, prio, dl) in enumerate(specs):
        prompt = rng.integers(0, 256, s0).astype(np.int32)
        for s, R in ((ours, Request), (ref, jsched.Request)):
            s.submit(R(rid=rid, prompt=prompt, max_new_tokens=new,
                       priority=prio, deadline=dl))
    for step in range(8):
        for s in (ours, ref):
            s.clock += 1.0
        got = [[st.req.rid for st in s.admissions(free)]
               for s, free in ((ours, 7 - step), (ref, 7 - step))]
        assert got[0] == got[1]
        assert ours.superstep_k(8) == ref.superstep_k(8)
        victims = [ours.preemption_victim(), ref.preemption_victim()]
        assert victims[0] == victims[1]
        if victims[0] is not None:
            ours.preempt(victims[0])
            ref.preempt(victims[1])
        elif ours.active:
            slot = min(ours.active)
            ours.retire(slot)
            ref.retire(slot)
        assert state(ours) == state(ref)
    ours.drop_waiting()
    ref.drop_waiting()
    assert state(ours) == state(ref)


# ---------------------------------------------------------------------------
# the engine against the reference engine


@pytest.mark.parametrize("k", [1, 8])
def test_engine_streams_and_stats_match_reference(arch, k):
    ours, ref = _engines(arch, superstep_k=k)
    prompts, budgets = _workload()
    for p, n in zip(prompts, budgets):
        assert ours.submit(p, n) == ref.submit(p, n)
    out_t, out_j = ours.run(), ref.run()
    _same_streams(out_t, out_j)
    assert ours.stats == ref.stats
    assert [len(out_t[r]) for r in sorted(out_t)] == budgets
    assert ours.kv.alloc.n_used == 0 and ours.kv.alloc.check_invariants()
    if k > 1:
        assert ours.stats["supersteps"] < ours.stats["decode_steps"]


def test_engine_sla_preemption_matches_reference(arch):
    """A high-priority arrival preempts the long low-priority request on
    the single slot; its KV round-trips through the host swap image, and
    streams and stats match the reference engine's."""
    ccfg = dict(num_slots=1, page_size=4, num_pages=16, max_pages_per_seq=8)
    ours, ref = _engines(arch, ccfg=ccfg, superstep_k=1, policy="sla")
    rng = np.random.default_rng(5)
    p_long = rng.integers(0, 256, 6).astype(np.int32)
    p_hot = rng.integers(0, 256, 5).astype(np.int32)
    for eng in (ours, ref):
        eng.submit(p_long, 12, priority=0)
        eng.step()
        eng.step()                                   # mid-decode
        eng.submit(p_hot, 3, priority=2, deadline=2.0)
    out_t, out_j = ours.run(), ref.run()
    _same_streams(out_t, out_j)
    assert ours.stats == ref.stats
    assert ours.stats["preemptions"] >= 1 and ours.stats["resumed"] >= 1
    assert ours.sched.finished[0].preemptions >= 1


def test_snapshot_matches_reference_and_restart_resumes(arch):
    ours, ref = _engines(arch, superstep_k=8)
    prompts, budgets = _workload(seed=7)
    for eng, guard in ((ours, SnapshotInFlightError), (ref, RuntimeError)):
        for p, n in zip(prompts[:2], budgets[:2]):
            eng.submit(p, n)
        with pytest.raises(guard, match="drained") as err:
            eng.snapshot()
        assert err.value.n_waiting == 2
        eng.run()
    img_t, img_j = ours.snapshot(), ref.snapshot()
    assert sorted(img_t) == sorted(img_j)
    for key in img_j:
        assert img_t[key].shape == np.asarray(img_j[key]).shape, key
        np.testing.assert_allclose(img_t[key], np.asarray(img_j[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for eng, img in ((ours, img_t), (ref, img_j)):
        eng.submit(prompts[2], budgets[2])
        eng.step()
        eng.crash()                     # dirty, then the image rejoins
        eng.restart(img)
        assert eng.sched.idle and eng.stats["restarts"] == 1
    rids = [(ours.submit(p, n), ref.submit(p, n))
            for p, n in zip(prompts, budgets)]
    assert all(a == b and a > 2 for a, b in rids)
    _same_streams(ours.run(), ref.run())
    assert ours.stats == ref.stats


def test_abort_and_crash(arch):
    ours, ref = _engines(arch, superstep_k=8)
    prompts, budgets = _workload(seed=9)
    for eng in (ours, ref):
        for p, n in zip(prompts, budgets):
            eng.submit(p, n)
        eng.step()
    lost = []
    for eng in (ours, ref):
        slot = min(eng.sched.active)
        st = eng.abort(slot)
        assert st.req.rid in eng.sched.aborted
        eng.step()
        lost.append(eng.crash())
    assert lost[0] == lost[1]
    assert ours.stats == ref.stats
    assert ours.sched.idle and ours.kv.alloc.n_used == 0
    assert sorted(ours.sched.aborted) == sorted(ref.sched.aborted)
    _same_streams({r: st.generated for r, st in ours.sched.finished.items()},
                  {r: st.generated for r, st in ref.sched.finished.items()})


def test_engine_refuses_what_is_not_ported(arch):
    (cfg, tp), _ = arch
    # the prefix cache is ported: an attention-only arch builds its index
    assert ServeEngine(tp, cfg, device="cpu",
                       prefix_cache="on").kv.prefix is not None
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ServeEngine(tp, cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="superstep_k"):
        ServeEngine(tp, cfg, device="cpu", superstep_k=0)
    eng = ServeEngine(tp, cfg, device="cpu")
    assert eng.submit(np.arange(4), 1) == 0        # first token from prefill
    assert eng.run()[0].shape == (1,) and eng.stats["decode_steps"] == 0
    assert isinstance(eng.kv.cache[0]["mixer"]["k_pages"], torch.Tensor)


# ---------------------------------------------------------------------------
# the other model families: MoE (drop-free), MLA latent pages, Mamba and
# RWKV slot state, M-RoPE


FAMILIES = ["rwkv6-3b", "deepseek-v2-236b", "jamba-v0.1-52b",
            "arctic-480b", "qwen2-vl-2b"]


def _pair(name):
    """((port cfg, port params), (JAX cfg, JAX params)), reduced, the
    JAX weights carried over."""
    jcfg = jax_config(name).reduced()
    jp = jax_init(jax.random.PRNGKey(0), jcfg, max_pos=64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (get_config(name).reduced(), tp), (jcfg, jp)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def jamba():
    return _pair("jamba-v0.1-52b")


@pytest.mark.parametrize("k", [1, 4])
def test_family_streams_and_stats_match_reference(family, k):
    """Mixed prompt lengths and budgets on two slots (as the reference's
    ragged-rollout test): streams and stats identical to JAX's engine,
    every budget met, every page back; recurrent archs prefill each
    exact length, MoE serves drop-free."""
    ours, ref = _engines(family, superstep_k=k)
    prompts, budgets = _workload(seed=11)
    for p, n in zip(prompts, budgets):
        assert ours.submit(p, n) == ref.submit(p, n)
    out_t, out_j = ours.run(), ref.run()
    _same_streams(out_t, out_j)
    assert ours.stats == ref.stats
    assert [len(out_t[r]) for r in sorted(out_t)] == budgets
    assert ours.kv.alloc.n_used == 0 and ours.kv.alloc.check_invariants()
    assert ours._pad_buckets == ref._pad_buckets
    assert dataclasses.asdict(ours.infer_cfg) == \
        dataclasses.asdict(ref.infer_cfg)
    if ours.cfg.moe is not None:
        moe = ours.infer_cfg.moe
        assert moe.capacity_factor * moe.top_k >= moe.num_experts


def test_jamba_preemption_swaps_slot_state(jamba):
    """SLA preemption of a hybrid arch: the victim's attention pages and
    its Mamba layers' slot rows round-trip through the host image."""
    ccfg = dict(num_slots=1, page_size=4, num_pages=16, max_pages_per_seq=8)
    ours, ref = _engines(jamba, ccfg=ccfg, superstep_k=1, policy="sla")
    rng = np.random.default_rng(5)
    p_long = rng.integers(0, 256, 6).astype(np.int32)
    p_hot = rng.integers(0, 256, 5).astype(np.int32)
    swaps = []
    for eng in (ours, ref):
        eng.submit(p_long, 12, priority=0)
        eng.step()
        eng.step()
        eng.submit(p_hot, 3, priority=2, deadline=2.0)
        eng.step()                                   # the preemption
        swaps.append(eng.sched.waiting[0].swap)
    assert sorted(swaps[0].slot_rows) == sorted(swaps[1].slot_rows)
    assert len(swaps[0].slot_rows) == 14     # 7 Mamba layers x (h, conv)
    for key, rows in swaps[1].slot_rows.items():
        np.testing.assert_allclose(swaps[0].slot_rows[key].numpy(),
                                   np.asarray(rows), rtol=1e-4, atol=1e-4,
                                   err_msg=str(key))
    out_t, out_j = ours.run(), ref.run()
    _same_streams(out_t, out_j)
    assert ours.stats == ref.stats and ours.stats["resumed"] >= 1


def test_mamba_prompt_lengths_as_in_reference(jamba):
    """The reference's results for a hybrid arch, mirrored: a 1-token
    prompt serves (its one conv-tail row broadcast over the window), a
    2-token prompt fails at admission, 3 and 5 tokens serve, and a
    300-token prefill fails the scan's chunk rule (prefills of at most
    256 tokens or a multiple of 256)."""
    ccfg = dict(num_slots=2, page_size=16, num_pages=48,
                max_pages_per_seq=24)
    rng = np.random.default_rng(13)
    for s0, fails in ((1, False), (2, True), (3, False), (5, False),
                      (300, True)):
        ours, ref = _engines(jamba, ccfg=ccfg, superstep_k=4)
        prompt = rng.integers(0, 256, s0).astype(np.int32)
        for eng in (ours, ref):
            eng.submit(prompt, 3)
        if fails:
            with pytest.raises((ValueError, AssertionError)):
                ref.run()
            with pytest.raises((ValueError, RuntimeError)):
                ours.run()
            continue
        _same_streams(ours.run(), ref.run())
        assert ours.stats == ref.stats


def test_paged_serving_refuses_encoder_decoder():
    cfg = get_config("whisper-base").reduced()
    tp = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(tp, cfg, device="cpu")
