"""Port parity for the prefix cache: ``repro_torch.serve.prefix`` and the
prefix branches of the port's ``PagedKVCache`` and ``ServeEngine``
against ``repro.serve`` on the CPU.

The index is numpy and ``hashlib``: chunk hashes, plans, refcounts and
the LRU's eviction order must be identical on the same operations. The
engine runs reduced qwen2-0.5b (GQA pages) and deepseek-v2-236b (MLA
latent pages) in f32 on the JAX engine's weights, on
``tests/test_serve_prefix.py``'s prompt mix: token streams and the whole
``stats`` dict must be identical to JAX's (exact: both are greedy argmax
over the same f32 weights, and the suffix feed runs the same decode
program in both), and equal to the cache-off streams. Then COW isolation
of concurrent identical prompts, LRU eviction under pool pressure,
preemption and swap under ``sla``, ``reset_prefix_cache`` and the
refusal of an arch with recurrent layers."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.model import init_model as jax_init
from repro.serve import PagedCacheConfig as JaxCacheConfig
from repro.serve import ServeEngine as JaxEngine
from repro.serve import kv_cache as jkv
from repro.serve import prefix as jprefix
from repro_torch.configs.registry import get_config
from repro_torch.models.model import init_model, params_from_jax
from repro_torch.serve import PagedCacheConfig, ServeEngine
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import prefix as tprefix

CCFG = dict(num_slots=2, page_size=4, num_pages=24, max_pages_per_seq=8)


def _pair(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    jp = jax_init(jax.random.PRNGKey(seed), jcfg, max_pos=64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (get_config(arch).reduced(), tp), (jcfg, jp)


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2-0.5b")


def _engines(pair, ccfg=CCFG, **kw):
    (cfg, tp), (jcfg, jp) = pair
    return (ServeEngine(tp, cfg, PagedCacheConfig(**ccfg), device="cpu",
                        **kw),
            JaxEngine(jp, jcfg, JaxCacheConfig(**ccfg), **kw))


def _shared_mix(vocab, seed=3):
    """``tests/test_serve_prefix.py``'s mix: a duplicate full prompt (COW),
    a shared 8-token stem (a partial-block hit) and a cold prompt."""
    rng = np.random.default_rng(seed)
    p0 = rng.integers(0, vocab, 9).astype(np.int32)
    p2 = np.concatenate([p0[:8],
                         rng.integers(0, vocab, 3).astype(np.int32)])
    p3 = rng.integers(0, vocab, 7).astype(np.int32)
    return [p0, p0.copy(), p2, p3], [4, 3, 5, 4]


def _serve(eng, prompts, budgets, **submit_kw):
    rids = [eng.submit(p, n, **submit_kw) for p, n in zip(prompts, budgets)]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _checked_run(eng, max_steps=500):
    """``run()`` with both books checked after every step."""
    steps = 0
    while not eng.sched.idle:
        eng.step()
        eng.kv.alloc.check_invariants()
        if eng.kv.prefix is not None:
            eng.kv.prefix.check_invariants()
        steps += 1
        assert steps < max_steps
    return {rid: np.asarray(st.generated, np.int32)
            for rid, st in eng.sched.finished.items()}


# ---------------------------------------------------------------------------
# the index: numpy and hashlib, identical on the same operations


@pytest.mark.parametrize("page_size", [1, 4, 6, 16])
def test_chunk_hashes_equal_reference(page_size):
    rng = np.random.default_rng(page_size)
    for n in (1, 3, 4, 12, 17, 64):
        p = rng.integers(0, 151_936, n).astype(np.int32)
        assert tprefix.chunk_hashes(p, page_size) == \
            jprefix.chunk_hashes(p, page_size)
    # the reference's chain property: a change in block 0 changes all
    a = np.arange(12, dtype=np.int32)
    b = a.copy()
    b[0] = 99
    fa, _ = tprefix.chunk_hashes(a, 4)
    fb, _ = tprefix.chunk_hashes(b, 4)
    assert all(x != y for x, y in zip(fa, fb))


def _index_ops(mod_kv, mod_prefix, seed, n_ops=300):
    """A seeded random sequence of plan/acquire/register/release/reclaim
    over one allocator and index, the engine's admission protocol (COW
    included); returns the log of every answer and the books after each
    operation."""
    alloc = mod_kv.PageAllocator(20)
    idx = mod_prefix.PrefixIndex(alloc, 4)
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, 12).astype(np.int32) for _ in range(3)]
    holders, log, seen = [], [], []
    for _ in range(n_ops):
        op = rng.integers(0, 10)
        if op < 5:
            stem = stems[rng.integers(0, 3)]
            tail = rng.integers(0, 50, rng.integers(0, 6)).astype(np.int32)
            prompt = np.concatenate([stem[:rng.integers(1, 13)], tail])
            if seen and rng.integers(0, 3) == 0:     # a repeated prompt
                prompt = seen[int(rng.integers(0, len(seen)))]
            seen.append(prompt)
            total = prompt.size + int(rng.integers(1, 6))
            plan = idx.plan(prompt, total)
            log.append(("plan", plan.cached_len, plan.shared, plan.cow,
                        plan.need_pages, idx.headroom(plan.shared)))
            if plan.need_pages > idx.headroom(plan.shared):
                continue
            idx.acquire(plan.shared)
            shared = list(plan.shared)
            if plan.need_pages > alloc.n_free:
                log.append(("reclaim", idx.reclaim(
                    plan.need_pages - alloc.n_free)))
            priv = alloc.alloc(plan.need_pages)
            if plan.cow:
                idx.release([shared[-1]])
                shared[-1] = priv[0]
                priv = priv[1:]
            pages = shared + priv
            log.append(("register", idx.register(prompt, pages)))
            holders.append(pages)
        elif op < 8 and holders:
            pages = holders.pop(int(rng.integers(0, len(holders))))
            log.append(("release", idx.release(pages)))
        else:
            log.append(("reclaim", idx.reclaim(int(rng.integers(0, 4)))))
        idx.check_invariants()
        log.append(("books", sorted(alloc._ref.items()), list(idx._lru),
                    sorted(idx._page_of.items()), idx.hits,
                    idx.registered, idx.evictions))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_index_operations_equal_reference(seed):
    ours = _index_ops(tkv, tprefix, seed)
    ref = _index_ops(jkv, jprefix, seed)
    assert ours == ref
    kinds = {e[0] for e in ours}
    assert {"plan", "register", "release", "reclaim"} <= kinds
    books = [e for e in ours if e[0] == "books"]
    assert books[-1][6] > 0              # the LRU evicted pages
    assert any(e[3] for e in ours if e[0] == "plan")     # COW plans too


# ---------------------------------------------------------------------------
# the engine against JAX's


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b"])
def test_cached_admission_equals_reference(arch):
    pair = _pair(arch)
    prompts, budgets = _shared_mix(pair[0][0].vocab_size)
    off, _ = _engines(pair, superstep_k=1)
    cold = _serve(off, prompts, budgets)
    for k in (1, 4):
        ours, ref = _engines(pair, superstep_k=k, prefix_cache="on")
        got = _serve(ours, prompts, budgets)
        _same(got, _serve(ref, prompts, budgets))
        _same(got, cold)
        assert ours.stats == ref.stats
        assert ours.stats["cache_hit_tokens"] > 0
        assert ours.stats["cow_forks"] >= 1
        assert ours.stats["suffix_steps"] > 0
        ours.kv.prefix.check_invariants()
        assert ours.kv.alloc.n_used == ours.kv.prefix.n_indexed
        assert ours.kv.prefix.n_indexed == ref.kv.prefix.n_indexed


def test_cow_isolates_concurrent_identical_prompts(qwen):
    """The second of two identical page-aligned prompts arrives while the
    first decodes: it forks the full-hit page before its re-feed write,
    and both streams equal the solo cold stream and JAX's."""
    rng = np.random.default_rng(9)
    p = rng.integers(0, 256, 8).astype(np.int32)
    solo, _ = _engines(qwen)
    ref_stream = _serve(solo, [p], [6])[0]
    outs = []
    for eng in _engines(qwen, superstep_k=1, prefix_cache="on"):
        r1 = eng.submit(p, 6)
        eng.step()
        r2 = eng.submit(p.copy(), 6)
        out = eng.run()
        outs.append((np.asarray(out[r1]), np.asarray(out[r2]),
                     dict(eng.stats)))
    (a1, a2, st), (b1, b2, jst) = outs
    _same([a1, a2], [b1, b2])
    _same([a1, a2], [ref_stream, ref_stream])
    assert st == jst and st["cow_forks"] >= 1


def test_lru_eviction_under_pool_pressure(qwen):
    """A pool too small to keep every retired prompt reclaims refcount-0
    pages oldest first; streams, stats and the index equal JAX's, with
    both books checked after every step."""
    rng = np.random.default_rng(4)
    ccfg = dict(num_slots=1, page_size=4, num_pages=10, max_pages_per_seq=8)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(6)]
    prompts += [prompts[4].copy(), prompts[0].copy()]   # a hit, a miss
    ours, ref = _engines(qwen, ccfg, superstep_k=1, prefix_cache="on")
    rids = [ours.submit(p, 4) for p in prompts]
    got = _checked_run(ours)
    want = _serve(ref, prompts, [4] * len(prompts))
    _same([got[r] for r in rids], want)
    assert ours.stats == ref.stats
    assert ours.stats["prefix_evictions"] > 0
    assert ours.stats["cache_hit_tokens"] > 0
    assert sorted(ours.kv.prefix._page_of.items()) == \
        sorted(ref.kv.prefix._page_of.items())
    assert list(ours.kv.prefix._lru) == list(ref.kv.prefix._lru)
    off, _ = _engines(qwen, ccfg)
    _same([got[r] for r in rids], _serve(off, prompts, [4] * len(prompts)))


def test_preempt_swap_resume_under_sla(qwen):
    """A high-priority arrival preempts the long request on the single
    slot; the victim's pages go back to the index, and on resume its
    resident prompt blocks are re-shared. Streams and stats equal JAX's
    and the solo cold streams."""
    rng = np.random.default_rng(5)
    ccfg = dict(num_slots=1, page_size=4, num_pages=16, max_pages_per_seq=8)
    p_long = rng.integers(0, 256, 9).astype(np.int32)
    p_hot = np.concatenate([p_long[:4],
                            rng.integers(0, 256, 2).astype(np.int32)])
    outs = []
    for eng in _engines(qwen, ccfg, superstep_k=1, prefix_cache="on",
                        policy="sla"):
        r_long = eng.submit(p_long, 12, priority=0)
        eng.step()
        eng.step()
        r_hot = eng.submit(p_hot, 3, priority=2, deadline=2.0)
        out = _checked_run(eng) if isinstance(eng, ServeEngine) \
            else eng.run()
        outs.append(([np.asarray(out[r_long]), np.asarray(out[r_hot])],
                     dict(eng.stats)))
    (got, st), (want, jst) = outs
    _same(got, want)
    assert st == jst
    assert st["preemptions"] >= 1 and st["resumed"] >= 1
    assert st["swapped_pages"] >= 1 and st["cache_hit_tokens"] > 0
    solo, _ = _engines(qwen, ccfg)
    _same(got, _serve(solo, [p_long, p_hot], [12, 3]))


def test_reset_prefix_cache_gives_a_cold_cache(qwen):
    rng = np.random.default_rng(6)
    p = rng.integers(0, 256, 9).astype(np.int32)
    ccfg = dict(num_slots=1, page_size=4, num_pages=16, max_pages_per_seq=8)
    ours, ref = _engines(qwen, ccfg, prefix_cache="on")
    for eng in (ours, ref):
        first = _serve(eng, [p], [4])[0]
        assert eng.kv.prefix.n_indexed > 0
        eng.reset_prefix_cache()
        assert eng.kv.prefix.n_indexed == 0 and eng.kv.alloc.n_used == 0
        hits = eng.stats["cache_hit_tokens"]
        _same(_serve(eng, [p], [4]), [first])
        assert eng.stats["cache_hit_tokens"] == hits
    assert ours.stats == ref.stats
    # restart rebuilds the cache with the index, cold
    ours.restart()
    assert ours.kv.prefix is not None and ours.kv.prefix.n_indexed == 0


def test_prefix_off_keeps_the_grouped_path(qwen):
    """``prefix_cache="off"`` admits in prefill groups and builds no
    index; its counters of the cache stay 0."""
    prompts, budgets = _shared_mix(256)
    ours, ref = _engines(qwen, superstep_k=4)
    _same(_serve(ours, prompts, budgets), _serve(ref, prompts, budgets))
    assert ours.kv.prefix is None and ours.stats == ref.stats
    assert ours.stats["cache_hit_tokens"] == ours.stats["suffix_steps"] == 0


def test_prefix_cache_refused_for_recurrent_layers():
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=64)
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(params, cfg, PagedCacheConfig(), prefix_cache="on",
                    device="cpu")
    with pytest.raises(ValueError, match="off|on"):
        ServeEngine(params, cfg, PagedCacheConfig(), prefix_cache="maybe",
                    device="cpu")
