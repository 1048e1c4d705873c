"""The port's spans (``repro_torch.spans``) and their call sites.

The module: nesting and parent ids, one stack per thread, nothing
recorded, kept or allocated with tracing off (no profiler range and no
CUDA event made), recording under ``torch.profiler.profile()`` (as
ranges of the profiler's own host events) and between ``start()`` and
``stop()``, the bounded buffer's drop count, no device time on the CPU.

The call sites, on reduced qwen2-0.5b (f32, CPU): ``ServeEngine`` with
the prefix cache off and on, ``superstep_k`` 1 and 8 -- one
``serve.step`` per ``step()``, a ``serve.prefill`` per prefill call, the
supersteps' ``k`` summing to the decode steps, one ``serve.queued`` per
admitted request on the clock of its ``ttft``, a period span per period
of every forward named after the phase that ran it, and the token streams and ``stats`` identical with
tracing on and off; ``TrainLoop`` -- one ``train.step`` a step with its
children and a period span a period of each forward, the losses
identical on and off. A whole run with no profiler and no ``start()``
records nothing. The file imports no JAX; its last test needs a card."""
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import lm_batches, markov_tokens
from repro_torch.launch import loop as tloop
from repro_torch.launch import train as ttrain
from repro_torch.models.model import init_model
from repro_torch.serve import PagedCacheConfig, ServeEngine

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA events: runs on a GPU only")


@pytest.fixture(autouse=True)
def _fresh():
    spans.stop()
    spans.clear()
    yield
    spans.stop()
    spans.clear()


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


# ---------------------------------------------------------------------------
# the module


def test_nesting_and_parent_ids():
    spans.start()
    with spans.span("a", rid=7, n=1) as a:
        with spans.span("b") as b:
            spans.emit("e", 5, 9, rid=3, m=2)
        with spans.span("c") as c:
            c.set(late=4)
    spans.stop()
    got = {s.name: s for s in spans.recorded()}
    assert set(got) == {"a", "b", "c", "e"}
    assert got["a"].parent is None and got["a"].rid == 7
    assert got["a"].counts == {"n": 1}
    assert got["b"].parent == a.id and got["c"].parent == a.id
    assert got["e"].parent == b.id
    assert (got["e"].t0_ns, got["e"].t1_ns, got["e"].rid,
            got["e"].counts) == (5, 9, 3, {"m": 2})
    assert got["c"].counts == {"late": 4}
    for s in (a, b, c):
        assert a.t0_ns <= s.t0_ns <= s.t1_ns <= a.t1_ns
    assert len({a.id, b.id, c.id, got["e"].id}) == 4


def test_span_under_is_named_after_the_innermost_open_span():
    assert spans.span_under("period") is spans.span("x")    # off: the no-op
    spans.start()
    with spans.span_under("period"):
        pass
    with spans.span("serve.step"):
        with spans.span("serve.superstep") as sup:
            with spans.span_under("period"):
                pass
        with spans.span_under("period"):
            pass
    spans.stop()
    got = [(s.name, s.parent) for s in spans.recorded()]
    step = [s for s in spans.recorded() if s.name == "serve.step"][0]
    assert got[:2] == [("period", None), ("serve.superstep.period", sup.id)]
    assert ("serve.step.period", step.id) in got


def test_each_thread_has_its_own_stack():
    spans.start()
    entered, release = threading.Event(), threading.Event()
    ids = {}

    def other():
        with spans.span("t.outer") as o:
            ids["outer"] = o.id
            entered.set()
            assert release.wait(10)
            with spans.span("t.inner") as i:
                ids["inner"] = i.id

    th = threading.Thread(target=other)
    th.start()
    assert entered.wait(10)
    with spans.span("main") as m:       # opened while the thread's is open
        release.set()
        th.join(10)
    assert not th.is_alive()
    spans.stop()
    got = {s.name: s for s in spans.recorded()}
    assert got["main"].parent is None
    assert got["t.outer"].parent is None
    assert got["t.inner"].parent == ids["outer"]
    assert m.id not in (got["t.outer"].parent, got["t.inner"].parent)


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(spans, "_range", lambda *a: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(("event", a, k)))
    assert spans.span("x") is spans.span("y", rid=1, device=True, n=2)

    def calls(n):
        for _ in range(n):
            with spans.span("serve.step", device=True, k=3) as sp:
                sp.set(live=4)
            spans.emit("serve.queued", 0, 1, rid=2)

    calls(100)                          # warm: first-call caches
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(10_000)
        grew = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grew < 1024, grew            # 10,000 calls keep nothing
    assert spans.recorded() == [] and spans.dropped() == 0
    assert made == []


def test_records_under_the_profiler_as_its_ranges():
    from torch.profiler import ProfilerActivity, profile
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("p.outer"):
            with spans.span("p.inner"):
                torch.ones(4).sum()
    with spans.span("after"):
        pass
    got = _by_name(spans.recorded())
    assert set(got) == {"p.outer", "p.inner"}
    host = {e.name: e for e in prof.events()}
    for name in ("p.outer", "p.inner"):
        assert name in host
        assert host[name].device_type == torch.autograd.DeviceType.CPU
        assert not host[name].is_user_annotation
    assert host["p.outer"].time_range.start <= \
        host["p.inner"].time_range.start <= host["aten::ones"].time_range.start
    assert host["p.inner"].time_range.end <= host["p.outer"].time_range.end


def test_records_between_start_and_stop_only(monkeypatch):
    made = []
    monkeypatch.setattr(spans, "_range", lambda *a: made.append(a))
    with spans.span("before"):
        pass
    spans.start()
    with spans.span("during"):
        spans.emit("emitted", 1, 2)
    spans.stop()
    with spans.span("after"):
        pass
    assert [s.name for s in spans.recorded()] == ["emitted", "during"]
    assert made == []                   # no profiler: no profiler range
    spans.clear()
    assert spans.recorded() == []


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 5)
    spans.start()
    for i in range(8):
        with spans.span("s", i=i):
            pass
    spans.emit("e", 0, 1)
    spans.stop()
    assert [s.counts["i"] for s in spans.recorded()] == [0, 1, 2, 3, 4]
    assert spans.dropped() == 4
    spans.clear()
    assert spans.dropped() == 0 and spans.recorded() == []


def test_device_time_on_the_cpu_is_none():
    spans.start()
    with spans.span("d", device=True):
        torch.ones(8).sum()
    spans.stop()
    (s,) = spans.recorded()
    assert s.device_ms is None and s._events is None
    assert s.t1_ns >= s.t0_ns


# ---------------------------------------------------------------------------
# the serving engine

CCFG = dict(num_slots=2, page_size=4, num_pages=24, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=64)
    return cfg, params


def _requests():
    """Mixed lengths and budgets; prompts 1 and 3 repeat prompt 0's first
    8 tokens, so the prefix cache hits and feeds suffixes."""
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 256, s).astype(np.int32) for s in (9, 5, 6)]
    prompts = [p[0], np.concatenate([p[0][:8], p[1][:2]]), p[2],
               np.concatenate([p[0][:8], p[1]])]
    return prompts, [4, 7, 2, 5]


def _serve(qwen, k, prefix):
    """Drive every request to completion; returns the engine, the
    streams, the stats and the number of ``step()`` calls."""
    cfg, params = qwen
    eng = ServeEngine(params, cfg, PagedCacheConfig(**CCFG), superstep_k=k,
                      prefix_cache=prefix, device="cpu")
    prompts, budgets = _requests()
    for p, n in zip(prompts, budgets):
        eng.submit(p, n)
    steps = 0
    while not eng.sched.idle:
        eng.step()
        steps += 1
    out = {rid: st.generated for rid, st in eng.sched.finished.items()}
    return eng, out, dict(eng.stats), steps


@pytest.mark.parametrize("prefix", ["off", "on"])
@pytest.mark.parametrize("k", [1, 8])
def test_serving_spans_match_the_engine_counters(qwen, k, prefix):
    _, out_off, stats_off, _ = _serve(qwen, k, prefix)
    assert spans.recorded() == []
    spans.start()
    eng, out_on, stats_on, steps = _serve(qwen, k, prefix)
    spans.stop()
    assert out_on == out_off and stats_on == stats_off
    rec = spans.recorded()
    got = _by_name(rec)
    ids = {s.id: s for s in rec}
    st = eng.stats
    assert len(got["serve.step"]) == steps
    assert len(got["serve.prefill"]) == st["prefill_calls"]
    assert sum(s.counts["k"] for s in got["serve.superstep"]) == \
        st["decode_steps"]
    assert len(got["serve.superstep"]) == st["supersteps"]
    assert all(s.counts["k"] <= k for s in got["serve.superstep"])
    assert len(got["serve.admit"]) == steps
    assert len(got["serve.sync"]) == st["host_syncs"]
    prompts, _ = _requests()
    assert sum(s.counts["tokens"] for s in got["serve.prefill"]) + \
        sum(s.counts["tokens"] for s in got.get("serve.suffix", [])) == \
        sum(len(p) for p in prompts) - st["cache_hit_tokens"]
    assert (len(got.get("serve.suffix", [])) > 0) == (prefix == "on")
    assert st["cache_hit_tokens"] > 0 or prefix == "off"
    # one serve.queued per admitted request, on the clock of its ttft,
    # ending inside the admission before the request's own prefill or
    # suffix feed
    queued = {s.rid: s for s in got["serve.queued"]}
    assert len(got["serve.queued"]) == st["admitted"] == len(queued)
    own = {s.rid: s for s in got["serve.prefill"] + got.get("serve.suffix",
                                                            [])
           if s.rid is not None}
    assert (len(own) == st["admitted"]) == (prefix == "on")
    for rid, s in queued.items():
        req = eng.sched.finished[rid]
        assert s.t0_ns == req.t_submit_ns
        assert 0 <= s.t1_ns - s.t0_ns <= req.ttft * 1e9
        assert ids[s.parent].name == "serve.admit"
        assert ids[s.parent].t0_ns <= s.t1_ns
        if rid in own:
            assert s.t1_ns <= own[rid].t0_ns
    if prefix == "off":     # one stamp a group, just before its prefill
        stamps = sorted({q.t1_ns for q in queued.values()})
        calls = sorted((p.t0_ns, p.t1_ns) for p in got["serve.prefill"])
        assert len(stamps) == len(calls)
        assert all(t <= t0 for t, (t0, _) in zip(stamps, calls))
        assert all(t1 <= t for t, (_, t1) in zip(stamps[1:], calls))
    # the phases nest inside the step
    for name, parents in (("serve.admit", {"serve.step"}),
                          ("serve.prefill", {"serve.admit"}),
                          ("serve.superstep", {"serve.step"}),
                          ("serve.commit", {"serve.superstep"}),
                          ("serve.sync", {"serve.prefill", "serve.superstep",
                                          "serve.suffix"})):
        assert {ids[s.parent].name for s in got.get(name, [])} <= parents
    assert all(s.parent is None for s in got["serve.step"])
    assert all(s.device_ms is None for s in rec)
    # a span a period of every forward the engine launches
    n = eng.cfg.n_periods
    assert len(got["serve.prefill.period"]) == n * st["prefill_calls"]
    assert len(got["serve.superstep.period"]) == n * st["decode_steps"]
    assert len(got.get("serve.suffix.period", [])) == n * st["suffix_steps"]
    for name in ("serve.prefill", "serve.superstep", "serve.suffix"):
        assert {ids[s.parent].name for s in got.get(name + ".period", [])
                } <= {name}


def test_serving_under_the_profiler_is_unchanged(qwen):
    from torch.profiler import ProfilerActivity, profile
    _, out_off, stats_off, _ = _serve(qwen, 8, "off")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, out_on, stats_on, steps = _serve(qwen, 8, "off")
    assert out_on == out_off and stats_on == stats_off
    names = [e.name for e in prof.events()]
    assert names.count("serve.step") == steps
    assert names.count("serve.prefill") == stats_on["prefill_calls"]
    assert len(_by_name(spans.recorded())["serve.step"]) == steps


# ---------------------------------------------------------------------------
# the training loop


def _train_loop():
    cfg = get_config("qwen2-0.5b").reduced()
    tokens = markov_tokens(4_000, vocab=cfg.vocab_size, seed=0)
    tc = ttrain.TrainConfig(mode="masked", optimizer="sgd", lr=0.1,
                            remat_policy="none")
    return tloop.TrainLoop(cfg, tc, lm_batches(tokens, 4, 16, seed=1),
                           n_agents=4, r=1,
                           oracle=tloop.StragglerOracle(4, 1, seed=2),
                           max_pos=64, device="cpu")


def test_train_loop_spans_each_step_and_changes_nothing():
    off = _train_loop().run(3)
    assert spans.recorded() == []
    spans.start()
    on = _train_loop().run(3)
    spans.stop()
    assert on.loss == off.loss and on.grad_norm == off.grad_norm
    rec = spans.recorded()
    ids = {s.id: s for s in rec}
    got = _by_name(rec)
    assert len(got["train.step"]) == 3
    assert all(s.parent is None for s in got["train.step"])
    for name in ("train.feed", "train.grad", "train.update", "train.sync"):
        assert len(got[name]) == 3, name
        assert {ids[s.parent].name for s in got[name]} == {"train.step"}
        for s in got[name]:
            p = ids[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    for step in got["train.step"]:
        kids = sorted((s for s in rec if s.parent == step.id),
                      key=lambda s: s.t0_ns)
        assert [s.name for s in kids] == ["train.feed", "train.grad",
                                          "train.update", "train.sync"]
    assert "train.ckpt" not in got
    assert all(s.device_ms is None for s in rec)
    periods = got["train.grad.period"]
    assert len(periods) == 3 * get_config("qwen2-0.5b").reduced().n_periods
    assert {ids[s.parent].name for s in periods} == {"train.grad"}


def test_train_loop_checkpoint_is_a_span(tmp_path):
    cfg = get_config("qwen2-0.5b").reduced()
    tokens = markov_tokens(4_000, vocab=cfg.vocab_size, seed=0)
    tc = ttrain.TrainConfig(mode="masked", optimizer="sgd", lr=0.1,
                            remat_policy="none")
    loop = tloop.TrainLoop(cfg, tc, lm_batches(tokens, 4, 16, seed=1),
                           n_agents=4, r=1, ckpt_dir=str(tmp_path),
                           ckpt_every=2, max_pos=64, device="cpu")
    spans.start()
    loop.run(3)
    spans.stop()
    got = _by_name(spans.recorded())
    ids = {s.id: s for s in spans.recorded()}
    # the save at step 2 inside its step, the blocking one after the run
    assert [s.parent is None or ids[s.parent].name
            for s in got["train.ckpt"]] == ["train.step", True]


def test_nothing_records_without_a_profiler_or_start(qwen):
    _serve(qwen, 8, "on")
    _train_loop().run(2)
    assert spans.recorded() == [] and spans.dropped() == 0


# ---------------------------------------------------------------------------
# on the card


@needs_cuda
def test_device_times_on_the_card_and_no_device_event_named_by_a_span():
    """A device-timed span resolves a device time covering its kernels,
    and under the profiler no device event carries a span's name: the
    ranges are not user annotations, which the profiler would mirror on
    the device as busy spans."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.span("card.outer", device=True):
            for _ in range(4):
                x = x @ x
                x = x / x.norm()
            with spans.span("card.inner", device=True):
                float(x.sum())
    got = {s.name: s for s in spans.recorded()}
    assert got["card.outer"].device_ms > 0
    assert 0 < got["card.inner"].device_ms <= got["card.outer"].device_ms
    dev = {e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"card.outer", "card.inner"} <= host
    assert not dev & {"card.outer", "card.inner"}, dev
