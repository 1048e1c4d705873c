"""The readers of the program's spans on hand-built spans and a
hand-built ``Tracer`` (CPU): each returns the number computed by hand,
and None where its spans are absent or the program records none."""
import sys

import pytest

import spec
from devtrace import Tracer
from repro_torch import spans

SERVE = {"kind": "serve"}
TRAIN = {"kind": "train"}


def _span(name, t0_ns, t1_ns, device_ms=None, rid=None, **counts):
    s = spans.Span(name, rid, counts)
    s.t0_ns, s.t1_ns, s.device_ms = t0_ns, t1_ns, device_ms
    return s


@pytest.fixture
def kept(monkeypatch):
    """Make ``spans.recorded()`` return the list this fixture gives."""
    got = []
    monkeypatch.setattr(spans, "recorded", lambda: list(got))
    return got


def _tracer(host, dev, window_s=1.0):
    tr = Tracer()
    tr.host, tr.dev, tr.window_s = sorted(host), sorted(dev), window_s
    return tr


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx, {})


def test_queue_wait_is_the_median_wait(kept):
    kept += [_span("serve.queued", 0, 4_000_000, rid=0),
             _span("serve.queued", 10, 1_000_010, rid=1),
             _span("serve.queued", 5, 9_000_005, rid=2),
             _span("serve.step", 0, 50_000_000)]
    assert _read("queue_wait_ms.serve", SERVE) == pytest.approx(4.0)
    assert _read("queue_wait_ms.serve", TRAIN) is None


def test_prefill_device_time_per_token(kept):
    kept += [_span("serve.prefill", 0, 9, tokens=1000),
             _span("serve.prefill", 0, 9, tokens=3000)]
    # profiler us: two prefill ranges; the first runs kernels 10-30 and
    # 25-40 (30 us of union), the second 110-150 and a copy that starts
    # at 195 and ends after it (50 us); the card's 60-90 lies outside
    # both, and the 300-400 kernel starts after the second range ended
    host = [(0, 50, "serve.prefill"), (100, 200, "serve.prefill"),
            (60, 95, "serve.superstep")]
    dev = [(10, 30, "a"), (25, 40, "b"), (60, 90, "c"), (110, 150, "d"),
           (195, 200 + 5, "copy"), (300, 400, "e")]
    ctx = dict(SERVE, tracer=_tracer(host, dev))
    # 80 us over 4,000 tokens
    assert _read("prefill_us_per_token.serve", ctx) == pytest.approx(0.02)


def test_decode_device_time_per_decode_step(kept):
    kept += [_span("serve.superstep", 0, 9, k=1),
             _span("serve.superstep", 0, 9, k=4),
             _span("serve.prefill", 0, 9, tokens=10)]
    # a superstep of 1 decode busy 40 of its 100 us, one of 4 busy 110
    # (two kernels overlapping by 10) of its 1,000 us; a prefill's
    # kernel between them is not the decode's
    host = [(0, 100, "serve.superstep"), (150, 180, "serve.prefill"),
            (200, 1200, "serve.superstep")]
    dev = [(20, 60, "k"), (150, 170, "p"), (300, 370, "k"),
           (360, 410, "k")]
    ctx = dict(SERVE, tracer=_tracer(host, dev))
    # 150 us over 5 decode steps
    assert _read("decode_ms_per_step.serve", ctx) == pytest.approx(0.03)
    assert _read("decodes_per_superstep.serve", SERVE) == pytest.approx(2.5)
    assert _read("decode_ms_per_step.serve", dict(SERVE)) is None


def test_update_is_the_median_update(kept):
    kept += [_span("train.update", 0, 9, device_ms=v) for v in (7.0, 5.0, 6.5)]
    kept += [_span("train.grad", 0, 9)]
    assert _read("update_ms.train", TRAIN) == pytest.approx(6.5)
    assert _read("update_ms.train", SERVE) is None


def _ranged(ctx):
    """``ctx`` with a trace that holds a range of every serving span."""
    host = [(0, 10, n) for n in ("serve.prefill", "serve.superstep")]
    return dict(ctx, tracer=_tracer(host, [(1, 2, "k")]))


@pytest.mark.parametrize("name,ctx", [
    ("queue_wait_ms.serve", SERVE),
    ("prefill_us_per_token.serve", _ranged(SERVE)),
    ("decode_ms_per_step.serve", _ranged(SERVE)),
    ("decodes_per_superstep.serve", SERVE),
    ("update_ms.train", TRAIN)])
def test_span_readers_give_none_without_their_spans(name, ctx, kept,
                                                    monkeypatch):
    assert _read(name, ctx) is None                  # no spans kept
    kept += [_span("other", 0, 1)]
    assert _read(name, ctx) is None                  # none of its name
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _read(name, ctx) is None                  # a program without spans


def test_device_readers_give_none_on_host_only_spans(kept):
    """The program's spans without the trace's ranges of them (or, for
    the update, without CUDA events) give no device time."""
    kept += [_span("serve.prefill", 0, 9, tokens=10),
             _span("serve.superstep", 0, 9, k=2),
             _span("train.update", 0, 9)]
    bare = dict(SERVE, tracer=_tracer([(0, 10, "serve.step")], [(1, 2, "k")]))
    for ctx in (SERVE, bare):
        assert _read("prefill_us_per_token.serve", ctx) is None
        assert _read("decode_ms_per_step.serve", ctx) is None
    assert _read("update_ms.train", TRAIN) is None


def test_engine_host_idle_share_by_hand():
    # profiler us over a 1 s window: the step 0-500k holds a sync
    # 300k-400k; the card runs 100k-200k and 350k-450k, and 600k-700k
    # outside the step. Idle in the step, outside the sync: 0-100k,
    # 200k-300k, 450k-500k = 250k us; the client loop's 500k-1M is not
    # the engine's.
    host = [(0, 500_000, "serve.step"), (10_000, 90_000, "serve.admit"),
            (300_000, 400_000, "serve.sync"),
            (310_000, 390_000, "aten::copy_"),
            (520_000, 560_000, "aten::mm")]
    dev = [(100_000, 150_000, "k1"), (120_000, 200_000, "k2"),
           (350_000, 450_000, "k3"), (600_000, 700_000, "k4")]
    ctx = dict(SERVE, tracer=_tracer(host, dev))
    assert _read("engine_host_idle_share.serve", ctx) == pytest.approx(25.0)
    # two steps, a kernel across their boundary, a half-second window
    host = [(0, 100, "serve.step"), (100, 300, "serve.step"),
            (250, 280, "serve.sync")]
    dev = [(50, 150, "k")]
    ctx = dict(SERVE, tracer=_tracer(host, dev, window_s=500e-6))
    # idle in the steps outside the sync: 0-50, 150-250, 280-300
    assert _read("engine_host_idle_share.serve", ctx) == pytest.approx(34.0)


def test_engine_host_idle_share_none_without_steps():
    ctx = dict(SERVE, tracer=_tracer([(0, 10, "aten::mm")], [(0, 5, "k")]))
    assert _read("engine_host_idle_share.serve", ctx) is None
    assert _read("engine_host_idle_share.serve", dict(SERVE)) is None
    ctx = dict(TRAIN, tracer=_tracer([(0, 10, "serve.step")], []))
    assert _read("engine_host_idle_share.serve", ctx) is None
