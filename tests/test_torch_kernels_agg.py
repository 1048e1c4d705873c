"""Port parity for the aggregation kernels: the plain torch forms of
``repro_torch.kernels.agg`` and the ``ops`` dispatchers against the JAX
Pallas kernels run in interpret mode, over ``test_kernels_agg.SWEEP``
(P not a tile multiple included), plus every registry device twin
against the JAX reference rule. The CUDA kernels themselves are held
against these plain forms on the card (``test_torch_kernels_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradagg as jg
from repro.dist import registry as jreg
from repro.kernels import agg as jagg
from repro_torch.core import gradagg as tg
from repro_torch.dist import registry as treg
from repro_torch.kernels import agg as tagg
from repro_torch.kernels import ops

SWEEP = [(8, 2048, 2048), (20, 4096, 1024), (6, 5000, 2048), (3, 1000, 512)]
TOL = dict(rtol=2e-4, atol=2e-4)


def _stack(n, p, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    received = rng.random(n) > 0.3
    return g, received


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


@pytest.mark.parametrize("n,p,tile", SWEEP)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_masked_cge_matches_pallas(n, p, tile, f):
    g, rx = _stack(n, p, seed=f)
    ref = np.asarray(jagg.masked_cge_reduce(jnp.asarray(g), jnp.asarray(rx),
                                            f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    np.testing.assert_allclose(tagg.masked_cge_dot(tgt, trx, f).numpy(),
                               ref, **TOL)
    np.testing.assert_allclose(ops.masked_cge_reduce(tgt, trx, f=f).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("n,p,tile", SWEEP)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_trimmed_mean_matches_pallas(n, p, tile, f):
    g, rx = _stack(n, p, seed=10 + f)
    ref = np.asarray(jagg.trimmed_mean_tiled(jnp.asarray(g), jnp.asarray(rx),
                                             f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    np.testing.assert_allclose(
        tagg.trimmed_mean_running(tgt, trx, f).numpy(), ref, **TOL)
    np.testing.assert_allclose(
        ops.trimmed_mean_tiled(tgt, trx, f=f).numpy(), ref, **TOL)


@pytest.mark.parametrize("n,p,tile", SWEEP)
def test_dequant_accum_matches_pallas(n, p, tile):
    g, rx = _stack(n, p, seed=20)
    qj, sj = jg.quantize_int8_parts(jnp.asarray(g))
    ref = np.asarray(jagg.dequant_accum(qj, sj[:, 0], jnp.asarray(rx),
                                        tile=tile, interpret=True))
    q, s = np.asarray(qj), np.asarray(sj)[:, 0]
    tq, ts, trx = _t(q, s, rx)
    np.testing.assert_allclose(tagg.dequant_dot(tq, ts, trx).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.dequant_accum(tq, ts, trx).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def _split_tie(p):
    """Seven rows, four of one norm with different contents (sign flips
    of one row square to the same values, so the norms tie exactly) and
    f=3: the keep-set of m-f=4 takes the smaller row and three of the
    four tied rows, so the id tie-break decides which tied row goes."""
    rng = np.random.default_rng(6)
    row = rng.normal(size=p).astype(np.float32)
    s1, s2 = np.where(rng.random((2, p)) < 0.5, -1.0, 1.0).astype(np.float32)
    g = np.stack([row * 0.5, row, -row, row * 2.0, row * s1, row * 3.0,
                  row * s2])
    return g, np.ones(7, bool), 3


@pytest.mark.parametrize("case", ["all_crashed", "m_minus_f_nonpositive",
                                  "ties", "duplicates"])
def test_edge_cases_match_pallas(case):
    g, _ = _stack(6, 1500, seed=4)
    f = 1
    if case == "all_crashed":
        rx = np.zeros(6, bool)
    elif case == "m_minus_f_nonpositive":
        rx, f = np.array([True, True] + [False] * 4), 3
    elif case == "ties":
        g, rx, f = _split_tie(1500)
    else:
        g = np.repeat(np.array([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                               np.float32), 1500, axis=1)
        rx = np.array([True, True, True, True, False, True])
    tgt, trx = _t(g, rx)
    for jk, tk in ((jagg.masked_cge_reduce, ops.masked_cge_reduce),
                   (jagg.trimmed_mean_tiled, ops.trimmed_mean_tiled)):
        ref = np.asarray(jk(jnp.asarray(g), jnp.asarray(rx), f, tile=512,
                            interpret=True))
        np.testing.assert_allclose(tk(tgt, trx, f=f).numpy(), ref,
                                   rtol=1e-6, atol=1e-6, err_msg=tk.__name__)


@pytest.mark.parametrize("impl", ["ref", "plain", "auto"])
def test_ops_impls_agree_on_cpu(impl):
    g, rx = _stack(7, 3333, seed=7)
    tgt, trx = _t(g, rx)
    for f in (0, 2):
        np.testing.assert_allclose(
            ops.masked_cge_reduce(tgt, trx, f=f, impl=impl).numpy(),
            np.asarray(jg.agg_cge(jnp.asarray(g), jnp.asarray(rx), f)), **TOL)
        np.testing.assert_allclose(
            ops.trimmed_mean_tiled(tgt, trx, f=f, impl=impl).numpy(),
            np.asarray(jg.agg_trimmed_mean(jnp.asarray(g), jnp.asarray(rx),
                                           f)), **TOL)
    q, s = tg.quantize_int8_parts(tgt)
    np.testing.assert_allclose(
        ops.dequant_accum(q, s[:, 0], trx, impl=impl).numpy(),
        np.asarray(jg.agg_quantized(jnp.asarray(g), jnp.asarray(rx))),
        rtol=1e-5, atol=1e-5)


def test_ops_rejects_cuda_impl_on_cpu_and_unknown_impl():
    tgt, trx = _t(*_stack(4, 100))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.masked_cge_reduce(tgt, trx, f=1, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.trimmed_mean_tiled(tgt, trx, f=1, impl="interpret")


def test_cpu_wrappers_launch_nothing():
    """On the CPU ``auto`` takes the plain forms and launches nothing; the
    wrappers themselves only launch, so a CPU tensor makes them raise."""
    tagg.reset_launches()
    tgt, trx = _t(*_stack(5, 300))
    q, s = tg.quantize_int8_parts(tgt)
    ops.masked_cge_reduce(tgt, trx, f=1)
    ops.trimmed_mean_tiled(tgt, trx, f=1)
    ops.dequant_accum(q, s[:, 0], trx)
    for call in (lambda: tagg.masked_cge_reduce(tgt, trx, 1),
                 lambda: tagg.trimmed_mean_tiled(tgt, trx, 1),
                 lambda: tagg.dequant_accum(q, s[:, 0], trx)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(tagg.LAUNCHES.values()) == {0}


def test_bind_device_every_rule_matches_jax_reference():
    g, rx = _stack(9, 2500, seed=8)
    tgt, trx = _t(g, rx)
    for name in treg.rule_names():
        ref = jreg.get_rule(name).bind_reference(f=1)(jnp.asarray(g),
                                                      jnp.asarray(rx))
        out = treg.get_rule(name).bind_device(f=1)(tgt, trx)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the CUDA kernels' plans, and torch mirrors of the kernels that follow them

H100_SMS = 132
PLAN_SHAPES = ([(n, p) for n, p, _ in SWEEP]
               + [(3, 1), (7, 3001), (7, 4097), (20, 431_080),
                  (20, 1_000_003), (64, 4097), (4096, 431_080)])


def _received_counts(n):
    return sorted({m for m in range(min(n, 20) + 1)} | {n, n // 2, 1})


def _check_segments(p, starts, widths, rows, strides):
    """Every (row, segment) split as the kernels split it, for every base
    word offset of the tensor: the bulk part 16-byte aligned in device
    memory and in shared memory, a multiple of 16 bytes, the plain edges
    shorter than a 16-byte line."""
    assert (np.asarray(starts) % 4 == 0).all()  # a row's offset is the same
    # per chunk, so a segment's split depends on its width alone
    w = np.unique(np.asarray(widths))[:, None, None]
    c = np.zeros_like(w)
    r = np.asarray(rows)[None, :, None]
    j = np.arange(len(rows))[None, :, None]
    base = np.arange(4)[None, None, :]
    shift = tagg.row_shift(base, r, p, c)
    head, bulk, tail = tagg.row_segments(shift, w)
    assert (head + bulk + tail == w).all()
    assert (head <= 3).all() and (tail <= 3).all() and (bulk % 4 == 0).all()
    live = bulk > 0
    assert ((base + r * p + c + head) % 4 == 0)[live].all()
    for stride in strides:
        assert stride % 4 == 0
        assert ((j * stride + shift + head) % 4 == 0)[live].all()


@pytest.mark.parametrize("n,p", PLAN_SHAPES)
def test_cge_plan_covers_holds_and_aligns(n, p):
    plan = tagg.cge_plan(n, p, H100_SMS)
    assert plan.grid <= H100_SMS and plan.share % 4 == 0
    assert plan.chunk % 4 == 0 and tagg.cge_header(n) % 16 == 0
    assert plan.smem_bytes <= tagg.SMEM_LIMIT
    starts = np.arange(plan.grid) * plan.share
    widths = np.minimum(plan.share, p - starts)
    assert (widths > 0).all() and widths.sum() == p     # [0, P) once
    assert (starts[1:] == starts[:-1] + widths[:-1]).all()
    rows = np.arange(0, n, max(1, n // 24))
    for m in _received_counts(n):
        h = plan.held[m]
        assert h % 4 == 0 and 0 <= h <= plan.share
        if m == 0:
            continue
        # the kernel's own integer arithmetic (csrc/agg.cu, hb)
        assert min(max(0, (plan.budget // (4 * m) - 4) & ~3), plan.share) == h
        if h:
            assert tagg.cge_header(n) + m * (h + 4) * 4 <= plan.smem_bytes
        cs, ws, reread = [], [], 0
        for c0, sb in zip(starts, widths):
            hb = min(h, sb)
            chunks = [(c0 + k, min(plan.chunk, hb - k))
                      for k in range(0, hb, plan.chunk)]
            assert len(chunks) <= tagg.CGE_CHUNKS
            held = np.concatenate([np.arange(a, a + w) for a, w in chunks]
                                  or [np.zeros(0, int)])
            again = np.arange(c0 + hb, c0 + sb)
            assert np.array_equal(np.sort(np.concatenate([held, again])),
                                  np.arange(c0, c0 + sb))
            assert len(np.intersect1d(held, again)) == 0
            reread += len(again)
            cs += [a for a, _ in chunks]
            ws += [w for _, w in chunks]
        assert reread == sum(max(0, sb - h) for sb in widths)
        if cs:
            _check_segments(p, cs, ws, rows[rows < m], [h + 4])
    if (n, p) == (20, 431_080):         # the paper's shape: read once
        assert plan.held[17] == plan.share and plan.grid == H100_SMS
    if (n, p) == (20, 1_000_003):       # the check shape re-reads
        assert plan.held[20] < plan.share


@pytest.mark.parametrize("n,p", PLAN_SHAPES + [(32, 431_080)])
def test_trimmed_plan_covers_stages_and_aligns(n, p):
    plan = tagg.trimmed_plan(n, p, H100_SMS)
    header = tagg.trimmed_header(n)
    assert plan.grid <= H100_SMS and plan.share % 4 == 0
    assert plan.chunk % 4 == 0 and 1 <= plan.stages <= tagg.TRIM_STAGES
    assert plan.smem_bytes == (header
                               + plan.stages * n * (plan.chunk + 4) * 4)
    assert plan.smem_bytes <= tagg.SMEM_LIMIT and header % 16 == 0
    starts = np.arange(plan.grid) * plan.share
    widths = np.minimum(plan.share, p - starts)
    assert (widths > 0).all() and widths.sum() == p
    cs, ws = [], []
    for c0, sb in zip(starts, widths):
        cs += list(range(c0, c0 + sb, plan.chunk))
        ws += [min(plan.chunk, c0 + sb - c) for c in cs[len(ws):]]
    assert sum(ws) == p
    _check_segments(p, cs, ws, np.arange(n), [plan.chunk + 4])
    two_fit = header + 2 * n * 8 * 4 <= tagg.SMEM_LIMIT
    if p >= 4 * H100_SMS * 4 and two_fit:
        assert plan.stages >= 2         # a chunk in flight while one is read


def _cge_mirror(g, rx, f, n_sm):
    """The one-launch CGE as the kernel runs it, in torch: per-share
    partial squared norms in plan order, their sums in block order, the
    rank keep-set, then the kept rows summed per column in agent order.
    Returns (out, keep)."""
    n, p = g.shape
    plan = tagg.cge_plan(n, p, n_sm)
    rows = torch.nonzero(rx).flatten()
    m = len(rows)
    keep = torch.zeros(n, dtype=torch.bool)
    out = torch.zeros(p)
    if m - f <= 0:
        return out, keep
    partial = torch.stack([(g[rows, c0:c0 + plan.share] ** 2).sum(1)
                           for c0 in range(0, p, plan.share)], 1)
    tot = torch.zeros(m)
    for b in range(plan.grid):
        tot = tot + partial[:, b]
    key = torch.full((n,), float("inf"))
    key[rows] = torch.sqrt(tot)
    ids = torch.arange(n)
    before = (key[None, :] < key[:, None]) | (
        (key[None, :] == key[:, None]) & (ids[None, :] < ids[:, None]))
    keep = rx & (before.sum(1) < m - f)
    for i in torch.nonzero(keep).flatten():
        out = out + g[i]
    return out, keep


def _cge_case(case):
    g, _ = _stack(6, 1500, seed=4)
    f = 1
    if case == "all_crashed":
        rx = np.zeros(6, bool)
    elif case == "m_minus_f_nonpositive":
        rx, f = np.array([True, True] + [False] * 4), 3
    elif case == "ties":
        g, rx, f = _split_tie(1500)
    else:
        g = np.repeat(np.array([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                               np.float32), 1500, axis=1)
        rx = np.array([True, True, True, True, False, True])
    return g, rx, f


@pytest.mark.parametrize("shape", SWEEP + ["all_crashed",
                                           "m_minus_f_nonpositive", "ties",
                                           "duplicates"], ids=str)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_one_launch_cge_mirror_matches_pallas_and_plain(shape, f):
    if isinstance(shape, str):
        g, rx, f = _cge_case(shape)
        tile, tol = 512, dict(rtol=1e-6, atol=1e-6)
    else:
        n, p, tile = shape
        g, rx = _stack(n, p, seed=f)
        tol = TOL
    ref = np.asarray(jagg.masked_cge_reduce(jnp.asarray(g), jnp.asarray(rx),
                                            f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    for n_sm in (H100_SMS, 5):
        out, keep = _cge_mirror(tgt, trx, f, n_sm)
        np.testing.assert_allclose(out.numpy(), ref, **tol)
        np.testing.assert_allclose(out.numpy(),
                                   tagg.masked_cge_dot(tgt, trx, f).numpy(),
                                   **tol)
        if isinstance(shape, str):      # the keep-set equal, not close
            want = tg.cge_mask_from_norms(tagg.row_norms(tgt), trx, f)
            assert torch.equal(keep, want.to(torch.bool)), shape
        if shape == "all_crashed":
            assert not out.any()


def _trimmed_mirror(g, rx, f, n_sm):
    """The chunked trimmed mean as the kernel runs it, in torch: each
    block's share in plan chunks, the received rows compacted in agent
    order, their sum, f rounds of min/max extraction, the mean."""
    n, p = g.shape
    plan = tagg.trimmed_plan(n, p, n_sm)
    rows = torch.nonzero(rx).flatten()
    cnt = len(rows) - 2 * f
    out = torch.zeros(p)
    if cnt <= 0:
        return out
    for c0 in range(0, p, plan.share):
        end = min(c0 + plan.share, p)
        for c in range(c0, end, plan.chunk):
            x = g[rows, c:min(c + plan.chunk, end)]
            ssum = torch.zeros(x.shape[1])
            for row in x:
                ssum = ssum + row
            out[c:c + x.shape[1]] = (ssum - tagg._running_cut(x, x, f)) / cnt
    return out


@pytest.mark.parametrize("n,p,tile", SWEEP)
@pytest.mark.parametrize("f", [0, 1, 2])
def test_chunked_trimmed_mirror_matches_pallas(n, p, tile, f):
    g, rx = _stack(n, p, seed=10 + f)
    ref = np.asarray(jagg.trimmed_mean_tiled(jnp.asarray(g), jnp.asarray(rx),
                                             f, tile=tile, interpret=True))
    tgt, trx = _t(g, rx)
    for n_sm in (H100_SMS, 3):
        np.testing.assert_allclose(_trimmed_mirror(tgt, trx, f, n_sm).numpy(),
                                   ref, **TOL)


# ---------------------------------------------------------------------------
# any number of agents: the plans past the shared-memory sizes, the f >= 2
# rounds at any m, and dequant_accum's load widths and column walk


@pytest.mark.parametrize("n", [33, 64, 4096, 5806, 5807, 16_384])
def test_trimmed_plan_any_agents(n):
    """Two stages while they fit, then one stage of at least 4 columns
    (n = 4096: 8), then no ring where not even that fits beside the
    header: the consumers read the rows from device memory."""
    p = 431_080
    plan = tagg.trimmed_plan(n, p, H100_SMS)
    header = tagg.trimmed_header(n)
    starts = np.arange(plan.grid) * plan.share
    widths = np.minimum(plan.share, p - starts)
    assert (widths > 0).all() and widths.sum() == p
    assert plan.smem_bytes <= tagg.SMEM_LIMIT
    one_fits = header + n * 8 * 4 <= tagg.SMEM_LIMIT
    two_fit = header + 2 * n * 8 * 4 <= tagg.SMEM_LIMIT
    if not one_fits:                    # rows straight from device memory
        assert plan.stages == 0 and plan.smem_bytes == tagg.SMEM_HEADER
        assert n > 5806
        return
    assert plan.chunk >= 4 and plan.chunk % 4 == 0
    assert plan.smem_bytes == header + plan.stages * n * (plan.chunk + 4) * 4
    assert plan.stages >= 1
    if not two_fit:
        assert plan.stages == 1
    if n == 4096:
        assert plan.stages == 1 and plan.chunk == 8
    if n <= 64:
        assert plan.stages >= 2


@pytest.mark.parametrize("n,p", [(4096, 20_000), (4466, 20_000),
                                 (4467, 20_000), (16_384, 20_000),
                                 (100_000, 431_080)])
def test_cge_plan_moves_lists_to_a_workspace(n, p):
    """Past about 4,460 agents the five per-agent lists leave no room for
    4 columns of every row: they move to a device workspace and shared
    memory holds rows only, so any n has a plan within the limit."""
    plan = tagg.cge_plan(n, p, H100_SMS)
    assert plan.workspace == (n > 4466)
    assert plan.header == (tagg.SMEM_HEADER if plan.workspace
                           else tagg.cge_header(n))
    assert plan.budget == tagg.SMEM_LIMIT - plan.header
    assert plan.smem_bytes <= tagg.SMEM_LIMIT
    for m in sorted({1, 17, n // 2, n}):
        h = plan.held[m]
        assert h % 4 == 0 and 0 <= h <= plan.share
        assert min(max(0, (plan.budget // (4 * m) - 4) & ~3), plan.share) == h
        if h:
            assert plan.header + m * (h + 4) * 4 <= plan.smem_bytes


def _widen(q):
    """int8 -> f32 as the kernel widens a byte: b ^ 0x80 = b + 128 in the
    low mantissa bits of 2^23, then 2^23 + 128 off again."""
    u = (q.to(torch.int32) & 0xFF) ^ 0x80
    return (u | 0x4B000000).view(torch.float32) - 8388736.0


def test_dequant_widening_is_exact():
    b = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(_widen(b), b.to(torch.float32))


@pytest.mark.parametrize("p", [431_080, 4097, 1, 1_000_003])
@pytest.mark.parametrize("base", [0, 1, 4, 8])
def test_dequant_plan_widths_and_coverage(p, base):
    for n in (1, 20, 4097):
        plan = tagg.dequant_plan(n, p, base, H100_SMS)
        ok = [v for v in (16, 8, 4, 1)
              if base % v == 0 and (n == 1 or p % v == 0)]
        assert plan.vec == ok[0] and plan.cols == max(plan.vec, 4)
        rows = np.arange(min(n, 64))
        # every row's loads aligned: a thread's columns start at a
        # multiple of cols, itself a multiple of vec
        assert ((base + rows * p) % plan.vec == 0).all()
        assert plan.share % plan.cols == 0
        assert plan.grid <= H100_SMS * tagg.DQ_BLOCKS_PER_SM
        starts = np.arange(plan.grid) * plan.share
        widths = np.minimum(plan.share, p - starts)
        assert (widths > 0).all() and widths.sum() == p     # [0, P) once
        # balanced: the blocks a card holds at once, each with at least a
        # warp's worth of columns, none more than one group past its part
        groups = -(-p // plan.cols)
        target = min(H100_SMS * tagg.DQ_BLOCKS_PER_SM, -(-groups // 32))
        assert plan.share <= plan.cols * -(-groups // target)
    if base == 0:
        assert tagg.dequant_plan(20, p, 0, H100_SMS).vec == {
            431_080: 8, 4097: 1, 1: 1, 1_000_003: 1}[p]


def _dequant_mirror(q, scale, rx, base=0, n_sm=H100_SMS):
    """dequant_accum as the kernel walks it, in torch: each block of the
    plan takes its columns, lists the received agents DQ_THREADS at a time
    in agent order with their scales, and adds each listed row, widened
    by the kernel's bit trick, times its scale, in that order."""
    n, p = q.shape
    plan = tagg.dequant_plan(n, p, base, n_sm)
    out = torch.full((p,), float("nan"))
    for b in range(plan.grid):
        lo, hi = b * plan.share, min((b + 1) * plan.share, p)
        acc = torch.zeros(hi - lo)
        for i0 in range(0, n, tagg.DQ_THREADS):
            ids = torch.arange(i0, min(i0 + tagg.DQ_THREADS, n))
            for i in ids[rx[ids]]:
                acc = acc + _widen(q[i, lo:hi]) * scale[i]
        out[lo:hi] = acc
    return out


@pytest.mark.parametrize("n,p,tile", SWEEP + [(200, 3001, 1024)])
def test_dequant_mirror_matches_pallas(n, p, tile):
    """Over SWEEP, and with 200 agents (two batches of the mask walk)."""
    g, rx = _stack(n, p, seed=21)
    qj, sj = jg.quantize_int8_parts(jnp.asarray(g))
    ref = np.asarray(jagg.dequant_accum(qj, sj[:, 0], jnp.asarray(rx),
                                        tile=tile, interpret=True))
    tq, ts, trx = _t(np.asarray(qj), np.asarray(sj)[:, 0], rx)
    for base in (0, 1):
        out = _dequant_mirror(tq, ts, trx, base)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    none = torch.zeros_like(trx)
    assert not _dequant_mirror(tq, ts, none).any()      # exact zeros


def _successor_trimmed(g, rx, f):
    """The kernel's f >= 2 rounds in torch, with no candidate mask: round
    k's minimum is the smallest (value, id) pair lexicographically above
    round k-1's, its maximum the next pair in (value descending, id
    ascending); the received values summed in agent order; cut adds
    mn + mx in round order."""
    x = g[rx]
    m, p = x.shape
    cnt = m - 2 * f
    if cnt <= 0:
        return torch.zeros(p)
    ids = torch.arange(m)[:, None]
    ssum = torch.zeros(p)
    for row in x:
        ssum = ssum + row
    cut = torch.zeros(p)
    cols = torch.arange(p)
    pmn = pmx = None
    for _ in range(f):
        if pmn is None:
            cand_mn = cand_mx = torch.ones_like(x, dtype=torch.bool)
        else:
            cand_mn = (x > pmn) | ((x == pmn) & (ids > imn))
            cand_mx = (x < pmx) | ((x == pmx) & (ids > imx))
        vmn = torch.where(cand_mn, x, float("inf")).amin(0)
        imn = torch.where(cand_mn & (x == vmn), ids, m).amin(0)
        vmx = torch.where(cand_mx, x, float("-inf")).amax(0)
        imx = torch.where(cand_mx & (x == vmx), ids, m).amin(0)
        pmn, pmx = x[imn, cols], x[imx, cols]    # the element itself (+-0)
        cut = cut + (pmn + pmx)
    return (ssum - cut) / cnt


@pytest.mark.parametrize("n", [33, 64])
@pytest.mark.parametrize("f", [0, 1, 2, 3])
def test_successor_rounds_match_pallas(n, f):
    """Past 32 agents, with exact duplicates (small integers, one column
    all equal) and +-0 mixed in a column: the successor rounds remove the
    same occurrences as the reference's sentinel rounds."""
    g, rx = _stack(n, 1500, seed=30 + f)
    rng = np.random.default_rng(n + f)
    g[:, 0] = rng.integers(-2, 3, n)
    g[:, 1] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    g[:5, 1] = [1.5, -1.5, 0.25, -0.0, 0.0]
    g[:, 2] = 7.0
    ref = np.asarray(jagg.trimmed_mean_tiled(jnp.asarray(g), jnp.asarray(rx),
                                             f, tile=512, interpret=True))
    tgt, trx = _t(g, rx)
    out = _successor_trimmed(tgt, trx, f).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out[:3], ref[:3])     # exact on the ties
    np.testing.assert_allclose(
        out, tagg.trimmed_mean_running(tgt, trx, f).numpy(), **TOL)
