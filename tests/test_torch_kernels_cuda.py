"""The CUDA kernels against their plain torch forms on the card: the
aggregation kernels at the paper's shape (n=20, P=431,080), at ragged P,
at the shape whose CGE share does not fit on chip (n=20, P=1,000,003,
every row received), from a misaligned base, with 33 to 16,384 agents
(the trimmed mean's one-stage ring and rows read from device memory,
CGE's per-agent lists in a device workspace, dequant_accum's batched
mask walk, from bases misaligned by 1, 4 and 8 bytes), on the edge cases
(exact zeros where every agent crashed) and run to run bit-identical;
the
paged flash-decode at the serving shapes of qwen2-0.5b, qwen2-1.5b,
yi-6b, jamba, qwen2-vl-2b and arctic (those three run to run identical),
Dv != D, PS = 128 and Pmax = 1, in f32 and bf16, with kv_len = 0, -1 table entries and page-boundary lengths;
the decode's split-K over a 4096-token table (lengths of one token, one
split, one split plus one) and its run-to-run identical output; flash
attention over the cases of ``kernels/cases.py`` (the JAX test shapes,
ragged S = T = 100, T = 2 S under the top-left causal mask, Dv != D,
inputs scaled x8, 4096 tokens, D = 192, D = Dv = 256, D = 72 with Dv =
40, S > T), causal and not, in f32 and bf16, and the bf16 kernel's
run-to-run identical output; the CGE squared norms (run to run
identical) and masked scaling (bit for bit) over the JAX sweep and ragged
or misaligned rows; the wrappers' launch counts and input checks; the
engines on the card against the same engines on the CPU; and the
simulator's shapes: CGE at n = 8, P <= 4 (f = 2, a large-norm row), the
decode at the e2e harness's 8-token pages, ``run_train`` of registered
scenarios and a 4-replica ``run_e2e`` on the card against the CPU. Every test here needs a GPU and
skips without one, and the file imports no JAX: on the GPU machine run
``python -m pytest -q tests/test_torch_kernels_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import gradagg as tg
from repro_torch.kernels import agg as tagg
from repro_torch.kernels import cge_norms as tcn
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.cases import (CGE_SHAPES, FLASH_CASES, FLASH_TOL,
                                       NORM_TOL)

# the CUDA kernel vs its plain form on the same card: agent-order f32 sums
# against torch's reduction order, a few ulps of values of order 10
CUDA_TOL = dict(rtol=2e-5, atol=2e-5)

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: runs on a GPU only")


def _stack(n, p, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    received = rng.random(n) > 0.3
    return g, received


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain form


@needs_cuda
@pytest.mark.parametrize("n,p", [(20, 431_080), (7, 4097), (3, 1),
                                 (20, 1_000_003)])
@pytest.mark.parametrize("f", [0, 1, 2])
def test_cuda_kernels_match_plain(n, p, f):
    g, rx = _stack(n, p, seed=n + f)
    if p == 1_000_003:      # m = 20: a CGE share re-reads what it can't hold
        rx[:] = True
    tgt, trx = _t(g, rx, device="cuda")
    before = dict(tagg.LAUNCHES)
    for kernel, plain in ((tagg.masked_cge_reduce, tagg.masked_cge_dot),
                          (tagg.trimmed_mean_tiled,
                           tagg.trimmed_mean_running)):
        np.testing.assert_allclose(kernel(tgt, trx, f).cpu().numpy(),
                                   plain(tgt, trx, f).cpu().numpy(),
                                   **CUDA_TOL, err_msg=kernel.__name__)
    q, s = tg.quantize_int8_parts(tgt)
    np.testing.assert_allclose(
        tagg.dequant_accum(q, s[:, 0], trx).cpu().numpy(),
        tagg.dequant_dot(q, s[:, 0], trx).cpu().numpy(), **CUDA_TOL)
    torch.cuda.synchronize()
    assert tagg.LAUNCHES["masked_cge_reduce"] == \
        before["masked_cge_reduce"] + 1
    assert tagg.LAUNCHES["trimmed_mean_tiled"] == \
        before["trimmed_mean_tiled"] + 1
    assert tagg.LAUNCHES["dequant_accum"] == before["dequant_accum"] + 1


@needs_cuda
@pytest.mark.parametrize("case", ["all_crashed", "m_minus_f_nonpositive",
                                  "ties", "duplicates"])
def test_cuda_kernels_edge_cases(case):
    g, _ = _stack(6, 3000, seed=4)
    f = 1
    if case == "all_crashed":
        rx = np.zeros(6, bool)
    elif case == "m_minus_f_nonpositive":
        rx, f = np.array([True, True] + [False] * 4), 3
    elif case == "ties":
        # four rows of one norm with different contents, and m - f = 4
        # keeping the smaller row and three of the four: the kernel's id
        # tie-break decides which tied row goes
        rng = np.random.default_rng(6)
        row = rng.normal(size=3000).astype(np.float32)
        s1, s2 = np.where(rng.random((2, 3000)) < 0.5, -1.0,
                          1.0).astype(np.float32)
        g = np.stack([row * 0.5, row, -row, row * 2.0, row * s1, row * 3.0,
                      row * s2])
        rx, f = np.ones(7, bool), 3
    else:
        g = np.repeat(np.array([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                               np.float32), 3000, axis=1)
        rx = np.array([True, True, True, True, False, True])
    tgt, trx = _t(g, rx, device="cuda")
    for kernel, plain in ((tagg.masked_cge_reduce, tagg.masked_cge_dot),
                          (tagg.trimmed_mean_tiled,
                           tagg.trimmed_mean_running)):
        out = kernel(tgt, trx, f)
        np.testing.assert_allclose(out.cpu().numpy(),
                                   plain(tgt, trx, f).cpu().numpy(),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=kernel.__name__)
        if case == "all_crashed":
            assert not out.any(), kernel.__name__


@needs_cuda
@pytest.mark.parametrize("p", [431_080, 4097])
def test_cuda_kernels_misaligned_base(p):
    """A contiguous (n, P) view one float past its storage's start: every
    row starts off its 16-byte line, so each row's edges go by plain
    loads around its bulk copy."""
    g, rx = _stack(20, p, seed=9)
    buf = torch.empty(20 * p + 1, device="cuda")
    buf[1:] = torch.from_numpy(g).reshape(-1).cuda()
    tgt = buf[1:].view(20, p)
    assert tgt.is_contiguous() and tgt.data_ptr() % 16 == 4
    trx = torch.from_numpy(rx).cuda()
    for kernel, plain in ((tagg.masked_cge_reduce, tagg.masked_cge_dot),
                          (tagg.trimmed_mean_tiled,
                           tagg.trimmed_mean_running)):
        np.testing.assert_allclose(kernel(tgt, trx, 1).cpu().numpy(),
                                   plain(tgt, trx, 1).cpu().numpy(),
                                   **CUDA_TOL, err_msg=kernel.__name__)


def _many_tol(m, weights, g64):
    """A sum of m f32 terms in any order is off by about sqrt(m) roundings
    of the sum of the terms' magnitudes (16x margin); a row kept or
    dropped wrongly moves a column by a whole |g|."""
    return 16 * m ** 0.5 * 2.0 ** -24 * (weights.abs() @ g64.abs())


@needs_cuda
def test_cuda_cge_many_agents():
    """n = 4096 agents: a share holds a few columns of each received row
    and re-reads the rest; the keep-set is ranked over every agent."""
    n = 4096
    g, rx = _stack(n, 20_000, seed=5)
    tgt, trx = _t(g, rx, device="cuda")
    m = int(rx.sum())
    plan = tagg.cge_plan(n, 20_000, *tagg.card_limits(tgt.device))
    assert plan.held[m] < plan.share
    out = tagg.masked_cge_reduce(tgt, trx, 100).cpu().double()
    # against an f64 sum over the plain form's keep-set
    keep = tg.cge_mask_from_norms(tagg.row_norms(tgt), trx, 100).cpu()
    g64 = torch.from_numpy(g).double()
    ref = keep.double() @ g64
    assert ((out - ref).abs() <= _many_tol(m, keep.double(), g64)).all()


def _big_stack(n, p, seed):
    """(n, P) f32 rows of per-row scale 0.5-3 and a ~70% received mask,
    drawn on the card (numpy would take tens of seconds at n = 16,384)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((n, p), generator=gen, device="cuda")
    g *= 0.5 + 2.5 * torch.rand((n, 1), generator=gen, device="cuda")
    rx = torch.rand(n, generator=gen, device="cuda") > 0.3
    return g, rx


@needs_cuda
@pytest.mark.parametrize("n", [4097, 16_384])
def test_cuda_cge_any_agents(n):
    """n = 4097 keeps the per-agent lists in shared memory beside a few
    held columns; n = 16,384 moves them to the device workspace and holds
    no column. Both against an f64 sum over the plain keep-set."""
    g, rx = _big_stack(n, 20_000, seed=n)
    m = int(rx.sum())
    plan = tagg.cge_plan(n, 20_000, *tagg.card_limits(g.device))
    assert plan.workspace == (n == 16_384)
    f = m // 10
    out = tagg.masked_cge_reduce(g, rx, f).double()
    keep = tg.cge_mask_from_norms(tagg.row_norms(g), rx, f).double()
    g64 = g.double()
    ref = keep @ g64
    assert ((out - ref).abs() <= _many_tol(m, keep, g64)).all()
    assert tagg.masked_cge_reduce(g, rx, m).abs().max() == 0   # m - f = 0


@needs_cuda
@pytest.mark.parametrize("n", [33, 64, 4097, 16_384])
@pytest.mark.parametrize("f", [0, 1, 2])
def test_cuda_trimmed_mean_any_agents(n, f):
    """Past 32 agents: 33 and 64 through a ring of two stages,
    4097 through one stage of 8 columns, 16,384 with no ring (rows read
    from device memory). The f >= 2 rounds at any m. Up to 64 agents
    against the plain form within CUDA_TOL; thousands against an f64
    sort of the received values."""
    p = 431_080 if n <= 64 else 20_000
    g, rx = _big_stack(n, p, seed=n + f)
    plan = tagg.trimmed_plan(n, p, *tagg.card_limits(g.device))
    assert plan.stages == {33: 2, 64: 2, 4097: 1, 16_384: 0}[n]
    out = tagg.trimmed_mean_tiled(g, rx, f)
    if n <= 64:
        np.testing.assert_allclose(
            out.cpu().numpy(),
            tagg.trimmed_mean_running(g, rx, f).cpu().numpy(), **CUDA_TOL)
        return
    m = int(rx.sum())
    srt = torch.sort(g[rx].double(), dim=0).values
    ref = srt[f:m - f].sum(0) / (m - 2 * f)
    tol = _many_tol(m, torch.ones(m, device="cuda", dtype=torch.float64),
                    g[rx].double()) / (m - 2 * f)
    assert ((out.double() - ref).abs() <= tol).all()


@needs_cuda
@pytest.mark.parametrize("n,p", [(1, 20_003), (20, 431_080), (20, 20_003),
                                 (4097, 20_000), (4097, 20_003),
                                 (16_384, 20_000)])
@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_cuda_dequant_any_agents_and_alignment(n, p, offset):
    """dequant_accum from a base ``offset`` bytes past a 16-byte line, at
    ragged P: every load width of ``dequant_plan`` (16, 8, 4 and 1 bytes)
    and the ragged last columns, with the mask walked in one batch (n <=
    128) or in batches of 128 agents."""
    gen = torch.Generator(device="cuda").manual_seed(n + offset)
    buf = torch.randint(-127, 128, (n * p + 16,), generator=gen,
                        device="cuda", dtype=torch.int8)
    base = buf.data_ptr() % 16
    q = buf[(offset - base) % 16:][:n * p].view(n, p)
    assert q.data_ptr() % 16 == offset and q.is_contiguous()
    scale = torch.rand(n, generator=gen, device="cuda") * 0.1
    rx = torch.rand(n, generator=gen, device="cuda") > 0.3
    rx[0] = True
    plan = tagg.dequant_plan(n, p, offset, tagg.card_limits(q.device)[0])
    aligned = [v for v in (16, 8, 4, 1)
               if offset % v == 0 and (n == 1 or p % v == 0)]
    assert plan.vec == aligned[0]
    before = tagg.LAUNCHES["dequant_accum"]
    out = tagg.dequant_accum(q, scale, rx)
    assert tagg.LAUNCHES["dequant_accum"] == before + 1
    if n <= 20:
        np.testing.assert_allclose(
            out.cpu().numpy(),
            tagg.dequant_dot(q, scale, rx).cpu().numpy(), **CUDA_TOL)
        return
    w = (scale * rx).double()
    q64 = q.double()
    ref = w @ q64
    tol = _many_tol(int(rx.sum()), w, q64)
    assert ((out.double() - ref).abs() <= tol).all()


@needs_cuda
def test_cuda_dequant_paper_shape_zeros_and_identity():
    """At the paper's shape: exact zeros when every agent crashed, and the
    same bits on every call."""
    g, rx = _stack(20, 431_080, seed=3)
    tgt, trx = _t(g, rx, device="cuda")
    q, s = tg.quantize_int8_parts(tgt)
    s = s[:, 0].contiguous()
    none = torch.zeros_like(trx)
    out = tagg.dequant_accum(q, s, none)
    assert out.shape == (431_080,) and not out.any()
    first = tagg.dequant_accum(q, s, trx)
    for _ in range(3):
        assert torch.equal(tagg.dequant_accum(q, s, trx), first)


@needs_cuda
@pytest.mark.parametrize("n,p", [(20, 431_080), (20, 1_000_003)])
def test_cuda_agg_kernels_are_run_to_run_identical(n, p):
    g, rx = _stack(n, p, seed=3)
    tgt, trx = _t(g, rx, device="cuda")
    for kernel in (tagg.masked_cge_reduce, tagg.trimmed_mean_tiled):
        first = kernel(tgt, trx, 1)
        for _ in range(3):
            assert torch.equal(kernel(tgt, trx, 1), first), kernel.__name__
    q, s = tg.quantize_int8_parts(tgt)
    first = tagg.dequant_accum(q, s[:, 0], trx)
    for _ in range(3):
        assert torch.equal(tagg.dequant_accum(q, s[:, 0], trx), first)


@needs_cuda
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_cuda_cge_simulator_shape(p):
    """The simulator's ledger: n = 8 agents, P = dim <= 4 columns, far
    below every tile, f = 2, one Byzantine large-norm row. The kernel
    matches its plain form, never uses a word past the ledger's end (NaNs
    follow it in the same allocation), and is bit-identical run to run."""
    g, rx = _stack(8, p, seed=40 + p)
    g[5] = 1e3
    rx[[2, 5]] = True
    buf = torch.full((8 * p + 64,), float("nan"), device="cuda")
    buf[:8 * p] = torch.from_numpy(g.reshape(-1)).cuda()
    tgt = buf[:8 * p].view(8, p)
    trx = torch.from_numpy(rx).cuda()
    sm, smem = tagg.card_limits(tgt.device)
    plan = tagg.cge_plan(8, p, sm, smem)
    assert (plan.grid, plan.share, plan.held[int(rx.sum())]) == (1, 4, 4)
    before = tagg.LAUNCHES["masked_cge_reduce"]
    out = tagg.masked_cge_reduce(tgt, trx, 2)
    plain = tagg.masked_cge_dot(tgt, trx, 2)
    assert out.shape == (p,) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               **CUDA_TOL)
    assert float(out.abs().max()) < 1e2          # the large row was cut
    for _ in range(3):
        assert torch.equal(tagg.masked_cge_reduce(tgt, trx, 2), out)
    assert tagg.LAUNCHES["masked_cge_reduce"] == before + 4


@needs_cuda
@pytest.mark.parametrize("name,backend", [
    ("byzantine_flip_midrun", "host"), ("byzantine_flip_midrun", "device"),
    ("rolling_restart", "device")])
def test_simulator_on_card_matches_cpu(name, backend):
    """``run_train`` of a registered scenario on the card against the same
    run on the CPU: zero violations, identical discrete trace fields,
    ``loss`` and ``dist`` within the engine suite's tolerances, and on
    the device backend CGE's kernel launched at every iteration."""
    from repro_torch.sim.scenario import get_scenario, run_train
    sc = get_scenario(name)
    before = tagg.LAUNCHES["masked_cge_reduce"]
    gpu = run_train(sc, device="cuda", agg_backend=backend)
    launched = tagg.LAUNCHES["masked_cge_reduce"] - before
    cpu = run_train(sc, device="cpu", agg_backend=backend)
    assert gpu.violations == cpu.violations == []
    for key in ("t", "n_rx", "r", "comm", "stale", "amax"):
        assert [s[key] for s in gpu.trace] == [s[key] for s in cpu.trace]
    assert gpu.hist.bytes_tx == cpu.hist.bytes_tx
    assert (gpu.transport.drops, gpu.transport.dups) == \
        (cpu.transport.drops, cpu.transport.dups)
    np.testing.assert_allclose([s["loss"] for s in gpu.trace],
                               [s["loss"] for s in cpu.trace],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([s["dist"] for s in gpu.trace],
                               [s["dist"] for s in cpu.trace],
                               rtol=1e-3, atol=1e-5)
    if backend == "device" and sc.rule == "cge":
        assert launched >= sc.iters
    else:
        assert launched == 0


@needs_cuda
def test_cuda_wrappers_validate_inputs():
    tgt, trx = _t(*_stack(4, 100), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tagg.masked_cge_reduce(tgt.t().contiguous().t(), trx, 1)
    with pytest.raises(ValueError, match="bool"):
        tagg.trimmed_mean_tiled(tgt, trx.float(), 1)
    with pytest.raises(ValueError, match="scale"):
        tagg.dequant_accum(torch.zeros((4, 8), dtype=torch.int8,
                                       device="cuda"), torch.ones(3,
                                                                 device="cuda"),
                           trx)
    # no agent: nothing to read, zeros of length P and no launch
    before = dict(tagg.LAUNCHES)
    none = torch.zeros(0, dtype=torch.bool, device="cuda")
    empty = torch.zeros((0, 5), device="cuda")
    assert not tagg.masked_cge_reduce(empty, none, 1).any()
    assert tagg.trimmed_mean_tiled(empty, none, 0).shape == (5,)
    assert not tagg.dequant_accum(empty.to(torch.int8), empty[:, 0],
                                  none).any()
    assert tagg.LAUNCHES == before
    # 33 agents, once refused: now the kernel's answer
    g, rx = _t(*_stack(33, 100, seed=1), device="cuda")
    np.testing.assert_allclose(
        tagg.trimmed_mean_tiled(g, rx, 1).cpu().numpy(),
        tagg.trimmed_mean_running(g, rx, 1).cpu().numpy(), **CUDA_TOL)


@needs_cuda
@pytest.mark.parametrize("mode", ["fresh", "stale"])
@pytest.mark.parametrize("rule,f", [("cge", 1), ("trimmed_mean", 1),
                                    ("quantized", 0)])
def test_engine_device_backend_on_card_matches_cpu(rule, f, mode):
    """The engine's device backend through the kernels on the card against
    the same backend on the CPU (plain forms): identical events, iterates
    within the engine parity suite's tolerance, and the kernel launched
    once per iteration or more."""
    from repro_torch.core.async_engine import AsyncEngine, EngineConfig
    from repro_torch.core.redundancy import make_redundant_quadratics
    costs = make_redundant_quadratics(8, 4, spread=0.02, cond=1.5, seed=0)
    kernel = {"cge": "masked_cge_reduce", "trimmed_mean": "trimmed_mean_tiled",
              "quantized": "dequant_accum"}[rule]
    runs = {}
    for device in ("cpu", "cuda"):
        before = tagg.LAUNCHES[kernel]
        eng = AsyncEngine(lambda j, x, rng: costs.grad(j, x), np.zeros(4),
                          EngineConfig(n_agents=8, r=2, f=f, rule=rule,
                                       mode=mode, tau=2,
                                       agg_backend="device", device=device,
                                       step_size=lambda t: 0.02,
                                       proj_gamma=30.0, seed=1),
                          loss_fn=costs.loss)
        runs[device] = (eng.run(20), eng.x, tagg.LAUNCHES[kernel] - before)
    (h_cpu, x_cpu, n_cpu), (h_gpu, x_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert n_cpu == 0 and n_gpu >= 20
    for name in ("n_rx", "max_age", "comm_time", "wall", "bytes_tx"):
        assert getattr(h_gpu, name) == getattr(h_cpu, name), name
    np.testing.assert_allclose(h_gpu.loss, h_cpu.loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x_gpu, x_cpu, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# paged flash-decode


# (B, H, Hkv, D, Dv, page_size, Pmax, num_pages)
DECODE_SHAPES = {
    "qwen2-0.5b": (8, 14, 2, 64, 64, 16, 48, 8 * 48 + 1),
    "qwen2-1.5b": (8, 12, 2, 128, 128, 16, 12, 8 * 12 + 1),
    "yi-6b": (4, 32, 4, 128, 128, 16, 12, 4 * 12 + 1),
    # phase 11's serving shapes: 4 slots, 17 pages of 16 tokens
    "jamba": (4, 32, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "qwen2-vl-2b": (4, 12, 2, 128, 128, 16, 17, 4 * 17 + 1),
    "arctic": (4, 56, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "dv_ne_d": (3, 2, 2, 128, 64, 8, 4, 16),
    "ps128": (2, 2, 1, 32, 32, 128, 2, 8),
    "pmax1": (2, 4, 2, 32, 32, 8, 1, 16),
}
# f32: the kernel's tile-wise online softmax against the plain form's one
# softmax, sums in another order; bf16: one rounding of the output
DECODE_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _decode_inputs(shape, dtype, lens=None, seed=0, device="cuda"):
    b, h, hkv, d, dv, ps, pmax, npg = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(npg, ps, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(npg, ps, hkv, dv))
                         .astype(np.float32))
    tbl = (rng.permutation(npg - 1)[: b * pmax] + 1).reshape(b, pmax)
    if lens is None:
        lens = rng.integers(1, pmax * ps + 1, size=b)
    return ([t.to(device, dtype) for t in (q, k, v)]
            + [torch.tensor(tbl, dtype=torch.int32, device=device),
               torch.tensor(lens, dtype=torch.int32, device=device)])


@needs_cuda
@pytest.mark.parametrize("name", list(DECODE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_matches_plain(name, dtype):
    shape = DECODE_SHAPES[name]
    b, _, _, _, _, ps, pmax, _ = shape
    before = tda.LAUNCHES["paged_flash_decode"]
    for lens in (None, np.full(b, pmax * ps)):       # ragged, full
        args = _decode_inputs(shape, dtype, lens)
        out = tda.paged_flash_decode(*args)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (b, shape[1], shape[4])
        torch.testing.assert_close(out.float(),
                                   tda.paged_decode_plain(*args).float(),
                                   **DECODE_TOL[dtype])
    assert tda.LAUNCHES["paged_flash_decode"] == before + 2


@needs_cuda
@pytest.mark.parametrize("name", ["jamba", "qwen2-vl-2b", "arctic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_hybrid_and_moe_shapes_run_to_run(name, dtype):
    """G = 4 and G = 7 over 8 KV heads, G = 6 over 2, at 4 slots: the
    output is the same bit for bit from call to call."""
    args = _decode_inputs(DECODE_SHAPES[name], dtype, seed=13)
    first = tda.paged_flash_decode(*args)
    torch.testing.assert_close(first.float(),
                               tda.paged_decode_plain(*args).float(),
                               **DECODE_TOL[dtype])
    for _ in range(3):
        assert torch.equal(tda.paged_flash_decode(*args), first)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_edge_cases(dtype):
    shape = (6, 14, 2, 64, 64, 16, 6, 64)
    # kv_len 0 (exact zeros), one token, on a page boundary, one past it,
    # the full table, and more than the table holds (clamped)
    lens = np.array([0, 1, 16, 17, 96, 500])
    q, k, v, tbl, ln = _decode_inputs(shape, dtype, lens, seed=3)
    out = tda.paged_flash_decode(q, k, v, tbl, ln)
    torch.testing.assert_close(out.float(),
                               tda.paged_decode_plain(q, k, v, tbl,
                                                      ln).float(),
                               **DECODE_TOL[dtype])
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # entries past each length: -1 or live-looking stale pages change
    # nothing, bit for bit
    used = -(-np.maximum(lens, 1) // 16)
    for fill in (-1, 5):
        stale = tbl.clone()
        for i, u in enumerate(used):
            stale[i, min(u, 6):] = fill
        torch.testing.assert_close(tda.paged_flash_decode(q, k, v, stale,
                                                          ln), out,
                                   rtol=0, atol=0)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_long_context_many_splits(dtype):
    """A long table walked by many splits: lengths of one token, one
    split exactly, one split plus a token, and the whole 4096-token
    table."""
    shape = (2, 14, 2, 64, 64, 16, 256, 2 * 256 + 1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, per = tda.split_plan(2, 2, 256, 16, n_sm)
    assert n_split > 8
    split = per * 16
    for lens in ([1, split], [split + 1, 4096]):
        args = _decode_inputs(shape, dtype, np.array(lens), seed=5)
        out = tda.paged_flash_decode(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(),
                                   tda.paged_decode_plain(*args).float(),
                                   **DECODE_TOL[dtype])


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_e2e_page_shape(dtype):
    """The e2e harness's cache (``E2EConfig``: 2 slots, 8-token pages, at
    most 8 pages a sequence, 32 pages) at qwen2-0.5b's head shape: one
    split walks the whole table; lengths of one token, a page, a page
    plus one, and the full 64."""
    shape = (2, 14, 2, 64, 64, 8, 8, 32)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert tda.split_plan(2, 2, 8, 8, n_sm) == (1, 8)
    for lens in ([1, 8], [9, 64], [16, 33]):
        args = _decode_inputs(shape, dtype, np.array(lens), seed=7)
        out = tda.paged_flash_decode(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(),
                                   tda.paged_decode_plain(*args).float(),
                                   **DECODE_TOL[dtype])
        assert torch.equal(tda.paged_flash_decode(*args), out)


@needs_cuda
def test_paged_flash_decode_is_run_to_run_identical():
    """The fixed-order combine: the serving shape's output is the same
    bits on every call."""
    args = _decode_inputs(DECODE_SHAPES["qwen2-0.5b"], torch.bfloat16,
                          seed=2)
    first = tda.paged_flash_decode(*args)
    for _ in range(3):
        assert torch.equal(tda.paged_flash_decode(*args), first)


@needs_cuda
def test_paged_flash_decode_validates_inputs():
    q, k, v, tbl, ln = _decode_inputs((2, 4, 2, 32, 32, 8, 2, 8),
                                      torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tda.paged_flash_decode(q.cpu(), k.cpu(), v.cpu(), tbl.cpu(),
                               ln.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tda.paged_flash_decode(q.transpose(0, 1).contiguous()
                               .transpose(0, 1), k, v, tbl, ln)
    with pytest.raises(ValueError, match="share a dtype"):
        tda.paged_flash_decode(q, k.bfloat16(), v, tbl, ln)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tda.paged_flash_decode(q[:, :3].contiguous(), k, v, tbl, ln)
    with pytest.raises(ValueError, match="at most 8"):      # G = 9
        tda.paged_flash_decode(torch.zeros((2, 18, 32), device="cuda"), k, v,
                               tbl, ln)
    big = torch.zeros((2, 2, 136), device="cuda")
    with pytest.raises(ValueError, match="at most 128"):
        tda.paged_flash_decode(big, torch.zeros((8, 8, 2, 136),
                                                device="cuda"),
                               torch.zeros((8, 8, 2, 136), device="cuda"),
                               tbl, ln)
    with pytest.raises(ValueError, match="int32"):
        tda.paged_flash_decode(q, k, v, tbl.long(), ln)


@torch.no_grad()
def _teacher_forced_logits(params, cfg, ccfg, prompts, streams):
    """(T, B, vocab) paged-decode logits along ``streams`` (B, T): prompt
    i prefilled into slot i of a fresh cache on the params' device, then
    ``streams[:, t]`` fed at step t."""
    from repro_torch.models.model import apply_model
    from repro_torch.serve.kv_cache import PagedKVCache
    device = params["embed"]["tok"].device
    kv = PagedKVCache(cfg, ccfg, device=device)
    for slot, prompt in enumerate(prompts):
        _, _, cache = apply_model(params, torch.tensor(prompt[None],
                                                       device=device),
                                  cfg, mode="prefill", logits_chunk=1)
        kv.admit(slot, cache, len(prompt), len(prompt) + streams.shape[1])
    slots = list(range(len(prompts)))
    out = []
    for t in range(streams.shape[1]):
        tokens = np.zeros((ccfg.num_slots, 1), np.int32)
        tokens[slots, 0] = streams[:, t]
        logits, _, _ = apply_model(
            params, torch.tensor(tokens, device=device), cfg, mode="decode",
            cache=kv.cache, cache_index=kv.kv_lens_dev,
            page_table=kv.page_table_dev)
        kv.commit_token(slots)
        out.append(logits[slots, 0])
    return torch.stack(out)


@needs_cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-6b"])
def test_serve_engine_on_card_matches_cpu_plain_path(arch):
    """A reduced-config ServeEngine on the card (the kernel) and on the
    CPU (the plain form), same weights: identical token streams and
    stats, and teacher-forced decode logits along those streams within
    f32 tolerance; the kernel launched once per layer and decode step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_model, tree_to
    from repro_torch.serve import PagedCacheConfig, ServeEngine
    cfg = get_config(arch).reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=64)
    ccfg = PagedCacheConfig(num_slots=2, page_size=4, num_pages=24,
                            max_pages_per_seq=8)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, s).astype(np.int32) for s in (5, 9, 3, 6)]
    budgets = [4, 7, 2, 5]
    runs = {}
    for device in ("cpu", "cuda"):
        before = tda.LAUNCHES["paged_flash_decode"]
        eng = ServeEngine(tree_to(params, device), cfg, ccfg, superstep_k=8,
                          device=device)
        for p, n in zip(prompts, budgets):
            eng.submit(p, n)
        runs[device] = (eng.run(), dict(eng.stats),
                        tda.LAUNCHES["paged_flash_decode"] - before)
    (out_c, st_c, n_c), (out_g, st_g, n_g) = runs["cpu"], runs["cuda"]
    assert st_g == st_c and n_c == 0
    assert n_g == st_g["decode_steps"] * cfg.n_layers
    for rid in out_c:
        np.testing.assert_array_equal(out_g[rid], out_c[rid])
    streams = np.stack([out_c[0][:4], out_c[3][:4]])
    lg = {d: _teacher_forced_logits(tree_to(params, d), cfg, ccfg,
                                    [prompts[0], prompts[3]], streams)
          for d in ("cpu", "cuda")}
    torch.testing.assert_close(lg["cuda"].cpu(), lg["cpu"], rtol=1e-4,
                               atol=1e-4)


@needs_cuda
def test_e2e_fleet_on_card_matches_cpu():
    """The e2e harness on a 4-replica reduced fleet on the card (the
    decode kernel) against the same fleet on the CPU (the plain form),
    same weights, under a mid-run crash and reply drops: identical
    copies, quorum rows and r-sweep, no violations, both drained."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_model, tree_to
    from repro_torch.sim import e2e
    from repro_torch.sim.faults import (CrashWindow, FaultSchedule,
                                        MessageFaults)
    from repro_torch.sim.scenario import Scenario
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=64)
    sc = Scenario(name="t_card", description="e2e on the card", n_agents=4,
                  r=1, iters=30, seed=7, n_requests=8,
                  faults=FaultSchedule(
                      crashes=(CrashWindow(agent=2, start=1.3, end=6.0),),
                      messages=MessageFaults(drop_p=0.2)))
    reps = {}
    for device in ("cpu", "cuda"):
        before = tda.LAUNCHES["paged_flash_decode"]
        fleet = e2e.EngineFleet(4, params=tree_to(params, device), cfg=cfg,
                                device=device)
        reps[device] = (e2e.run_e2e(sc, fleet=fleet),
                        tda.LAUNCHES["paged_flash_decode"] - before)
        assert fleet.drained()
    (rc, nc), (rg, ng) = reps["cpu"], reps["cuda"]
    assert nc == 0 and ng > 0
    assert rg.violations == rc.violations == []
    assert rg.native.as_dict() == rc.native.as_dict()
    assert {r: row.as_dict() for r, row in rg.sweep.items()} == \
        {r: row.as_dict() for r, row in rc.sweep.items()}
    for qg, qc in zip(rg.requests, rc.requests):
        for j, c in qc.copies.items():
            d = qg.copies[j]
            assert (d.status, d.t_first, d.t_done, d.t_lost) == \
                (c.status, c.t_first, c.t_done, c.t_lost)
            if c.tokens is not None:
                np.testing.assert_array_equal(d.tokens, c.tokens)


# ---------------------------------------------------------------------------
# flash attention and the CGE bucketed passes


def _flash_inputs(case, dtype, seed=0, device="cuda"):
    b, h, s, t, d, dv, mult = case
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, h, s, d)) * mult,
              rng.normal(size=(b, h, t, d)) * mult,
              rng.normal(size=(b, h, t, dv)))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in arrays]


@needs_cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(case, dtype):
    q, k, v = _flash_inputs(case, dtype)
    before = tfa.LAUNCHES["flash_attention"]
    for causal in (True, False):
        out = tfa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (*q.shape[:3], case[5])
        torch.testing.assert_close(
            out.float(),
            tfa.flash_attention_plain(q, k, v, causal=causal).float(),
            **FLASH_TOL[dtype])
    assert tfa.LAUNCHES["flash_attention"] == before + 2


@needs_cuda
@pytest.mark.parametrize("case", [FLASH_CASES[8], FLASH_CASES[11]], ids=str)
def test_flash_attention_bf16_is_run_to_run_identical(case):
    q, k, v = _flash_inputs(case, torch.bfloat16)
    first = tfa.flash_attention(q, k, v)
    assert torch.equal(tfa.flash_attention(q, k, v), first)


@needs_cuda
def test_flash_attention_validates_inputs():
    q, k, v = _flash_inputs(FLASH_CASES[0], torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    for d in (260, 60):
        x = torch.zeros((1, 1, 8, d), device="cuda")
        with pytest.raises(ValueError, match="multiples of 8"):
            tfa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    with pytest.raises(ValueError, match="share a dtype"):
        tfa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not fit"):
        tfa.flash_attention(q, k[:, :, :, :32].contiguous(), v)


def _rows(n, w, dtype, seed=0, misaligned=False):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, w))
                         .astype(np.float32)).to("cuda", dtype)
    if misaligned:      # contiguous, base one element past a 16-byte line
        buf = torch.empty(n * w + 1, dtype=dtype, device="cuda")
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(n, w)
    return x


@needs_cuda
@pytest.mark.parametrize("n,w", CGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_cge_norm_kernels_match_plain(n, w, dtype, misaligned):
    x = _rows(n, w, dtype, misaligned=misaligned)
    before = dict(tcn.LAUNCHES)
    norms = tcn.block_sq_norms(x)
    torch.testing.assert_close(norms, tcn.block_sq_norms_plain(x),
                               **NORM_TOL)
    assert torch.equal(tcn.block_sq_norms(x), norms)        # run to run
    rng = np.random.default_rng(1)
    for scale in (rng.uniform(size=n), rng.integers(0, 2, size=n),
                  np.zeros(n), np.ones(n)):
        s = torch.tensor(scale, dtype=torch.float32, device="cuda")
        out = tcn.masked_scale(x, s)
        assert out.dtype == dtype and out.shape == x.shape
        assert torch.equal(out, tcn.masked_scale_plain(x, s))
    torch.cuda.synchronize()
    assert tcn.LAUNCHES["block_sq_norms"] == before["block_sq_norms"] + 2
    assert tcn.LAUNCHES["masked_scale"] == before["masked_scale"] + 4


@needs_cuda
def test_cge_norm_wrappers_validate_inputs():
    x = _rows(4, 64, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tcn.block_sq_norms(x.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        tcn.masked_scale(x.cpu(), torch.ones(4))
    with pytest.raises(ValueError, match="contiguous"):
        tcn.block_sq_norms(x.t())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcn.block_sq_norms(x.half())
    with pytest.raises(ValueError, match="scale"):
        tcn.masked_scale(x, torch.ones(4, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="scale"):
        tcn.masked_scale(x, torch.ones(3, device="cuda"))


# ---------------------------------------------------------------------------
# tensor-parallel decode: each rank's KV-head block through the kernel with
# the unsharded Hkv's split plan, the blocks joined by a -0.0-padded
# all-reduce (gloo ranks sharing the one card)


# (shape of DECODE_SHAPES' layout, tp): phase 6's decode shape over 2
# ranks, Hkv = 8 over 4, and a 4096-token table over 2, where the split
# plan of Hkv / tp differs from the unsharded one's
TP_DECODE = {
    "qwen2-0.5b": (DECODE_SHAPES["qwen2-0.5b"], 2),
    "hkv8_tp4": (DECODE_SHAPES["jamba"], 4),
    "long_tp2": ((2, 8, 4, 64, 64, 16, 256, 513), 2),
}
# split_plan's results at 132 SMs, as before tensor-parallel decode
SPLIT_PLANS = {"qwen2-0.5b": (12, 4), "qwen2-1.5b": (3, 4), "yi-6b": (3, 4),
               "jamba": (5, 4)}


def _bits(t):
    return t.cpu().view(torch.int16 if t.dtype == torch.bfloat16
                        else torch.int32)


def _tp_decode_rank(rank, world, shape, dtype):
    from repro_torch.dist.sharding import kv_head_block
    from repro_torch.kernels.decode_attention import tp_paged_decode
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(data=1, model=world, device="cuda")
    q, k, v, tbl, lens = _decode_inputs(shape, dtype, seed=3)
    whole = tda.paged_flash_decode(q, k, v, tbl, lens)
    blk = kv_head_block(mesh, ("model",), shape[2], shape[1])
    h0, h1 = blk or (0, shape[2])
    before = tda.LAUNCHES["paged_flash_decode"]
    out = tp_paged_decode(q, k[:, :, h0:h1].contiguous(),
                          v[:, :, h0:h1].contiguous(), tbl, lens, mesh=mesh,
                          kv_block=blk, n_kv_heads=shape[2])
    torch.cuda.synchronize()
    return (_bits(whole), _bits(out),
            tda.LAUNCHES["paged_flash_decode"] - before)


@needs_cuda
@pytest.mark.parametrize("name", list(TP_DECODE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_paged_decode_bit_identical_to_unsharded(name, dtype, tmp_path):
    from repro_torch.launch.mesh import run_ranks
    shape, tp = TP_DECODE[name]
    res = run_ranks(_tp_decode_rank, tp, backend="gloo", device="cuda",
                    timeout=240, args=(shape, dtype),
                    store_dir=str(tmp_path))
    for whole, out, launches in res:
        assert torch.equal(out, whole) and launches == 1


@needs_cuda
def test_tp_paged_decode_one_rank_is_the_kernel(tmp_path):
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_tp_decode_rank, 1, backend="gloo", device="cuda",
                    timeout=120, args=(DECODE_SHAPES["qwen2-0.5b"],
                                       torch.bfloat16),
                    store_dir=str(tmp_path))
    whole, out, launches = res[0]
    assert torch.equal(out, whole) and launches == 1


@needs_cuda
def test_split_plan_defaults_unchanged():
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, want in SPLIT_PLANS.items():
        b, _, hkv, _, _, ps, pmax, _ = DECODE_SHAPES[name]
        if n_sm == 132:
            assert tda.split_plan(b, hkv, pmax, ps, n_sm) == want
        args = _decode_inputs(DECODE_SHAPES[name], torch.bfloat16, seed=4)
        assert torch.equal(_bits(tda.paged_flash_decode(*args)),
                           _bits(tda.paged_flash_decode(*args, plan_hkv=hkv)))
    b, _, hkv, _, _, ps, pmax, _ = TP_DECODE["long_tp2"][0]
    assert (tda.split_plan(b, hkv, pmax, ps, n_sm)
            != tda.split_plan(b, hkv // 2, pmax, ps, n_sm))
