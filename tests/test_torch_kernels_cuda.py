"""The CUDA aggregation kernels against their plain torch forms on the
card, at the paper's shape (n=20, P=431,080), at ragged P and on the edge
cases, plus the wrappers' launch counts and input checks. Every test here
needs a GPU and skips without one, and the file imports no JAX: on the GPU
machine run ``python -m pytest -q tests/test_torch_kernels_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import gradagg as tg
from repro_torch.kernels import agg as tagg

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
@pytest.mark.parametrize("n,p", [(20, 431_080), (7, 4097), (3, 1)])
@pytest.mark.parametrize("f", [0, 1, 2])
def test_cuda_kernels_match_plain(n, p, f):
    g, rx = _stack(n, p, seed=n + f)
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
        before["masked_cge_reduce"] + 3
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
        np.testing.assert_allclose(kernel(tgt, trx, f).cpu().numpy(),
                                   plain(tgt, trx, f).cpu().numpy(),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=kernel.__name__)


@needs_cuda
def test_cuda_wrappers_validate_inputs():
    tgt, trx = _t(*_stack(4, 100), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tagg.masked_cge_reduce(tgt.t().contiguous().t(), trx, 1)
    with pytest.raises(ValueError, match="bool"):
        tagg.trimmed_mean_tiled(tgt, trx.float(), 1)
    big = torch.zeros((tagg.TRIM_MAX_N + 1, 8), device="cuda")
    with pytest.raises(ValueError, match="agents"):
        tagg.trimmed_mean_tiled(big, torch.ones(big.shape[0], dtype=bool,
                                                device="cuda"), 1)


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
