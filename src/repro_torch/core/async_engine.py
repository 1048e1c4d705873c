"""Event-driven asynchronous server/agent engine (paper Fig. 1 system).

Reproduces the paper's experimental semantics exactly:

- **fresh** mode = Algorithm 1: every iteration the server broadcasts x^t,
  agents compute gradients at x^t, the server uses the first n-r arrivals
  (S^t) and drops the rest.
- **stale** mode = §3.2 rule (15): agents run free; the server keeps a
  per-agent ledger of the latest delivered (timestamp, gradient) and
  proceeds once >= n-r ledger entries have timestamp >= t - tau. The
  T^{t;t-i} sets of the paper are exactly the ledger partitioned by
  timestamp (disjoint by construction — one entry per agent).
- **byzantine**: faulty agents send attacked vectors (arbitrarily fast —
  worst case); the server pipes the first n-r arrivals through a gradient
  filter (eq. 18), e.g. CGE.

Latency is a heavy-tail model matching §5's observation that "a small
number of stragglers work very slow". Crash/recovery windows exercise the
fault-tolerance path.

Torch port of ``repro.core.async_engine``: the event logic and every
numpy random draw are the reference's, line for line, so the same seed
gives the same event stream. Aggregation runs on ``EngineConfig.device``
(a CUDA card unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gradagg
from repro_torch.core.byzantine import ATTACKS
from repro_torch.device import resolve as resolve_device


@dataclass
class LatencyModel:
    """Per-iteration agent latency = base[j] * lognormal(sigma) * slow[j]."""
    n_agents: int
    mean: float = 1.0
    sigma: float = 0.25
    straggler_ids: Tuple[int, ...] = ()
    straggler_factor: float = 10.0
    comm: float = 0.05                # one-way message time

    def _finish(self, idx, raw):
        """The one straggler/comm code path both samplers share (scalar or
        aligned arrays). numpy's Generator draws batched and sequential
        lognormals from the same bit stream and the arithmetic here is
        elementwise-identical either way, so n sequential
        ``sample_one(j, rng)`` calls (j = 0..n-1) on one generator
        reproduce ``sample(rng)`` element for element."""
        raw = np.asarray(raw, float)
        if self.straggler_ids:
            slow = np.isin(np.asarray(idx), self.straggler_ids)
            raw = np.where(slow, raw * self.straggler_factor, raw)
        return raw + 2 * self.comm          # broadcast + return

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        raw = self.mean * rng.lognormal(0.0, self.sigma, size=self.n_agents)
        return self._finish(np.arange(self.n_agents), raw)

    def sample_one(self, j: int, rng: np.random.Generator) -> float:
        """One agent's next-iteration latency. The event-driven stale loop
        assigns work to a single agent at a time; sampling the full
        n-agent vector there wasted n-1 draws per assignment."""
        return float(self._finish(j, self.mean * rng.lognormal(0.0,
                                                               self.sigma)))


def default_latency(n_agents: int, n_stragglers: int = 3,
                    factor: float = 10.0, seed: int = 0) -> LatencyModel:
    rng = np.random.default_rng(seed)
    ids = tuple(rng.choice(n_agents, size=n_stragglers, replace=False))
    return LatencyModel(n_agents=n_agents, straggler_ids=ids,
                        straggler_factor=factor)


class Transport:
    """Event-ordering seam (DESIGN.md §10): every timing, liveness and
    delivery decision the engine (and ``serve.dispatch``) makes goes
    through this interface instead of inline rng draws, so a simulator
    can inject one shared fault model into both the
    training and the serving stack and replay it byte-for-byte.

    ``rng`` is the caller's generator; the default transport draws from
    it (preserving the engine's historical bit stream), while simulated
    transports keep their own seeded stream so event ordering is
    independent of how many gradient-noise draws the caller consumes.
    A non-finite latency means "never delivered this round" (message
    dropped or agent unreachable).
    """

    def alive(self, j: int, now: float) -> bool:
        return True

    def round_latencies(self, now: float,
                        rng: np.random.Generator) -> np.ndarray:
        """Fresh mode / dispatch: per-agent round-trip latency vector."""
        raise NotImplementedError

    def task_latency(self, j: int, now: float,
                     rng: np.random.Generator) -> float:
        """Stale mode: latency of one agent's next assignment."""
        raise NotImplementedError

    def delivery_fate(self, j: int, now: float,
                      rng: np.random.Generator) -> int:
        """How many copies of a completed stale-mode upload arrive:
        0 = dropped (work lost, agent re-assigned), 1 = delivered,
        2 = duplicated (idempotent ledger write, billed twice)."""
        return 1

    # snapshot/restore hooks (server checkpoints carry transport state so
    # a restored run replays the same event order as the uninterrupted one)
    def state_dict(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:
        pass

    def reset(self) -> None:
        pass


class DefaultTransport(Transport):
    """Historical engine behavior: latencies from a ``LatencyModel`` drawn
    off the caller's rng; liveness from static crash windows
    ``(agent, t_start, t_end)`` in virtual wall-clock time."""

    def __init__(self, latency: LatencyModel,
                 crashes: Sequence[Tuple[int, float, float]] = ()):
        self.lat = latency
        self.crashes = tuple(crashes)

    def alive(self, j: int, now: float) -> bool:
        for (a, t0, t1) in self.crashes:
            if a == j and t0 <= now < t1:
                return False
        return True

    def round_latencies(self, now: float,
                        rng: np.random.Generator) -> np.ndarray:
        return self.lat.sample(rng)

    def task_latency(self, j: int, now: float,
                     rng: np.random.Generator) -> float:
        return self.lat.sample_one(j, rng)


@dataclass
class EngineConfig:
    n_agents: int
    r: int = 0
    mode: str = "fresh"               # fresh | stale
    tau: int = 0                      # staleness bound (stale mode)
    f: int = 0                        # Byzantine tolerance of the filter
    byz_ids: Tuple[int, ...] = ()
    attack: Optional[str] = None
    rule: str = "sum"                 # any repro_torch.dist.registry rule
    step_size: Callable[[int], float] = lambda t: 0.01
    proj_gamma: float = 1e6           # radius of W (L2 ball)
    wire_dtype: str = "float32"       # on-the-wire element format
    # "host" = the conformance pipeline: re-stack every iteration and
    # apply the reference rule op by op on ``device``; "device" = resident
    # f32 GradLedger + the rule's kernel-backed twin -> step -> project;
    # "sharded" = that ledger dp-sharded over a mesh of ranks (pass
    # ``mesh=``; every rank runs the engine)
    agg_backend: str = "host"
    # sharded backend: "gather" (bit-identical to "device") or "partial"
    ledger_combine: str = "gather"
    seed: int = 0
    # crash windows: (agent, t_start, t_end) in wall-clock time
    crashes: Tuple[Tuple[int, float, float], ...] = ()
    # where aggregation runs; "cuda" fails loudly on a machine without one
    device: str = "cuda"


@dataclass
class History:
    loss: List[float] = field(default_factory=list)
    dist: List[float] = field(default_factory=list)
    comm_time: List[float] = field(default_factory=list)   # per-iteration
    wall: List[float] = field(default_factory=list)
    bytes_tx: int = 0
    staleness: List[float] = field(default_factory=list)   # mean age used
    max_age: List[float] = field(default_factory=list)     # oldest age used
    n_rx: List[int] = field(default_factory=list)  # distinct uploads used

    @property
    def cum_comm(self) -> np.ndarray:
        return np.cumsum(self.comm_time)


class AsyncEngine:
    """grad_fn(agent_id, x, rng) -> flat gradient; loss_fn(x) -> float."""

    def __init__(self, grad_fn, x0: np.ndarray, cfg: EngineConfig,
                 latency: Optional[LatencyModel] = None,
                 loss_fn=None, x_star: Optional[np.ndarray] = None,
                 transport: Optional[Transport] = None, mesh=None):
        self.grad_fn = grad_fn
        self.x = np.asarray(x0, np.float64).copy()
        self.cfg = cfg
        self.lat = latency or default_latency(cfg.n_agents)
        # a custom transport owns liveness entirely: cfg.crashes only feeds
        # the default one
        self.transport = transport or DefaultTransport(self.lat, cfg.crashes)
        self.loss_fn = loss_fn
        self.x_star = x_star
        self.rng = np.random.default_rng(cfg.seed)
        self.t = 0
        self.clock = 0.0
        self.hist = History()
        self.rule = gradagg.make_gradagg(cfg.rule, f=cfg.f)
        # wire-format accounting: broadcasts go down at the wire dtype's
        # width; uploads at the rule's payload width (int8 error-feedback
        # sends 1 byte/param + one f32 scale per message)
        self._down_bytes = int(np.dtype(cfg.wire_dtype).itemsize)
        from repro_torch.dist.registry import get_rule  # dist sits above core
        wire = get_rule(cfg.rule).wire_bytes
        self._up_bytes = self._down_bytes if wire is None else int(wire)
        self._up_overhead = 0 if wire is None else 4    # the f32 scale
        # stale-mode state
        self._x_hist: Dict[int, np.ndarray] = {}
        self._ledger_ts = np.full(cfg.n_agents, -1, np.int64)
        self._busy_until = np.zeros(cfg.n_agents)
        self._working_on = np.full(cfg.n_agents, -1, np.int64)
        # gradient ledger: host f64 matrix (reference), or a resident f32
        # device buffer + aggregate step (the fast path). The host branch
        # keeps an empty matrix in device mode so shape-based code never
        # sees None.
        if cfg.agg_backend not in ("host", "device", "sharded"):
            raise ValueError(
                f"unknown agg_backend {cfg.agg_backend!r}; "
                "expected 'host', 'device' or 'sharded'")
        self.device = resolve_device(cfg.device)
        self._dev = None
        if cfg.agg_backend == "device":
            from repro_torch.core.ledger import (GradLedger,
                                                 make_aggregate_apply)
            self._dev = GradLedger(cfg.n_agents, x0.size, self.device)
            self._agg_apply = make_aggregate_apply(cfg.rule, cfg.f,
                                                   cfg.proj_gamma)
        elif cfg.agg_backend == "sharded":
            if mesh is None:
                raise ValueError("agg_backend='sharded' needs a mesh")
            if mesh.device != self.device:
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}")
            from repro_torch.core.ledger import (
                ShardedGradLedger, make_sharded_aggregate_apply)
            from repro_torch.launch.mesh import dp_axis_names
            axes = dp_axis_names(mesh)
            self._dev = ShardedGradLedger(cfg.n_agents, x0.size, self.device,
                                          mesh=mesh, axes=axes)
            self._agg_apply = make_sharded_aggregate_apply(
                cfg.rule, cfg.f, cfg.proj_gamma, mesh, axes, cfg.n_agents,
                cfg.ledger_combine)
        if self._dev is not None:
            self._dev_x = torch.as_tensor(self.x, dtype=torch.float32,
                                          device=self.device)
        self._ledger_g = np.zeros(
            (cfg.n_agents, 0 if self._dev is not None else x0.size))

    # ------------------------------------------------------------------
    def _alive(self, j: int, now: float) -> bool:
        return self.transport.alive(j, now)

    def _send(self, j: int, x: np.ndarray) -> np.ndarray:
        g = self.grad_fn(j, x, self.rng)
        if j in self.cfg.byz_ids and self.cfg.attack:
            g = ATTACKS[self.cfg.attack](g, self.rng)
        return np.asarray(g, np.float64)

    def _host_rule(self, g: np.ndarray, received: np.ndarray) -> np.ndarray:
        """The reference rule op by op on ``self.device``. The stack goes
        in as f32, as the reference's f64 stack does (jnp without x64
        computes in f32), and the aggregate comes back as host f32."""
        agg = self.rule(
            torch.as_tensor(g, dtype=torch.float32, device=self.device),
            torch.as_tensor(received, device=self.device))
        return agg.cpu().numpy()

    def _apply(self, agg: np.ndarray, eta: float) -> None:
        # the projection rounds the iterate to f32, and it stays f32 from
        # here on, as the reference's becomes a jnp f32 array
        x = torch.as_tensor(np.asarray(self.x - eta * agg),
                            dtype=torch.float32, device=self.device)
        self.x = gradagg.project_ball(x, self.cfg.proj_gamma).cpu().numpy()

    def _device_step(self, received: np.ndarray, eta: float) -> None:
        """The device iteration: rule -> step -> projection over the
        resident ledger; ``self.x`` stays a host f64 mirror (exact f32
        values) for grad_fn / loss / accounting."""
        self._dev_x = self._agg_apply(
            self._dev_x, self._dev.front_for_aggregate(),
            torch.as_tensor(received, device=self.device), float(eta))
        self.x = self._dev_x.cpu().numpy().astype(np.float64)

    # -- ledger snapshot seam (server checkpoints) ---------------------
    def ledger_host(self) -> np.ndarray:
        """Snapshot form of the gradient ledger: the host f64 reference
        matrix, or the device buffer pulled back as f32 (either restores
        bit-exactly for its own backend)."""
        if self._dev is not None:
            return self._dev.host()
        return self._ledger_g.copy()

    def load_ledger(self, arr: np.ndarray) -> None:
        if self._dev is not None:
            self._dev.load(arr)
        else:
            self._ledger_g = np.array(arr, np.float64, copy=True)

    def _record(self, round_time: float, mean_age: float = 0.0,
                n_rx: int = 0, n_bcast: Optional[int] = None,
                max_age: float = 0.0,
                n_billed: Optional[int] = None) -> None:
        """``n_rx`` = distinct uploads that entered the aggregate (the
        liveness witness); ``n_billed`` additionally counts duplicated
        deliveries for the bytes accounting (defaults to n_rx)."""
        c = self.cfg
        if n_billed is None:
            n_billed = n_rx
        self.hist.comm_time.append(round_time)
        self.clock += round_time
        self.hist.wall.append(self.clock)
        self.hist.staleness.append(mean_age)
        # the oldest gradient that actually entered the aggregate: the
        # externally checkable witness that rule (15) honored tau
        self.hist.max_age.append(max_age)
        self.hist.n_rx.append(n_rx)
        # broadcasts are billed per *recipient*: fresh mode passes the
        # alive count, so crashed agents stop inflating bytes_tx
        if n_bcast is None:
            n_bcast = c.n_agents
        self.hist.bytes_tx += (
            n_bcast * self.x.size * self._down_bytes
            + n_billed * (self.x.size * self._up_bytes + self._up_overhead))
        if self.loss_fn is not None:
            self.hist.loss.append(float(self.loss_fn(self.x)))
        if self.x_star is not None:
            self.hist.dist.append(float(np.linalg.norm(self.x - self.x_star)))

    # ------------------------------------------------------------------
    def step_fresh(self) -> None:
        c = self.cfg
        lat = np.asarray(self.transport.round_latencies(self.clock,
                                                        self.rng), float)
        alive = np.array([self._alive(j, self.clock) for j in
                          range(c.n_agents)])
        # byzantine agents arrive first (adversarial worst case; the
        # adversary controls its own messages, so they never drop)
        order_key = lat.copy()
        for j in c.byz_ids:
            order_key[j] = 0.0
        order_key[~alive] = np.inf
        n_alive = int(alive.sum())
        # inf latency = undeliverable this round (crashed or message
        # dropped by the transport) — never enters S^t
        deliverable = int(np.isfinite(order_key).sum())
        wait_for = min(c.n_agents - c.r, deliverable)  # elastic degrade
        order = np.argsort(order_key)
        chosen = order[:wait_for]
        received = np.zeros(c.n_agents, bool)
        received[chosen] = True
        round_time = float(np.max(order_key[chosen])) if wait_for else 0.0

        if self._dev is None:
            g = np.zeros((c.n_agents, self.x.size))
            for j in np.nonzero(received)[0]:
                g[j] = self._send(j, self.x)
            self._apply(self._host_rule(g, received), c.step_size(self.t))
        else:
            # uploads scatter straight into the resident ledger (stale
            # rows in non-received slots are masked out by every rule)
            idx = np.nonzero(received)[0]
            if idx.size:
                self._dev.upload(idx, np.stack(
                    [self._send(j, self.x) for j in idx]))
            self._device_step(received, c.step_size(self.t))
        self.t += 1
        self._record(round_time, 0.0, wait_for, n_bcast=n_alive)

    # ------------------------------------------------------------------
    def step_stale(self) -> None:
        c = self.cfg
        t = self.t
        self._x_hist[t] = self.x.copy()
        # prune history beyond tau
        for k in list(self._x_hist):
            if k < t - c.tau - 1:
                del self._x_hist[k]
        start = self.clock

        # agents idle at iteration start pick up x^t
        for j in range(c.n_agents):
            if self._working_on[j] < 0 and self._alive(j, self.clock):
                self._working_on[j] = t
                self._busy_until[j] = self.clock + \
                    self.transport.task_latency(j, self.clock, self.rng)

        def usable() -> int:
            return int(np.sum(self._ledger_ts >= t - c.tau))

        # advance the event clock delivery-by-delivery until rule-15's
        # wait condition |T^t| >= n - r holds
        guard = 0
        rx_extra = 0                    # duplicated uploads, billed too
        while usable() < c.n_agents - c.r:
            busy = [j for j in range(c.n_agents) if self._working_on[j] >= 0]
            if not busy:
                break
            jn = min(busy, key=lambda j: self._busy_until[j])
            now = self._busy_until[jn]
            self.clock = max(self.clock, now)
            ts = int(self._working_on[jn])
            xs = self._x_hist.get(ts)
            # an agent dead at completion time loses its in-flight work
            # (the CrashWindow contract): nothing is sent, so the fate
            # hook isn't consulted either
            alive_now = self._alive(jn, self.clock)
            if xs is not None and alive_now:
                copies = self.transport.delivery_fate(jn, now, self.rng)
                if copies > 0:
                    g_up = self._send(jn, xs)
                    if self._dev is None:
                        self._ledger_g[jn] = g_up
                    else:
                        self._dev.upload_row(jn, g_up)
                    self._ledger_ts[jn] = ts
                    rx_extra += copies - 1
            if alive_now:
                self._working_on[jn] = t
                self._busy_until[jn] = self.clock + \
                    self.transport.task_latency(jn, self.clock, self.rng)
            else:
                self._working_on[jn] = -1
            guard += 1
            if guard > 100 * c.n_agents:
                break

        received = self._ledger_ts >= t - c.tau
        ages = (t - self._ledger_ts)[received]
        if self._dev is None:
            self._apply(self._host_rule(self._ledger_g, received),
                        c.step_size(t))
        else:
            self._device_step(received, c.step_size(t))
        self.t += 1
        # the event loop already advanced self.clock to the last delivery
        # time; rewind to the step start so _record's advance lands the
        # clock exactly there (it used to double-advance, which halved
        # the effective depth of any wall-clock fault window)
        round_time = self.clock - start
        self.clock = start
        self._record(round_time,
                     float(ages.mean()) if ages.size else 0.0,
                     int(received.sum()),
                     max_age=float(ages.max()) if ages.size else 0.0,
                     n_billed=int(received.sum()) + rx_extra)

    # ------------------------------------------------------------------
    def run(self, iters: int) -> History:
        for _ in range(iters):
            if self.cfg.mode == "stale":
                self.step_stale()
            else:
                self.step_fresh()
        return self.hist
