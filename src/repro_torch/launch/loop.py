"""Production training loop: Algorithm 1 as the data-parallel step
(counterpart of ``repro.launch.loop``).

Composes the masked train step with
- a **straggler oracle** (a latency-model simulation on the host; on real
  hardware the same interface is fed per-host step-time telemetry),
- atomic async checkpointing + restore-on-start (job fault tolerance),
- metrics history (loss, grad-norm, simulated round time, comm savings).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core.async_engine import LatencyModel, default_latency
from repro_torch.data.partition import mask_to_weights
from repro_torch.device import resolve as resolve_device
from repro_torch.launch.train import TrainConfig, init_state, make_train_step


class StragglerOracle:
    """Produces the per-step agent mask (S^t selection, |S^t| = n - r).

    Simulation mode samples the latency model and masks the r slowest;
    ``observe()`` is the production hook (feed real per-host step times).
    The numpy stream is the reference's, draw for draw."""

    def __init__(self, n_agents: int, r: int,
                 latency: Optional[LatencyModel] = None, seed: int = 0):
        self.n = n_agents
        self.r = r
        self.lat = latency or default_latency(n_agents)
        self.rng = np.random.default_rng(seed)
        self._observed: Optional[np.ndarray] = None

    def observe(self, per_agent_times: np.ndarray) -> None:
        self._observed = np.asarray(per_agent_times)

    def next_mask(self):
        """Returns (mask (n,), round_time, full_round_time)."""
        lat = (self._observed if self._observed is not None
               else self.lat.sample(self.rng))
        self._observed = None
        order = np.argsort(lat)
        keep = order[:self.n - self.r]
        mask = np.zeros(self.n, np.float32)
        mask[keep] = 1.0
        return mask, float(lat[keep].max()), float(lat.max())


@dataclass
class LoopHistory:
    loss: List[float] = field(default_factory=list)
    grad_norm: List[float] = field(default_factory=list)
    round_time: List[float] = field(default_factory=list)
    sync_round_time: List[float] = field(default_factory=list)

    @property
    def comm_saving(self) -> float:
        return 1.0 - (np.sum(self.round_time)
                      / max(np.sum(self.sync_round_time), 1e-9))


class TrainLoop:
    """The masked train step driven by the oracle's masks over
    ``data_iter`` ((tokens, targets) numpy batches), on ``device`` (a
    card unless the caller asks for the CPU). With ``ckpt_dir``, restores
    the newest checkpoint there on start and saves every ``ckpt_every``
    steps (async) and at the end of each ``run`` (blocking; where the
    last step was just saved, it waits for that save instead of writing
    the same state again)."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig,
                 data_iter, n_agents: int, r: int = 0,
                 oracle: Optional[StragglerOracle] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 max_pos: int = 32768, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.data_iter = data_iter
        self.n_agents = n_agents
        self.device = resolve_device(device)
        self.oracle = oracle or StragglerOracle(n_agents, r, seed=seed)
        self.step_fn = make_train_step(cfg, tc, moe_groups=n_agents)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_state(gen, cfg, tc, max_pos=max_pos,
                                n_agents=n_agents, device=self.device)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.state, s = self.ckpt.restore(self.state)
            print(f"[loop] restored checkpoint at step {s}")
        self.hist = LoopHistory()

    def run(self, steps: int, log_every: int = 0) -> LoopHistory:
        for i in range(steps):
            with spans.span("train.step"):
                self._step(i, log_every)
        if self.ckpt:
            step = int(self.state["step"])
            if steps and self.ckpt_every and step % self.ckpt_every == 0:
                self.ckpt.wait()        # this very state is being saved
            else:
                with spans.span("train.ckpt"):
                    self.ckpt.save(self.state, step, blocking=True)
        return self.hist

    def _step(self, i: int, log_every: int) -> None:
        with spans.span("train.feed"):
            tokens, targets = next(self.data_iter)
            mask, rt, full_rt = self.oracle.next_mask()
            weights = mask_to_weights(mask, tokens.shape[0], tokens.shape[1])
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in (("tokens", tokens), ("targets", targets),
                                  ("weights", weights))}
        self.state, metrics = self.step_fn(self.state, batch)
        with spans.span("train.sync"):
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            step = int(self.state["step"])
        self.hist.loss.append(loss)
        self.hist.grad_norm.append(gnorm)
        self.hist.round_time.append(rt)
        self.hist.sync_round_time.append(full_rt)
        if self.ckpt and self.ckpt_every and step % self.ckpt_every == 0:
            with spans.span("train.ckpt"):
                self.ckpt.save(self.state, step)     # async, atomic
        if log_every and (i + 1) % log_every == 0:
            print(f"[loop] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"round {rt:.2f}s (sync {full_rt:.2f}s)", flush=True)
