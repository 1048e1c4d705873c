"""Training step factories (counterpart of ``repro.launch.train``) — the
paper's technique as a training step.

Two paths:

1. ``masked`` (default) and ``sync``: Algorithm 1 via per-token loss
   weights. The host (straggler oracle / telemetry) zeroes the weights
   of the r masked agents' examples, so their gradients vanish from the
   one bulk gradient: dropping a straggler costs no extra collective.
   One process, no mesh.

2. ``general`` (:func:`make_general_step`, every rank of a mesh whose dp
   axes carry one agent per rank): per-agent gradients per dp rank,
   enabling
   - ``cge``        the two-phase CGE filter (one norm per agent
                    all-reduced, then a masked all-reduce),
   - ``stale``      rule (15) with the agent's ledger row on its rank,
   - ``trimmed``    the coordinate-wise trimmed mean,
   - ``quantized``  int8 error-feedback compressed aggregation.
   Parameters and optimizer state are replicated: every rank applies the
   same update to the same values. The reference's train-time "model"
   axis is GSPMD-automatic and leaves the numbers unchanged; the port
   has no automatic partitioner, so its train meshes carry model = 1.

Gradients come from ``torch.autograd`` on the reference's loss; the
optimizer and clipping arithmetic are ``repro_torch.optim.optimizers``'.
Every entry point runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.ledger import (layout_of, ledger_zeros, tree_flatten,
                                     tree_map, tree_unflatten)
from repro_torch.device import resolve as resolve_device
from repro_torch.dist import collectives as C
from repro_torch.dist.registry import resolve_mode
from repro_torch.launch.mesh import dp_axis_names, n_agents_of
from repro_torch.models.model import apply_model, init_model, lm_loss
from repro_torch.optim.optimizers import (adamw, apply_updates,
                                          clip_by_global_norm, sgd)

Tree = Any


@dataclass(frozen=True)
class TrainConfig:
    mode: str = "masked"            # masked | sync | cge | stale | trimmed | quantized
    optimizer: str = "adamw"
    lr_kind: str = "constant"       # constant | inv_t | cosine
    lr: float = 1e-3
    lr_total: int = 1000            # cosine horizon
    warmup: int = 0
    clip_norm: float = 1.0
    aux_coef: float = 0.01
    remat_policy: str = "full"
    accum_steps: int = 1            # microbatch gradient accumulation
    f: int = 0                      # Byzantine tolerance (cge/trimmed)
    tau: int = 4                    # staleness bound (stale)
    logits_fp32: bool = False


def lr_at(tc: TrainConfig, step) -> float:
    """The step size at ``step``, computed in f32 as the reference's."""
    f32 = np.float32
    s = f32(int(step))
    if tc.lr_kind == "inv_t":
        base = f32(tc.lr) / (s + f32(1.0))
    elif tc.lr_kind == "cosine":
        frac = np.clip((s - f32(tc.warmup))
                       / f32(max(tc.lr_total - tc.warmup, 1)),
                       f32(0.0), f32(1.0))
        base = f32(0.5 * tc.lr) * (f32(1.0) + np.cos(f32(math.pi) * frac))
    else:
        base = f32(tc.lr)
    if tc.warmup and s < tc.warmup:
        base = f32(tc.lr) * (s + f32(1.0)) / f32(tc.warmup)
    return float(f32(base))


def make_optimizer(tc: TrainConfig):
    if tc.optimizer == "adamw":
        return adamw(weight_decay=0.0)
    if tc.optimizer == "sgdm":
        return sgd(momentum=0.9)
    return sgd()


# ---------------------------------------------------------------------------
# state


def init_state(generator, cfg: ArchConfig, tc: TrainConfig,
               max_pos: int = 32768, n_agents: int = 1, device="cuda",
               mesh=None) -> Dict[str, Tree]:
    """Parameters from ``generator`` (``init_model``), the optimizer
    state, ``step`` (a host int32 scalar) and, for the stale and
    quantized modes, the per-agent ledger and error rows. With ``mesh``
    those rows are this rank's share of the ``n_agents`` (one row where
    every dp rank is one agent, as on the general path)."""
    device = resolve_device(device)
    params = init_model(generator, cfg, device=device, max_pos=max_pos)
    rows = n_agents // n_agents_of(mesh) if mesh is not None else n_agents
    state = {"params": params, "opt": make_optimizer(tc).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if tc.mode == "stale":
        # one flat (rows, P) f32 buffer per run, built through the same
        # ledger_zeros as GradLedger, so the (n, P) layout exists once
        state["ledger"] = {
            "g": ledger_zeros(rows, params, device),
            "ts": torch.full((rows,), -1, dtype=torch.int32, device=device),
        }
    if tc.mode == "quantized":
        state["err"] = tree_map(
            lambda p: torch.zeros((rows,) + tuple(p.shape),
                                  dtype=torch.float32, device=device), params)
    return state


# ---------------------------------------------------------------------------
# loss


def make_loss_fn(cfg: ArchConfig, tc: TrainConfig, moe_groups: int):
    def loss_fn(params, batch):
        logits, aux, _ = apply_model(
            params, batch["tokens"], cfg, mode="train",
            enc_embed=batch.get("enc_embed"), moe_groups=moe_groups,
            remat_policy=tc.remat_policy)
        return lm_loss(logits, batch["targets"], batch["weights"], aux,
                       aux_coef=tc.aux_coef)
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``; grads in the tree and
    dtypes of ``params`` (a leaf the loss does not reach gets zeros)."""
    leaves, spec = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(spec, xs), batch)
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for g, x in zip(gs, xs)]
    return loss.detach(), tree_unflatten(spec, gs)


# ---------------------------------------------------------------------------
# masked fast path


def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    moe_groups: int = 1) -> Callable:
    """Algorithm 1 / synchronous step: ``step(state, batch) -> (state,
    {"loss", "grad_norm"})``. ``batch["weights"]`` carries the agent mask
    (zeros for dropped stragglers)."""
    resolve_mode(tc.mode)               # fail fast on unknown modes
    opt = make_optimizer(tc)
    loss_fn = make_loss_fn(cfg, tc, moe_groups)

    def step(state, batch):
        if tc.accum_steps > 1:
            # microbatch accumulation: the batch splits along dim 0 into
            # accum_steps slices run in turn; gradients average
            k = tc.accum_steps
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                            state["params"])
            lsum = torch.zeros((), dtype=torch.float32)
            for i in range(k):
                mb = {key: (x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
                            if x.dim() else x) for key, x in batch.items()}
                l, g = value_and_grad(loss_fn, state["params"], mb)
                gsum = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                gsum, g)
                lsum = lsum + l.to(lsum.device)
            grads = tree_map(lambda g, p: (g / k).to(p.dtype), gsum,
                             state["params"])
            loss = lsum / k
        else:
            loss, grads = value_and_grad(loss_fn, state["params"], batch)
        if tc.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        else:
            gnorm = torch.sqrt(C.tree_sq_norm(grads))
        s = int(state["step"])
        updates, new_opt = opt.update(grads, state["opt"], state["params"], s)
        params = apply_updates(state["params"], updates, lr_at(tc, s))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        for key in ("ledger", "err"):
            if key in state:
                new_state[key] = state[key]
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


# ---------------------------------------------------------------------------
# general path (every rank of a mesh, one agent per dp rank)


def make_general_step(cfg: ArchConfig, tc: TrainConfig, mesh,
                      moe_groups: int = 1) -> Callable:
    """Per-agent gradient paths: cge / stale / trimmed / quantized.

    ``step(state, batch, fresh_mask (n_agents,)) -> (state, metrics)``,
    called on every rank with the same global ``batch`` and mask: the
    rank takes its agent's block of the batch (dim 0, agent-contiguous,
    as ``data.partition.agent_of_example`` lays it out), and its state
    holds its agent's ledger and error rows (``init_state(...,
    mesh=mesh)``). The loss and metrics are the same on every rank.
    """
    opt = make_optimizer(tc)
    dp = dp_axis_names(mesh)
    n = n_agents_of(mesh)
    if mesh.axis_size(tuple(a for a in mesh.axis_names
                            if a not in dp)) != 1:
        raise ValueError("the general step replicates parameters over the "
                         f"model axes: want model = 1, got {mesh.shape}")
    rule = resolve_mode(tc.mode)        # the one dispatch point (registry)
    loss_fn = make_loss_fn(cfg, tc, max(moe_groups // n, 1))
    me = C.agent_index(dp, mesh=mesh)

    def psum(x):
        return C.psum_all(x, dp, mesh=mesh)

    def step(state, batch, fresh_mask):
        dev = mesh.device
        local = {}
        for key, x in batch.items():
            if x.dim():
                per = x.shape[0] // n
                x = x[me * per:(me + 1) * per]
            local[key] = x
        mask_self = torch.as_tensor(
            np.asarray(fresh_mask, np.float32)[me], device=dev)
        loss, grads = value_and_grad(loss_fn, state["params"], local)
        loss = loss.to(dev)

        if tc.mode == "cge":
            agg, keep = rule.collective(grads, mask_self > 0, tc.f, dp,
                                        mesh=mesh)
            denom = torch.sum(keep.to(torch.float32))
        elif tc.mode == "trimmed":
            agg = rule.collective(grads, mask_self > 0, tc.f, dp, mesh=mesh)
            denom = (torch.ones((), device=dev) if rule.normalized
                     else psum(mask_self))
        elif tc.mode == "stale":
            layout = layout_of(grads)
            step_t = torch.as_tensor(int(state["step"]), dtype=torch.int32,
                                     device=dev)
            fresh = bool(mask_self > 0)
            new_ts = step_t if fresh else state["ledger"]["ts"][0]
            usable = ((step_t - new_ts) <= tc.tau).to(torch.float32)
            contrib = (layout.flatten(grads) if fresh
                       else state["ledger"]["g"][0])
            agg = layout.unflatten(rule.collective(contrib, usable, dp,
                                                   mesh=mesh),
                                   dtype=torch.float32)
            denom = psum(usable)
            new_ledger = {"g": contrib[None], "ts": new_ts.reshape(1)}
        elif tc.mode == "quantized":
            err_self = tree_map(lambda e: e[0], state["err"])
            agg, new_err = rule.collective(grads, mask_self, err_self, dp,
                                           mesh=mesh)
            denom = psum(mask_self)
        else:
            raise ValueError(tc.mode)
        loss = psum(loss * mask_self)

        denom = torch.clamp(denom, min=1.0)
        agg = tree_map(lambda g: g / denom, agg)
        loss = loss / denom
        if tc.clip_norm:
            agg, gnorm = clip_by_global_norm(agg, tc.clip_norm)
        else:
            gnorm = torch.sqrt(C.tree_sq_norm(agg))
        agg = tree_map(lambda a, p: a.to(p.dtype), agg, state["params"])
        s = int(state["step"])
        updates, new_opt = opt.update(agg, state["opt"], state["params"], s)
        params = apply_updates(state["params"], updates, lr_at(tc, s))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        if tc.mode == "stale":
            new_state["ledger"] = new_ledger
        elif "ledger" in state:
            new_state["ledger"] = state["ledger"]
        if tc.mode == "quantized":
            new_state["err"] = tree_map(lambda e: e[None], new_err)
        elif "err" in state:
            new_state["err"] = state["err"]
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step
