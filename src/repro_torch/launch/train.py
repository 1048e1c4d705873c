"""Training step factories (counterpart of ``repro.launch.train``) — the
paper's technique as a training step.

Two paths:

1. ``masked`` (default) and ``sync``: Algorithm 1 via per-token loss
   weights. The host (straggler oracle / telemetry) zeroes the weights
   of the r masked agents' examples, so their gradients vanish from the
   one bulk gradient: dropping a straggler costs no extra collective.
   One process, or, *placed* (``param_specs=``), every rank of a mesh: the
   reference's FSDP storage (each rank holds its block of every parameter
   and moment, ``place_state``), each period's parameters gathered just
   before it runs to the reference's compute layout
   (``dist.sharding.compute_rules``), the gradients reduced back to the
   blocks by the gather's backward. Every registered family (the
   attention decoders, GQA or MLA, the Mamba hybrid jamba, RWKV-6 and
   whisper's encoder-decoder, dense or MoE: ``dist.tp.tp_compute``)
   computes tensor-parallel over the step's ``tp`` axes (``dist.tp``):
   column weights keep this rank's fan-out, row weights its fan-in, the
   embedding its model columns, an MoE block this rank's experts, MLA its
   latents' columns and its heads, Mamba a block of its inner width,
   RWKV its weights' columns and a head group's WKV scan, whisper's
   encoder and cross-attention their heads, the loss its vocabulary
   block where the vocabulary splits.

2. ``general`` (:func:`make_general_step`, every rank of a mesh whose dp
   axes carry one agent per dp coordinate): per-agent gradients per dp
   rank, enabling
   - ``cge``        the two-phase CGE filter (one norm per agent
                    all-reduced, then a masked all-reduce),
   - ``stale``      rule (15) with the agent's ledger row on its rank,
   - ``trimmed``    the coordinate-wise trimmed mean,
   - ``quantized``  int8 error-feedback compressed aggregation.
   Parameters and optimizer state are replicated over dp: every dp rank
   applies the same update to the same values. On a mesh whose other
   ("model") axes hold more than one rank, the step computes
   tensor-parallel over them on the reference's compute layout
   (``place_general_state``: each rank its tp blocks of the parameters
   and moments, its agent's ledger and error rows whole). The
   reference's "model" axis is
   GSPMD-automatic and leaves the numbers unchanged, and so does this
   one's.

Gradients come from ``torch.autograd`` on the reference's loss; the
optimizer and clipping arithmetic are ``repro_torch.optim.optimizers``'.
Every entry point runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.core.ledger import (layout_of, ledger_dim, ledger_zeros,
                                     tree_flatten, tree_map, tree_unflatten)
from repro_torch.device import resolve as resolve_device
from repro_torch.dist import collectives as C
from repro_torch.dist.act_sharding import _norm_axes, act_policy, placement
from repro_torch.dist.registry import resolve_mode
from repro_torch.dist.sharding import (MeshRules, Placement, _rebuild,
                                       _spec_axes, _split_axes, _zip_specs,
                                       batch_specs, block_slices,
                                       bytes_per_rank, compute_rules,
                                       full_shape, shard_tree, tree_specs)
from repro_torch.dist.tp import TP, tp_context, tp_compute, tp_sq_norm
from repro_torch.launch.mesh import dp_axis_names, n_agents_of
from repro_torch.models.model import apply_model, init_model, lm_loss
from repro_torch.optim.optimizers import (adamw, apply_updates,
                                          clip_by_global_norm, clip_to_norm,
                                          sgd)

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


def _load_cosf():
    name = ctypes.util.find_library("m")
    if name is None:
        raise OSError("the C math library (libm) was not found: lr_at's "
                      "cosine needs its cosf")
    fn = ctypes.CDLL(name).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


_cosf = _load_cosf()


def lr_at(tc: TrainConfig, step) -> float:
    """The step size at ``step``, bit for bit the reference's f32 value.

    Every operation rounds to f32 as the reference's does. Its cosine is
    XLA's f32 ``cos``, which on the CPU gives the C library's ``cosf``
    bit for bit; numpy's and torch's f32 cosines are other polynomials
    (each differs from it at some arguments by a few ulps, up to tens
    near the horizon, where 1 + cos cancels). So the cosine here is
    ``cosf`` itself, called on the f32 argument."""
    f32 = np.float32
    s = f32(int(step))
    if tc.lr_kind == "inv_t":
        base = f32(tc.lr) / (s + f32(1.0))
    elif tc.lr_kind == "cosine":
        frac = np.clip((s - f32(tc.warmup))
                       / f32(max(tc.lr_total - tc.warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(_cosf(f32(math.pi) * frac))
        base = f32(0.5 * tc.lr) * (f32(1.0) + cos)
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


def abstract_state(cfg: ArchConfig, tc: TrainConfig, max_pos: int = 32768,
                   n_agents: int = 1) -> Dict[str, Tree]:
    """``init_state`` on the meta device: every leaf's shape and dtype,
    no storage, no generator draws (the reference's ``jax.eval_shape``)."""
    return init_state(None, cfg, tc, max_pos=max_pos, n_agents=n_agents,
                      device="meta")


# ---------------------------------------------------------------------------
# placement of the train state (the reference's FSDP storage)


def state_rules(mesh_shape: Dict[str, int]) -> MeshRules:
    """The storage rules of a mesh of axis sizes ``mesh_shape``: the
    reference's defaults (fsdp over "data", tp over "model")."""
    return MeshRules(axis_sizes=dict(mesh_shape))


def place_state(state: Dict[str, Tree], mesh) -> Tuple[Dict[str, Tree],
                                                       Dict[str, Tree]]:
    """(this rank's block of every leaf of ``state``, the specs):
    ``tree_specs(state, state_rules(mesh.shape))``, under which
    parameters, AdamW moments and SGD momentum share each parameter's
    spec. ``dist.sharding.gather_tree`` is the way back."""
    specs = tree_specs(state, state_rules(mesh.shape))
    return shard_tree(state, specs, mesh), specs


def general_tp_axes(cfg: ArchConfig, mesh) -> Tuple[str, ...]:
    """The axes the general step of ``cfg`` computes tensor-parallel
    over on ``mesh``: its axes other than dp that hold more than one
    rank, for a family ``dist.tp.tp_compute`` admits (every registered
    one); none for another, which would compute whole on every rank."""
    if not tp_compute(cfg):
        return ()
    dp = dp_axis_names(mesh)
    return tuple(a for a in mesh.axis_names
                 if a not in dp and mesh.shape[a] > 1)


def general_specs(cfg: ArchConfig, tree: Tree, mesh) -> Tree:
    """The general step's layout of a parameter-shaped ``tree`` (whole
    leaves): the reference's compute layout, ``tree_specs(tree,
    compute_rules(...))`` over :func:`general_tp_axes` (TP blocks,
    replicated over dp); every leaf whole where there are none."""
    return tree_specs(tree, compute_rules(
        mesh.shape, dp_axes=dp_axis_names(mesh),
        tp_axes=general_tp_axes(cfg, mesh)))


def place_general_state(state: Dict[str, Tree], mesh,
                        cfg: ArchConfig) -> Dict[str, Tree]:
    """This rank's share of a general step's state (``init_state(...,
    mesh=mesh)``: its agent's ledger and error rows) as the reference's
    dry run lays it out: parameters and optimizer moments in the compute
    layout (:func:`general_specs`: tensor-parallel blocks over "model"),
    ``ledger`` and ``err`` this agent's rows whole on every
    model rank, ``step`` as it is. With model = 1 the state comes back
    as it is."""
    out = dict(state)
    for key in ("params", "opt"):
        out[key] = shard_tree(state[key],
                              general_specs(cfg, state[key], mesh), mesh)
    return out


def state_bytes_per_rank(cfg: ArchConfig, tc: TrainConfig,
                         sizes: Dict[str, int],
                         max_pos: int = 32768) -> Dict[str, int]:
    """Bytes of parameters and optimizer moments one rank holds under the
    storage specs (:func:`state_rules`) on a mesh of axis ``sizes``,
    beside the whole state's: from :func:`abstract_state` on the meta
    device, no allocation, for any config and mesh."""
    state = abstract_state(cfg, tc, max_pos=max_pos)
    specs = tree_specs(state, state_rules(sizes))
    out = {k: bytes_per_rank(state[k], specs[k], sizes)
           for k in ("params", "opt")}
    out["total"] = out["params"] + out["opt"]
    out["whole"] = sum(bytes_per_rank(state[k], specs[k], {})
                       for k in ("params", "opt"))
    return out


# ---------------------------------------------------------------------------
# loss


def _policy(dp, tp, sizes):
    return (act_policy(dp, tp, sizes) if (dp is not None or tp is not None)
            else contextlib.nullcontext())


def make_loss_fn(cfg: ArchConfig, tc: TrainConfig, moe_groups: int,
                 dp=None, tp=None, sizes=None):
    """The reference's loss (``lm_loss`` of a train forward), under
    ``act_policy(dp, tp, sizes)`` where dp or tp is given."""
    def loss_fn(params, batch):
        with _policy(dp, tp, sizes):
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


def _microbatch(batch, i: int, k: int):
    """Microbatch ``i`` of ``k``: every batched leaf's rows [i n/k, (i+1)
    n/k) of its n, as the reference's scan slices them."""
    return {key: (x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
                  if x.dim() else x) for key, x in batch.items()}


def _f32_zeros(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _device_of(tree) -> torch.device:
    return tree_flatten(tree)[0][0].device


# ---------------------------------------------------------------------------
# masked fast path


def make_train_step(cfg: ArchConfig, tc: TrainConfig, moe_groups: int = 1,
                    dp=None, tp=None, param_specs=None, sizes=None,
                    mesh=None) -> Callable:
    """Algorithm 1 / synchronous step: ``step(state, batch) -> (state,
    {"loss", "grad_norm"})``. ``batch["weights"]`` carries the agent mask
    (zeros for dropped stragglers). ``dp``, ``tp`` and ``sizes`` install
    the activation policy (``dist.act_sharding``) around the forward.

    With ``param_specs`` (the parameters' storage specs, ``place_state``'s
    ``specs["params"]``) the step is *placed* on ``mesh``: called on every
    rank with the same global batch and this rank's blocks of the state
    (``place_state``), it takes its dp block of the batch, gathers the
    parameters period by period and returns this rank's blocks of the new
    state. The reference passes its compute layout here and lets GSPMD
    derive storage from the state's shardings; the port has no
    partitioner, so the gather reads the storage specs and brings each
    block to its block of the compute layout, ``tree_specs(params,
    compute_rules(...))`` over the ``tp`` axes (checked at the first
    step): tensor-parallel for every family ``dist.tp.tp_compute``
    admits, whole where ``tp`` is None."""
    resolve_mode(tc.mode)               # fail fast on unknown modes
    opt = make_optimizer(tc)
    if param_specs is not None:
        return _make_placed_step(cfg, tc, moe_groups, opt, dp, tp,
                                 param_specs, sizes, mesh)
    loss_fn = make_loss_fn(cfg, tc, moe_groups, dp=dp, tp=tp, sizes=sizes)

    def step(state, batch):
        with spans.span("train.grad"):
            if tc.accum_steps > 1:
                # microbatch accumulation: the batch splits along dim 0
                # into accum_steps slices run in turn; gradients average
                k = tc.accum_steps
                gsum = _f32_zeros(state["params"])
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=_device_of(state["params"]))
                for i in range(k):
                    l, g = value_and_grad(loss_fn, state["params"],
                                          _microbatch(batch, i, k))
                    gsum = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                    gsum, g)
                    lsum = lsum + l
                grads = tree_map(lambda g, p: (g / k).to(p.dtype), gsum,
                                 state["params"])
                loss = lsum / k
            else:
                loss, grads = value_and_grad(loss_fn, state["params"], batch)
        with spans.span("train.update", device=batch["tokens"].is_cuda):
            if tc.clip_norm:
                grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
            else:
                gnorm = torch.sqrt(C.tree_sq_norm(grads))
            s = int(state["step"])
            updates, new_opt = opt.update(grads, state["opt"],
                                          state["params"], s)
            params = apply_updates(state["params"], updates, lr_at(tc, s))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        for key in ("ledger", "err"):
            if key in state:
                new_state[key] = state[key]
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def _make_placed_step(cfg, tc, moe_groups, opt, dp, tp, param_specs, sizes,
                      mesh) -> Callable:
    """The masked step on every rank of ``mesh`` over FSDP storage.

    - The loss is the global one split by rank: ``sum_local(w * xent) /
      max(sum_all(w), 1)``, the weight sum all-reduced over dp before the
      backward, and MoE's aux (a mean over dispatch groups) scaled by
      this rank's share of the groups; the gradients summed over dp are
      then the global gradient.
    - The gather's backward holds each dp-reduced gradient leaf in its
      compute block for a moment before slicing; the global norm for
      clipping is taken there: the squares of the leaves whole on every
      rank once, those of the tp-split leaves summed over tp (one scalar
      all-reduce), the same on every rank (on a one-rank mesh, where the
      blocks are whole, from the blocks as ``make_train_step`` takes
      it).
    - With ``accum_steps`` k > 1 the step runs the reference's
      microbatch scan as its compiled program does: the parameters are
      gathered once, outside autograd, before the k microbatches; each
      microbatch (the global rows [i B/k, (i+1) B/k), this rank its dp
      block of them, which must split over dp) has its own weight sum,
      loss all-reduce and MoE groups, and its gradient is reduced over dp
      in one all-reduce (``Placement.reduce``) to the storage blocks, in
      the parameters' dtype. The blocks' gradients sum in f32 (an
      accumulator of f32 storage blocks: 4 bytes a parameter over the
      ranks that split it), divide by k and cast; the global norm is
      then the accumulated blocks' (``Placement.storage_sq_norm``: one
      scalar all-reduce over the mesh).
    - The optimizer and ``apply_updates`` are elementwise, so they run on
      the blocks as they are."""
    if mesh is None:
        raise ValueError("param_specs places the step on a mesh: pass mesh=")
    dp_axes = _norm_axes(dp) if dp is not None else dp_axis_names(mesh)
    n_dp = mesh.axis_size(dp_axes)
    if cfg.moe is not None and moe_groups % n_dp:
        raise ValueError(f"moe_groups={moe_groups} does not split over "
                         f"{n_dp} dp ranks")
    groups = max(moe_groups // n_dp, 1)
    aux_share = groups / moe_groups
    policy_dp = dp if dp is not None else dp_axes
    rules = MeshRules(axis_sizes=dict(mesh.shape), dp_axes=dp_axes)
    # tensor-parallel compute over the policy's tp axes of the mesh that
    # the batch does not split
    tp_axes = (tuple(a for a in _norm_axes(tp) if mesh.shape.get(a, 1) > 1
                     and a not in dp_axes) if tp_compute(cfg) else ())
    plc = Placement(mesh, dp_axes, tp_axes)
    whole = mesh.size == 1
    split = {a for a in dp_axes if mesh.shape[a] > 1}
    checked = []

    def check_layout(params):
        """The gather's targets are the reference's compute specs, the one
        source of the layout the layers read (checked at the first step)."""
        if checked or not tp_axes:
            return
        pairs = list(_zip_specs(params, param_specs))
        full = _rebuild(params, iter(
            torch.empty(full_shape(sp, l.shape, mesh), device="meta")
            for l, sp in pairs))
        want = tree_specs(full, compute_rules(mesh.shape, dp_axes=dp_axes,
                                              tp_axes=tp_axes))
        for (_, sp), (_, cs) in zip(pairs, _zip_specs(full, want)):
            got = plc.target(sp)
            if ([_split_axes(e, mesh) for e in got]
                    != [_split_axes(e, mesh) for e in cs]):
                raise ValueError(f"storage spec {sp} gathers to {got}, not "
                                 f"the compute spec {cs}")
        checked.append(True)

    def loss_fn(params, batch, denom, specs=param_specs):
        with act_policy(policy_dp, tp, sizes), tp_context(
                mesh if tp_axes else None, tp_axes):
            logits, aux, _ = apply_model(
                params, batch["tokens"], cfg, mode="train",
                enc_embed=batch.get("enc_embed"), moe_groups=groups,
                remat_policy=tc.remat_policy, param_specs=specs)
            return lm_loss(logits, batch["targets"], batch["weights"],
                           aux * aux_share, aux_coef=tc.aux_coef,
                           denom=denom, vocab_size=cfg.vocab_size)

    def dp_block(batch, what):
        """This rank's dp block of ``batch`` (dim 0 over the dp axes)."""
        local = {}
        for key, x in batch.items():
            spec = batch_specs(rules, {key: x})[key]
            if x.dim() and {a for a in _norm_axes(spec[0])
                            if mesh.shape.get(a, 1) > 1} != split:
                raise ValueError(f"{what}[{key!r}] dim 0 ({x.shape[0]}) "
                                 f"does not split over the dp axes "
                                 f"{dp_axes}")
            local[key] = x[block_slices(spec, x.shape, mesh)] if x.dim() \
                else x
        return local

    def denominator(local):
        """max(the weight sum over dp, 1)."""
        return torch.clamp(mesh.all_reduce(
            local["weights"].to(torch.float32).sum(), dp_axes), min=1.0)

    def accumulate(params, batch):
        """(loss, this rank's storage blocks of the gradient) over the
        ``accum_steps`` microbatches, in the reference's order."""
        k = tc.accum_steps
        locals_ = [dp_block(_microbatch(batch, i, k),
                            f"microbatch {i} of accum_steps={k}: batch")
                   for i in range(k)]
        with torch.no_grad():
            gathered = plc.gather(params, param_specs)
        acc = _f32_zeros(params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=_device_of(params))
        for local in locals_:
            denom = denominator(local)
            loss, grads = value_and_grad(
                lambda p, b: loss_fn(p, b, denom, None), gathered, local)
            lsum = lsum + mesh.all_reduce(loss.to(denom.device), dp_axes)
            acc = tree_map(lambda a, g: a + g.to(torch.float32), acc,
                           plc.reduce(grads, param_specs))
            del grads
        del gathered
        return lsum / k, tree_map(lambda a, p: (a / k).to(p.dtype), acc,
                                  params)

    def step(state, batch):
        if tc.accum_steps > 1:
            check_layout(state["params"])
            plc.clear()
            loss, grads = accumulate(state["params"], batch)
        else:
            local = dp_block(batch, "batch")
            denom = denominator(local)
            check_layout(state["params"])
            plc.clear()
            with placement(plc.gather):
                loss, grads = value_and_grad(
                    lambda p, b: loss_fn(p, b, denom), state["params"],
                    local)
            loss = mesh.all_reduce(loss.to(denom.device), dp_axes)
        if whole:
            if tc.clip_norm:
                grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
            else:
                gnorm = torch.sqrt(C.tree_sq_norm(grads))
        else:
            gnorm = torch.sqrt(
                plc.storage_sq_norm(grads, param_specs)
                if tc.accum_steps > 1 else plc.global_sq_norm())
            if tc.clip_norm:
                grads = clip_to_norm(grads, tc.clip_norm, gnorm)
        s = int(state["step"])
        updates, new_opt = opt.update(grads, state["opt"], state["params"], s)
        params = apply_updates(state["params"], updates, lr_at(tc, s))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    step.placement = plc
    return step


# ---------------------------------------------------------------------------
# general path (every rank of a mesh, one agent per dp rank)


class _Blocks:
    """This rank's tensor-parallel blocks of a parameter-shaped tree on the
    general step (:func:`general_specs`), read from the first tree it is
    given: per leaf its spec, the whole shape and the blocks it is split
    into over tp (``groups``, 1: whole on every rank)."""

    def __init__(self, cfg: ArchConfig, mesh, tp_axes: Tuple[str, ...]):
        self.cfg, self.mesh = cfg, mesh
        self.tp = TP(mesh, tp_axes)
        self.specs = None

    def check(self, params: Tree) -> None:
        if self.specs is not None:
            return
        mesh = self.mesh
        # the rules read names and shapes; learned positions (whose length
        # max_pos sets) are whole in every layout
        whole = init_model(None, self.cfg, device="meta", max_pos=8)
        specs = [sp for _, sp in _zip_specs(
            whole, general_specs(self.cfg, whole, mesh))]
        local, self.tree = tree_flatten(params)
        self.full = [full_shape(sp, l.shape, mesh)
                     for l, sp in zip(local, specs)]
        self.groups = [mesh.axis_size(_spec_axes(sp, mesh)) for sp in specs]
        for l, w, full, g in zip(local, tree_flatten(whole)[0], self.full,
                                 self.groups):
            if g > 1 and tuple(full) != tuple(w.shape):
                raise ValueError(
                    f"a parameter block of shape {tuple(l.shape)} is not "
                    f"this rank's compute block of {tuple(w.shape)}: place "
                    "the state with place_general_state")
        self.slices = [block_slices(sp, full, mesh)
                       for sp, full in zip(specs, self.full)]
        self.dtypes = [l.dtype for l in local]
        self.whole = layout_of(tree_unflatten(self.tree, [
            torch.empty(f, dtype=d, device="meta")
            for f, d in zip(self.full, self.dtypes)]))
        self.specs = specs

    def of_whole(self, leaves):
        """This rank's blocks of whole ``leaves`` (views)."""
        return [l[sl] for l, sl in zip(leaves, self.slices)]

    def join(self, leaves) -> torch.Tensor:
        """The whole tree's flat ``(P,)`` f32 vector (the ledger's layout)
        from this rank's blocks ``leaves``, in one ``-0.0``-padded
        all-reduce over tp, bit for bit: each block is written by the
        first rank of the ranks that hold it. The sum runs in the padded
        buffer itself: a whole f32 row is the largest tensor of the step
        (3.6 GB at one layer of arctic's widths)."""
        lay = self.whole
        buf = torch.full((ledger_dim(lay),), -0.0,
                         dtype=torch.float32, device=leaves[0].device)
        for l, sl, full, g, off, sz in zip(leaves, self.slices, self.full,
                                           self.groups, lay.offsets,
                                           lay.sizes):
            if self.tp.leads(g):
                buf[off:off + sz].view(full)[sl] = l.to(torch.float32)
        return self.tp.all_reduce(buf, inplace=True)


def make_general_step(cfg: ArchConfig, tc: TrainConfig, mesh,
                      moe_groups: int = 1) -> Callable:
    """Per-agent gradient paths: cge / stale / trimmed / quantized.

    ``step(state, batch, fresh_mask (n_agents,)) -> (state, metrics)``,
    called on every rank with the same global ``batch`` and mask: the
    rank takes its agent's block of the batch (dim 0, agent-contiguous,
    as ``data.partition.agent_of_example`` lays it out), and its state
    holds its agent's ledger and error rows (``init_state(...,
    mesh=mesh)``). The loss and metrics are the same on every rank.

    Where :func:`general_tp_axes` names axes (a mesh whose "model" axes
    hold more than one rank), the state is ``place_general_state``'s and
    the step is tensor-parallel over them, as the reference's GSPMD runs
    its general step on TP-sharded parameters:

    - the loss runs under ``tp_context`` (no activation policy, as the
      reference's general loss has none), vocabulary-parallel, over the
      agent's own weight sum;
    - the rule's collective runs over dp on this rank's blocks; CGE's
      norm and the quantizer's scale are the whole gradient's
      (``dist.tp.tp_sq_norm`` / ``tp_abs_max``);
    - stale: the masked sum runs on the blocks of ``contrib``, and a
      fresh agent's whole ledger row is its blocks joined over tp (one
      ``-0.0``-padded all-reduce, bit for bit); quantized: the new
      residual row is joined the same way;
    - the clipping norm is the whole aggregate's, and the optimizer runs
      elementwise on the blocks.

    Otherwise the step computes whole, as at model = 1.
    """
    opt = make_optimizer(tc)
    dp = dp_axis_names(mesh)
    n = n_agents_of(mesh)
    rule = resolve_mode(tc.mode)        # the one dispatch point (registry)
    agent_groups = max(moe_groups // n, 1)
    tp_axes = general_tp_axes(cfg, mesh)
    blocks = _Blocks(cfg, mesh, tp_axes) if tp_axes else None
    if blocks is None:
        loss_fn = make_loss_fn(cfg, tc, agent_groups)
    else:
        def loss_fn(params, batch):
            with tp_context(mesh, tp_axes, program="general"):
                logits, aux, _ = apply_model(
                    params, batch["tokens"], cfg, mode="train",
                    enc_embed=batch.get("enc_embed"),
                    moe_groups=agent_groups,
                    remat_policy=tc.remat_policy)
                return lm_loss(logits, batch["targets"], batch["weights"],
                               aux, aux_coef=tc.aux_coef,
                               vocab_size=cfg.vocab_size)
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
        tp = groups = None
        if blocks is not None:
            blocks.check(state["params"])
            tp, groups = blocks.tp, blocks.groups
        loss, grads = value_and_grad(loss_fn, state["params"], local)
        loss = loss.to(dev)

        if tc.mode == "cge":
            agg, keep = rule.collective(grads, mask_self > 0, tc.f, dp,
                                        mesh=mesh, tp=tp, groups=groups)
            denom = torch.sum(keep.to(torch.float32))
        elif tc.mode == "trimmed":
            agg = rule.collective(grads, mask_self > 0, tc.f, dp, mesh=mesh)
            denom = (torch.ones((), device=dev) if rule.normalized
                     else psum(mask_self))
        elif tc.mode == "stale":
            layout = layout_of(grads)
            step_t = torch.as_tensor(int(state["step"]), dtype=torch.int32,
                                     device=dev)
            fresh = bool(np.asarray(fresh_mask, np.float32)[me] > 0)
            new_ts = step_t if fresh else state["ledger"]["ts"][0]
            usable = ((step_t - new_ts) <= tc.tau).to(torch.float32)
            row = state["ledger"]["g"][0]
            if blocks is None:
                contrib = layout.flatten(grads) if fresh else row
                new_row = contrib
            elif fresh:
                contrib = layout.flatten(grads)
                new_row = blocks.join(tree_flatten(grads)[0])
            else:
                contrib = layout.flatten(tree_unflatten(
                    blocks.tree, blocks.of_whole(tree_flatten(
                        blocks.whole.unflatten(row, torch.float32))[0])))
                new_row = row
            agg = layout.unflatten(rule.collective(contrib, usable, dp,
                                                   mesh=mesh),
                                   dtype=torch.float32)
            denom = psum(usable)
            new_ledger = {"g": new_row[None], "ts": new_ts.reshape(1)}
        elif tc.mode == "quantized":
            err_self = tree_map(lambda e: e[0], state["err"])
            if blocks is not None:
                err_self = tree_unflatten(blocks.tree, blocks.of_whole(
                    tree_flatten(err_self)[0]))
            agg, new_err = rule.collective(grads, mask_self, err_self, dp,
                                           mesh=mesh, tp=tp, groups=groups)
            if blocks is not None:
                new_err = blocks.whole.unflatten(
                    blocks.join(tree_flatten(new_err)[0]),
                    dtype=torch.float32)
            denom = psum(mask_self)
        else:
            raise ValueError(tc.mode)
        loss = psum(loss * mask_self)

        denom = torch.clamp(denom, min=1.0)
        agg = tree_map(lambda g: g / denom, agg)
        loss = loss / denom
        gnorm = torch.sqrt(tp_sq_norm(tree_flatten(agg)[0], groups, tp))
        if tc.clip_norm:
            agg = clip_to_norm(agg, tc.clip_norm, gnorm)
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

    step.tp_axes = tp_axes
    return step
