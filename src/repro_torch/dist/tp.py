"""Tensor-parallel compute over the mesh's "model" axes: the context the
layers of the attention decoders (GQA or MLA, dense or MoE), of the
Mamba hybrids (jamba), of RWKV-6 and of whisper's encoder-decoder read,
and Megatron's four autograd Functions on its axes (the port's
counterpart of what GSPMD derives for the reference from its compute
layout, ``tree_specs(params, MeshRules(fsdp_axes=()))``).

The placed train step, the general step and ``launch.serve``'s steps
install a :class:`tp_context` (mesh, tp axes) for a config
:func:`tp_compute` accepts; the layers of ``models/layers.py``,
``models/attention.py``, ``models/ssm.py`` (Mamba and RWKV) and
``models/moe.py`` then run on this rank's blocks of the compute layout:

- a column-parallel matmul takes ``copy_to_tp(x)`` (identity forward,
  all-reduce backward) and keeps this rank's block of the fan-out;
- a row-parallel matmul takes this rank's block of the fan-in and sums
  the partial products with ``reduce_from_tp`` (all-reduce forward,
  identity backward);
- ``gather_from_tp`` / ``scatter_to_tp`` change a tensor's layout where
  the reference's constraint points change it (the embedding's model
  columns, a query split across head boundaries, the decode's head_dim,
  the router's logits over the experts, MLA's latents and its
  ``w_uk`` / ``w_uv`` re-laid from a block of every head to whole heads,
  Mamba's ``xz`` re-laid from ``w_in``'s columns to a block of its inner
  width, ``a_log`` from a block of d_state to one of that width,
  RWKV's column outputs gathered whole or to a head group's columns,
  its decode's output from a block of every head's value columns);
- an MoE block computes this rank's experts on the routing every rank
  computes alike, and sums the ranks' partial combines over tp.

Every collective is an all-reduce over the tp axes (gloo's CUDA path
has no other); a gather writes this rank's block into ``-0.0`` pads, so
the sum returns every block exactly. With no context active, or a tp
extent of 1 and no idle dp axes, every function here is the identity, so
one process runs the code it ran before.

*Groups.* Where a dimension of H heads does not split over all n tp
ranks, the reference splits it over gcd(H, n) groups of consecutive
ranks and computes each group's block on all of the group's ranks. The
``groups`` argument says how many such groups a tensor's layout has:
``gather_from_tp(x, dim, groups=g)`` returns the group's block,
``scatter_to_tp(x, dim, groups=g)`` takes it, and ``copy_to_tp(x,
groups=g)`` feeds a computation that the ranks of a group repeat, so
its backward sums one rank of each group.

*Idle dp axes.* A decode whose batch splits over fewer dp axes than
the mesh has (rwkv6's long_500k: a batch of one) leaves the others
idle, and the reference's compiled program splits a dot's fan-in over
them where it holds the dot's input as a block of that fan-in over
"model" (RWKV's projections). ``tp_context(..., idle=)`` names those
axes: :func:`fan_in_dot` takes this rank's block of a weight's fan-in
over them, and a gather with ``partial=True`` sums the partial products
over them in the same ``-0.0``-padded all-reduce that gathers them over
tp (one all-reduce over the idle and the tp axes where the reference
runs an all-reduce over data and a gather over model: the same sums).
With no idle axes both are what they were.

*Norms over blocks.* :func:`tp_sq_norm` and :func:`tp_abs_max` give the
squared L2 norm and the max |x| of a whole tree from this rank's blocks
of its leaves, the same bits on every rank of the tp extent; the placed
step's global norm (``dist.sharding.Placement``) and the general step's
collectives (``dist.collectives``) read them.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch

_STATE = threading.local()


PROGRAMS = ("masked", "general")


class TP:
    """The active tensor-parallel extent: ``mesh``, its ``axes``, their
    ``size`` n and this rank's index ``rank`` over them, and the
    reference ``program`` the layers follow where its two compiled train
    steps split a computation differently: ``"masked"`` (the placed step,
    and serving) or ``"general"`` (the general step). The general step's
    program projects only the KV heads a rank's query heads read also
    where the heads split over fewer groups than ranks, and takes the
    tied unembedding's input gradient from this rank's model columns."""

    __slots__ = ("mesh", "axes", "size", "rank", "program", "idle")

    def __init__(self, mesh, axes: Tuple[str, ...], program: str = "masked",
                 idle: Tuple[str, ...] = ()):
        if program not in PROGRAMS:
            raise ValueError(f"program must be one of {PROGRAMS}, got "
                             f"{program!r}")
        self.mesh, self.axes, self.program = mesh, tuple(axes), program
        self.size = mesh.axis_size(self.axes)
        self.rank = mesh.axis_index(self.axes)
        self.idle = tuple(a for a in idle if mesh.axis_size(a) > 1)

    def block(self, dim: int, parts: Optional[int] = None) -> slice:
        """This rank's block of a dimension of ``dim`` split into
        ``parts`` (n by default) blocks over consecutive rank groups."""
        parts = self.size if parts is None else parts
        if dim % parts or self.size % parts:
            raise ValueError(f"{dim} does not split into {parts} blocks "
                             f"over {self.size} tp ranks")
        b, r = dim // parts, self.rank // (self.size // parts)
        return slice(r * b, (r + 1) * b)

    def leads(self, groups: int) -> bool:
        """Whether this rank is the first of its group of ``n / groups``."""
        return self.rank % (self.size // groups) == 0

    def fan_in(self, n: int) -> slice:
        """This rank's block of a fan-in of ``n`` over the idle dp axes
        (the whole where there are none)."""
        parts = self.mesh.axis_size(self.idle)
        if n % parts:
            raise ValueError(f"a fan-in of {n} does not split over "
                             f"{parts} idle dp ranks")
        b, r = n // parts, self.mesh.axis_index(self.idle)
        return slice(r * b, (r + 1) * b)

    def all_reduce(self, x: torch.Tensor,
                   inplace: bool = False) -> torch.Tensor:
        if inplace:                     # the sum in x itself (Mesh)
            return self.mesh.all_reduce(x, self.axes, inplace=True)
        return self.mesh.all_reduce(x, self.axes)

    def group_reduce(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        """Sum of ``x`` over the ranks of this rank's group, one of
        ``groups`` groups of consecutive tp ranks (no autograd)."""
        return self.mesh.all_reduce(x, self.axes, parts=groups)

    def gather(self, x: torch.Tensor, dim: int, groups: int = 1,
               partial: bool = False) -> torch.Tensor:
        """Every rank's block along ``dim`` -> the ``groups``-way block of
        this rank's group (1: the whole dimension), through one
        ``-0.0``-padded all-reduce (no autograd). With ``partial``, ``x``
        is this rank's partial product over its block of a fan-in split
        over the idle dp axes (:func:`fan_in_dot`): the all-reduce runs
        over those axes too, and so sums the products."""
        axes = self.axes + (self.idle if partial else ())
        if self.mesh.axis_size(axes) == 1:
            return x
        dim = dim % x.dim()
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
        buf.narrow(dim, self.rank * n, n).copy_(x)
        full = self.mesh.all_reduce(buf, axes)
        g = self.block(shape[dim], groups)
        return full.narrow(dim, g.start, g.stop - g.start)

    def keep(self, x: torch.Tensor, dim: int,
             groups: int = 1) -> torch.Tensor:
        """This rank's block of ``x``, the ``groups``-way block of its
        group along ``dim`` (no autograd)."""
        dim = dim % x.dim()
        n = x.shape[dim] * groups // self.size
        off = (self.rank % (self.size // groups)) * n
        return x.narrow(dim, off, n).contiguous()


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def join_sq_norms(sqs: Sequence[torch.Tensor],
                  groups: Optional[Sequence[int]],
                  tp: Optional[TP]) -> torch.Tensor:
    """The squared norm of a whole tree from ``sqs``, the squared norms of
    this rank's blocks of its leaves, each leaf split into ``groups[i]``
    blocks over consecutive rank groups of the tp extent (1: whole on
    every rank, n: a block a rank; None: every leaf whole). Whole leaves
    count once, locally; the split ones are summed over tp in one
    all-reduce, to which only the first rank of each group adds its
    group's block. With no ``tp``, or a tp extent of 1, the plain sum in
    order."""
    if tp is None or tp.size == 1 or groups is None:
        return sum(sqs)
    whole = [s for s, g in zip(sqs, groups) if g == 1]
    split = [s for s, g in zip(sqs, groups) if g > 1 and tp.leads(g)]
    total = sum(whole)
    if any(g > 1 for g in groups):
        part = sum(split) if split else torch.zeros(
            (), dtype=torch.float32, device=sqs[0].device)
        total = total + tp.all_reduce(part)
    return total


def tp_sq_norm(leaves: Sequence[torch.Tensor],
               groups: Optional[Sequence[int]],
               tp: Optional[TP]) -> torch.Tensor:
    """The squared L2 norm (f32 accumulation) of the whole tree of which
    ``leaves`` are this rank's blocks (``groups`` as in
    :func:`join_sq_norms`)."""
    return join_sq_norms([_sq(l) for l in leaves], groups, tp)


def tp_abs_max(leaves: Sequence[torch.Tensor],
               groups: Optional[Sequence[int]],
               tp: Optional[TP]) -> torch.Tensor:
    """max |x| over the whole tree of which ``leaves`` are this rank's
    blocks: the local maximum, then, where a leaf is split, every rank's
    joined through a ``-0.0``-padded sum all-reduce of a tp-length vector
    (the sum is exact and ``Mesh.all_reduce`` has no max) and its
    maximum. A block repeated over a group's ranks changes no maximum."""
    local = torch.max(torch.stack([torch.max(torch.abs(l)) for l in leaves]))
    if tp is None or tp.size == 1 or groups is None or all(
            g == 1 for g in groups):
        return local
    buf = torch.full((tp.size,), -0.0, dtype=local.dtype, device=local.device)
    buf[tp.rank] = local
    return torch.max(tp.all_reduce(buf))


class tp_context:
    """Context manager installing tensor-parallel compute over
    ``tp_axes`` of ``mesh`` (None: none, an explicit off), and the dp
    axes ``idle`` a decode's batch leaves idle (:func:`fan_in_dot`): a
    context where either holds more than one rank."""

    def __init__(self, mesh, tp_axes: Tuple[str, ...] = ("model",),
                 program: str = "masked", idle: Tuple[str, ...] = ()):
        self._val = (None if mesh is None or mesh.axis_size(
            tuple(tp_axes) + tuple(idle)) == 1
            else TP(mesh, tp_axes, program, idle))

    @classmethod
    def of(cls, tp: Optional[TP]) -> "tp_context":
        """Re-install a captured :class:`TP` (or none), on another thread:
        a checkpointed layer recomputes on autograd's."""
        ctx = cls.__new__(cls)
        ctx._val = tp
        return ctx

    def __enter__(self):
        stack = getattr(_STATE, "stack", None)
        if stack is None:
            stack = _STATE.stack = []
        stack.append(self._val)
        return self._val

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def current_tp() -> Optional[TP]:
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def tp_compute(cfg) -> bool:
    """The families this layer of tensor parallelism covers: every layer
    attention (GQA or MLA), Mamba or RWKV-6, with a dense MLP, an MoE
    block (its experts over the expert-parallel axes, ``dist.sharding.
    MeshRules.ep_axes``, which the compute layouts set equal to the tp
    axes) or RWKV's channel mix, and an encoder-decoder's encoder and
    cross-attention: the attention decoders, jamba's hybrid, rwkv6 and
    whisper, every registered family. The one predicate every caller
    reads; a family with another layer kind would compute whole on
    every rank."""
    return all(k in ("attn", "mamba", "rwkv") for k in cfg.layer_pattern)


# ---------------------------------------------------------------------------
# the four Functions


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, groups, x):
        ctx.tp, ctx.groups = tp, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if not tp.leads(ctx.groups):
            g = torch.zeros_like(g)
        return None, None, tp.all_reduce(g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Leads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, groups, x):
        ctx.keep = tp.leads(groups)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, g if ctx.keep else torch.zeros_like(g)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, groups, x):
        ctx.tp, ctx.groups = tp, groups
        return tp.group_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.tp.group_reduce(g, ctx.groups)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, dim, groups, partial, x):
        ctx.tp, ctx.dim, ctx.groups = tp, dim, groups
        return tp.gather(x, dim, groups, partial)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None, ctx.tp.keep(g, ctx.dim, ctx.groups)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, dim, groups, x):
        ctx.tp, ctx.dim, ctx.groups = tp, dim, groups
        return tp.keep(x, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, ctx.tp.gather(g, ctx.dim, ctx.groups)


def copy_to_tp(x: torch.Tensor, groups: Optional[int] = None):
    """Identity forward; the backward all-reduces the gradient over tp,
    one rank of each of ``groups`` groups contributing (all n by
    default): the input of a column-parallel matmul, or of a computation
    the ranks of a group repeat."""
    tp = current_tp()
    if tp is None:
        return x
    return _Copy.apply(tp, tp.size if groups is None else groups, x)


def reduce_from_tp(x: torch.Tensor):
    """All-reduce forward (a row-parallel output's partial products);
    identity backward."""
    tp = current_tp()
    return x if tp is None else _Reduce.apply(tp, x)


def gather_from_tp(x: torch.Tensor, dim: int, groups: int = 1,
                   partial: bool = False):
    """This rank's block along ``dim`` -> its group's block (``groups``
    = 1: the whole dimension) by a ``-0.0``-padded all-reduce; the
    backward keeps this rank's block. ``partial``: ``x`` is a
    :func:`fan_in_dot` product, summed over the idle dp axes too."""
    tp = current_tp()
    return x if tp is None else _Gather.apply(tp, dim, groups, partial, x)


def fan_in_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight ``w`` (fan-in, fan-out) whose fan-in is
    whole on this rank: where the context names idle dp axes, the
    partial product of this rank's block of the fan-in over them (``x``'s
    last dimension and ``w``'s rows), which a ``partial`` gather
    (:func:`gather_from_tp`) sums; with none, ``x @ w``."""
    tp = current_tp()
    if tp is None or not tp.idle:
        return x @ w
    b = tp.fan_in(w.shape[-2])
    return x[..., b] @ w[b]


def scatter_to_tp(x: torch.Tensor, dim: int, groups: int = 1):
    """The group's block along ``dim`` (``groups`` = 1: the whole) ->
    this rank's block; the backward gathers the blocks back."""
    tp = current_tp()
    return x if tp is None else _Scatter.apply(tp, dim, groups, x)


def sum_over_group(x: torch.Tensor, groups: int):
    """The sum of the group's partial values ``x`` over the ranks of this
    rank's group (one of ``groups`` groups of consecutive tp ranks), the
    same on each of them; each rank goes on to use it in its own way, so
    the backward sums the group's gradients alike (partial dot products
    over blocks of a head's head_dim)."""
    tp = current_tp()
    if tp is None or groups == tp.size:
        return x
    return _GroupSum.apply(tp, groups, x)


def lead_only(x: torch.Tensor, groups: int):
    """Identity forward; the backward keeps the gradient on the first rank
    of each of ``groups`` groups and zeroes it on the others (no
    collective): a value the ranks of a group compute alike, whose
    gradient a later ``copy_to_tp`` sums over every rank."""
    tp = current_tp()
    return x if tp is None or groups == tp.size else _Leads.apply(tp, groups,
                                                                  x)
