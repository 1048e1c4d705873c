"""SPMD collectives on ``torch.distributed`` — twins of
``repro_torch.core.gradagg`` (counterpart of ``repro.dist.collectives``).

Every function runs on every rank of a :class:`repro_torch.launch.mesh.
Mesh` (passed as ``mesh=``) whose data-parallel axes are ``axes`` (e.g.
``("data",)`` or ``("pod", "data")``). One *agent* = one dp coordinate;
``agent_index`` linearizes the dp coordinates row-major, matching the
agent order of the reference rules and of ledgers with a leading agent
axis sharded over dp. A collective that only some ranks reach hangs the
rest, so every rank calls every function here.

Every collective is an all-reduce (sum). Nothing all-gathers:
``_per_agent``, ``trimmed_mean_all``'s stack and ``ledger_all_rows``
place this rank's values into a buffer of ``-0.0`` and all-reduce it.
``x + (-0.0) == x`` for every f32 ``x`` (``+0.0`` and ``-0.0``
included), so the rebuilt array is bit-identical to the unsharded one,
whatever order the sum runs in. That is also what lets gloo carry CUDA
tensors, where it implements all-reduce and broadcast only.

CGE needs the norm order of all agents but never their gradients: it
all-reduces one scalar per agent and reuses
``gradagg.cge_mask_from_norms``, so the keep-set math exists once. The
trimmed mean needs every agent's value per coordinate, so it rebuilds
the stack, a column block at a time to bound its memory.

*Tensor-parallel blocks.* On the general step of any registered family
over a mesh whose "model" axis is above 1, a rank's gradient tree holds
its tp blocks of the split leaves and the others whole (``dist.tp``).
The sums and the trimmed mean are coordinate-wise, so they run on the
blocks as they are, over dp. The two rules that read
the whole gradient take ``tp=`` (a ``dist.tp.TP``) and ``groups=`` (per
leaf, the blocks it is split into; 1: whole; None: every leaf whole):
CGE's per-agent norm and the quantizer's per-agent scale then come from
``dist.tp.tp_sq_norm`` and ``tp_abs_max``, the same on every tp rank, so
every rank derives the same keep-set and scale. With no ``tp``, or a tp
extent of 1, each is the one-block code bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import gradagg
from repro_torch.core.ledger import layout_of, tree_flatten, tree_unflatten
from repro_torch.dist.tp import tp_abs_max, tp_sq_norm

Tree = Any

# columns of the stack the trimmed mean rebuilds per all-reduce
TRIM_COLUMNS = 1 << 22


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# axis bookkeeping


def axis_count(axes, *, mesh) -> int:
    """Number of agents = product of the dp axis sizes."""
    return mesh.axis_size(_axes(axes))


def agent_index(axes, *, mesh) -> int:
    """Row-major linear agent index of this rank over the dp axes."""
    return mesh.axis_index(_axes(axes))


def psum_all(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    return mesh.all_reduce(x, _axes(axes))


def _neg_zeros(shape, dtype, device) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.full(shape, -0.0, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _per_agent(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """This agent's scalar placed into an (n,) vector replicated on every
    rank (one all-reduce of ``-0.0`` pads; no all-gather)."""
    n = axis_count(axes, mesh=mesh)
    full = _neg_zeros((n,), x.dtype, x.device)
    full[agent_index(axes, mesh=mesh)] = x
    return psum_all(full, axes, mesh=mesh)


def _psum_tree(tree: Tree, scale, axes, *, mesh) -> Tree:
    """f32 sum over the ranks of every leaf times ``scale``, as one
    all-reduce of the flat vector (the tree's cached layout)."""
    layout = layout_of(tree)
    flat = psum_all(layout.flatten(tree) * scale, axes, mesh=mesh)
    return layout.unflatten(flat, dtype=torch.float32)


# ---------------------------------------------------------------------------
# norms


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Local squared L2 norm of a tree (f32 accumulation)."""
    return sum(torch.sum(torch.square(l.to(torch.float32)))
               for l in tree_flatten(tree)[0])


# ---------------------------------------------------------------------------
# aggregation collectives


def masked_psum(tree: Tree, w, axes, *, mesh) -> Tree:
    """SPMD twin of ``agg_sum``: scale the local gradient by this agent's
    mask weight ``w`` (0.0 drops it from S^t) and all-reduce. One
    all-reduce whatever the mask."""
    return _psum_tree(tree, w, axes, mesh=mesh)


def cge_psum(tree: Tree, received, f: int, axes, *, mesh, tp=None,
             groups=None):
    """SPMD twin of ``agg_cge`` (paper eq. (18)), in two phases:
    (1) all-reduce one norm and one received flag per agent,
    (2) every rank derives the identical keep-set from the norm order,
        and the masked all-reduce sums the kept gradients.
    The norm is the whole gradient's (``tp``, ``groups``: the tree's tp
    blocks, as the module says). Returns (aggregate, keep (n,) bool, the
    same on every rank)."""
    my_norm = torch.sqrt(tp_sq_norm(tree_flatten(tree)[0], groups, tp))
    norms = _per_agent(my_norm, axes, mesh=mesh)
    rx = _per_agent(torch.as_tensor(received, dtype=torch.float32,
                                    device=my_norm.device), axes,
                    mesh=mesh) > 0
    keep = gradagg.cge_mask_from_norms(norms, rx, f)
    w = keep[agent_index(axes, mesh=mesh)].to(torch.float32)
    return masked_psum(tree, w, axes, mesh=mesh), keep


def trimmed_mean_all(tree: Tree, received, f: int, axes, *, mesh) -> Tree:
    """SPMD twin of ``agg_trimmed_mean``: rebuild the (n, ...) stack
    (coordinate-wise order statistics need every agent's value), a block
    of ``TRIM_COLUMNS`` columns per all-reduce, and run the reference
    rule on it, column block by column block (the rule is
    coordinate-wise, so the blocks change no value)."""
    leaves, spec = tree_flatten(tree)
    dev = leaves[0].device
    rx = _per_agent(torch.as_tensor(received, dtype=torch.float32,
                                    device=dev), axes, mesh=mesh) > 0
    n = axis_count(axes, mesh=mesh)
    me = agent_index(axes, mesh=mesh)
    out = []
    for leaf in leaves:
        flat = leaf.reshape(-1).to(torch.float32)
        agg = torch.empty_like(flat)
        for c0 in range(0, flat.numel(), TRIM_COLUMNS):
            c1 = min(c0 + TRIM_COLUMNS, flat.numel())
            stack = _neg_zeros((n, c1 - c0), torch.float32, dev)
            stack[me] = flat[c0:c1]
            stack = psum_all(stack, axes, mesh=mesh)
            agg[c0:c1] = gradagg.agg_trimmed_mean(stack, rx, f)
        out.append(agg.reshape(leaf.shape))
    return tree_unflatten(spec, out)


# ---------------------------------------------------------------------------
# sharded-ledger helpers
#
# The dp-sharded ledger keeps each rank's n/dp agent rows as a local
# ``(n_loc, P)`` block; ``ledger_all_rows`` rebuilds the full row-major
# ``(n, ...)`` array on every rank with one all-reduce of ``-0.0`` pads,
# bit-identical to the unsharded array. That is what lets the
# ``combine="gather"`` mode of the sharded ledger reproduce the
# single-buffer device path bit for bit. (Rank-local partial reductions
# + all-reduce are not bit-identical, f32 addition being
# non-associative: the tolerance-checked ``combine="partial"`` mode.)


def shard_row_slice(axes, n: int, *, mesh) -> Tuple[int, int]:
    """(first row index, row count) of this rank's ledger block."""
    n_shards = axis_count(axes, mesh=mesh)
    if n % n_shards:
        raise ValueError(f"n_agents={n} not divisible by {n_shards} shards")
    n_loc = n // n_shards
    return agent_index(axes, mesh=mesh) * n_loc, n_loc


def ledger_all_rows(x_loc: torch.Tensor, axes, n: int, *,
                    mesh) -> torch.Tensor:
    """The full row-major ``(n, ...)`` array from this rank's
    ``(n_loc, ...)`` row block (bit-exact; one all-reduce)."""
    row0, n_loc = shard_row_slice(axes, n, mesh=mesh)
    if x_loc.shape[0] != n_loc:
        raise ValueError(
            f"local row block has {x_loc.shape[0]} rows, want {n_loc}")
    full = _neg_zeros((n,) + tuple(x_loc.shape[1:]), x_loc.dtype,
                      x_loc.device)
    full[row0:row0 + n_loc] = x_loc
    return psum_all(full, axes, mesh=mesh)


def quantized_psum(tree: Tree, w, err: Tree, axes, *, mesh, tp=None,
                   groups=None):
    """SPMD twin of ``agg_quantized`` with error feedback: add the carried
    residual, quantize the whole local gradient to int8 against one
    per-agent scale (wire format: 1 byte/param + one f32 scale),
    all-reduce the dequantized masked contributions, keep the new
    residual locally. A masked-out agent (w == 0) folds the whole unsent
    gradient-plus-residual into its residual, so nothing is dropped.
    ``err`` is in the tree's layout; the scale is the whole gradient's
    (``tp``, ``groups``: the tree's tp blocks, as the module says).
    Returns (aggregate, new_err)."""
    leaves, spec = tree_flatten(tree)
    x = [g.to(torch.float32) + e.to(torch.float32)
         for g, e in zip(leaves, tree_flatten(err)[0])]
    amax = tp_abs_max(x, groups, tp)
    scale = torch.clamp(amax / 127.0, min=1e-30)
    deq = [torch.clamp(torch.round(l / scale), -127.0, 127.0) * scale
           for l in x]
    w = torch.as_tensor(w, dtype=torch.float32, device=scale.device)
    agg = masked_psum(tree_unflatten(spec, deq), w, axes, mesh=mesh)
    new_err = [torch.where(w > 0, l - d, l) for l, d in zip(x, deq)]
    return agg, tree_unflatten(spec, new_err)
