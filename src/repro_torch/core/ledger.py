"""Device-resident gradient ledger + cached flat layouts.

The host reference engine rebuilds a fresh ``(n, P)`` stack every
iteration and runs the GradAgg rule op by op. This module is the device
twin:

- :class:`FlatLayout`    leaf offsets/shapes/dtypes of a nested
                         dict/list of tensors, computed ONCE per
                         (structure, shapes, dtypes) and cached.
- :class:`GradLedger`    a persistent ``(n_agents, P)`` f32 tensor on the
                         engine's device; uploads are in-place row writes
                         (``index_copy_``) instead of per-step stacking.
- :func:`make_aggregate_apply`  the server iteration over the resident
                         ledger: rule -> step-size scale -> ``project_ball``.

Leaf order is JAX's ``ravel_pytree`` order: dict keys sorted, lists and
tuples in order. A flat vector of the reference therefore lines up with
the port's element by element.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def tree_flatten(tree: Tree) -> Tuple[List[torch.Tensor], Any]:
    """Leaves of nested dicts/lists/tuples (dict keys sorted) and a
    hashable spec that :func:`tree_unflatten` rebuilds the structure from."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves: List[torch.Tensor] = []
        specs = []
        for k in keys:
            sub, spec = tree_flatten(tree[k])
            leaves += sub
            specs.append(spec)
        return leaves, ("dict", tuple(keys), tuple(specs))
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for item in tree:
            sub, spec = tree_flatten(item)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree).__name__, len(tree), tuple(specs))
    return [tree], None


def _build(s, it):
    if s is None:
        return next(it)
    kind, keys, subs = s
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in zip(keys, subs)}
    items = [_build(sub, it) for sub in subs]
    return tuple(items) if kind == "tuple" else items


def tree_unflatten(spec, leaves) -> Tree:
    # a module-level function: a nested recursive closure would be a
    # reference cycle holding ``leaves`` (tensors) until the garbage
    # collector runs, not until the caller drops the tree
    return _build(spec, iter(leaves))


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilt in ``tree``'s structure."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


class FlatLayout:
    """Cached flat view of a nested container of tensors. Offsets, sizes,
    shapes and dtypes are computed once per model via :func:`layout_of`;
    flatten/unflatten are then reshape/cat with static slicing."""

    def __init__(self, spec, shapes, dtypes):
        self.spec = spec
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        off = np.concatenate([[0], np.cumsum(self.sizes)])
        self.offsets = tuple(int(o) for o in off[:-1])
        self.total = int(off[-1])

    def flatten(self, tree: Tree) -> torch.Tensor:
        """Tree (per-agent leaf shapes) -> (P,) f32."""
        leaves, _ = tree_flatten(tree)
        return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def flatten_stack(self, tree: Tree) -> torch.Tensor:
        """Tree with a leading agent axis on every leaf -> (n, P) f32."""
        leaves, _ = tree_flatten(tree)
        n = leaves[0].shape[0]
        return torch.cat([l.reshape(n, -1).to(torch.float32)
                          for l in leaves], dim=1)

    def unflatten(self, flat: torch.Tensor, dtype=None) -> Tree:
        """(P,) -> tree; leaves are views of ``flat`` where the dtype
        already matches (so autograd through them reaches ``flat``)."""
        out = [flat[off:off + sz].reshape(shape).to(dtype or dt)
               for shape, dt, off, sz in zip(self.shapes, self.dtypes,
                                             self.offsets, self.sizes)]
        return tree_unflatten(self.spec, out)

    def unflatten_stack(self, flat: torch.Tensor, dtype=None) -> Tree:
        """(n, P) -> tree with the leading agent axis restored."""
        n = flat.shape[0]
        out = [flat[:, off:off + sz].reshape((n,) + shape).to(dtype or dt)
               for shape, dt, off, sz in zip(self.shapes, self.dtypes,
                                             self.offsets, self.sizes)]
        return tree_unflatten(self.spec, out)


_LAYOUTS: Dict[Tuple, FlatLayout] = {}


def ledger_dim(dim_or_layout_or_tree) -> int:
    """Per-agent flat width P of a ledger, from an int, a
    :class:`FlatLayout`, or a gradient tree."""
    if isinstance(dim_or_layout_or_tree, FlatLayout):
        return dim_or_layout_or_tree.total
    if isinstance(dim_or_layout_or_tree, (int, np.integer)):
        return int(dim_or_layout_or_tree)
    return layout_of(dim_or_layout_or_tree).total


def ledger_zeros(n_agents: int, dim_or_layout_or_tree,
                 device) -> torch.Tensor:
    """The canonical flat ``(n, P)`` f32 ledger buffer."""
    return torch.zeros((int(n_agents), ledger_dim(dim_or_layout_or_tree)),
                       dtype=torch.float32, device=device)


def layout_of(tree: Tree, stacked: bool = False) -> FlatLayout:
    """The cached :class:`FlatLayout` of ``tree``. With ``stacked=True``
    the leaves carry a leading agent axis that the layout strips."""
    leaves, spec = tree_flatten(tree)
    shapes = tuple(tuple(l.shape[1:] if stacked else l.shape)
                   for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    key = (spec, shapes, dtypes)
    layout = _LAYOUTS.get(key)
    if layout is None:
        layout = _LAYOUTS[key] = FlatLayout(spec, shapes, dtypes)
    return layout


# ---------------------------------------------------------------------------
# the persistent device ledger


class GradLedger:
    """Persistent ``(n_agents, P)`` f32 tensor of per-agent gradients on
    ``device``. One instance lives for the whole server run; uploads are
    in-place row writes, so the server never re-stacks the full ledger.
    Callers must not hold views of ``data`` across an ``upload``."""

    def __init__(self, n_agents: int, dim_or_layout, device):
        if isinstance(dim_or_layout, FlatLayout):
            self.layout: Optional[FlatLayout] = dim_or_layout
        else:
            self.layout = None
        self.device = torch.device(device)
        self.n_agents = int(n_agents)
        self.dim = ledger_dim(dim_or_layout)
        self.data = ledger_zeros(self.n_agents, self.dim, self.device)

    def upload(self, idx, rows) -> None:
        """Write ``rows (k, P)`` into agent rows ``idx (k,)``."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size == 0:
            return
        if isinstance(rows, torch.Tensor):
            rows = rows.to(self.device, torch.float32)
        else:
            rows = torch.from_numpy(
                np.asarray(rows, np.float32)).to(self.device)
        self.data.index_copy_(0, torch.from_numpy(idx).to(self.device),
                              rows.reshape(idx.size, self.dim))

    def upload_row(self, j: int, row) -> None:
        self.upload(np.array([j], np.int64),
                    row[None] if isinstance(row, torch.Tensor)
                    else np.asarray(row, np.float32)[None])

    def upload_tree(self, j: int, tree: Tree) -> None:
        """Write one agent's gradient tree through the cached layout."""
        if self.layout is None:
            raise ValueError("ledger was built without a FlatLayout")
        self.upload_row(j, self.layout.flatten(tree))

    def front_for_aggregate(self) -> torch.Tensor:
        """The buffer the aggregate consumes this iteration (the live
        buffer itself; a double-buffered ledger would swap here)."""
        return self.data

    # -- checkpointing ---------------------------------------------------
    def host(self) -> np.ndarray:
        """Host f32 copy (snapshot form; restoring it is bit-exact)."""
        return self.data.cpu().numpy().copy()

    def load(self, arr) -> None:
        self.data = torch.from_numpy(
            np.array(arr, np.float32, copy=True)).to(self.device)


# ---------------------------------------------------------------------------
# the server iteration


def make_aggregate_apply(rule: str, f: int, gamma: float) -> Callable:
    """The server iteration over a resident ledger:

        x' = project_ball(x - eta * GradAgg(g, received), gamma)

    Signature: ``(x (P,) f32, g (n, P) f32, received (n,) bool, eta)``,
    all tensors on one device. The rule is the registry's ``bind_device``
    twin, which reaches the CUDA kernels for CUDA tensors. Nothing leaves
    the device: the caller decides when to read ``x`` back.
    """
    from repro_torch.core import gradagg            # projection exists once
    from repro_torch.dist.registry import get_rule  # dist sits above core
    dev = get_rule(rule).bind_device(f)

    def step(x, g, received, eta):
        agg = dev(g, received).to(torch.float32)
        # eta rounded to f32 first, as the reference's jnp.float32(eta)
        return gradagg.project_ball(x - float(np.float32(eta)) * agg, gamma)

    return step


class ShardedGradLedger(GradLedger):
    """Double-buffered ``(n, P)`` ledger sharded over the dp axes of a
    :class:`repro_torch.launch.mesh.Mesh`: each rank holds its ``n/dp``
    agent rows as a local ``(n_loc, P)`` block, in row-major agent order
    (the linearization of ``collectives.agent_index``). Every rank runs
    the same host code and sees every upload; a row lands only on the
    rank that owns it.

    Double-buffer swap protocol. Invariant: the buffer uploads currently
    target (``_bufs[_cur]``) holds *every* upload ever made, so
    ``host()`` is exact at any instant, mid-swap included.

    - ``upload``              writes this rank's rows into ``_bufs[_cur]``
                              and logs them in ``pending``.
    - ``front_for_aggregate`` returns ``_bufs[_cur]`` as the aggregation
                              front, replays ``pending`` into the other
                              buffer and makes it the upload target.

    The two buffers are independent tensors (distinct storage), after
    ``__init__`` and after ``load``: the aggregate reads the front while
    later uploads write the back. ``host()`` and ``load()`` are
    collectives (every rank calls them).
    """

    def __init__(self, n_agents: int, dim_or_layout, device, *, mesh, axes):
        from repro_torch.device import resolve as resolve_device
        from repro_torch.dist import collectives as C   # dist sits above core
        self.layout = (dim_or_layout if isinstance(dim_or_layout, FlatLayout)
                       else None)
        self.device = resolve_device(device)
        self.n_agents = int(n_agents)
        self.dim = ledger_dim(dim_or_layout)
        self.mesh = mesh
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n_shards = mesh.axis_size(self.axes)
        if self.n_agents % n_shards:
            raise ValueError(
                f"n_agents={self.n_agents} not divisible by the "
                f"{n_shards}-way dp sharding over axes {self.axes}")
        self.row0, self.n_loc = C.shard_row_slice(self.axes, self.n_agents,
                                                  mesh=mesh)
        self._bufs = [ledger_zeros(self.n_loc, self.dim, self.device)
                      for _ in range(2)]
        self._cur = 0
        self._pending: list = []
        self.swaps = 0

    # ``data`` stays the public name of the authoritative (local) block
    @property
    def data(self) -> torch.Tensor:
        return self._bufs[self._cur]

    def upload(self, idx, rows) -> None:
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size == 0:
            return
        mine = (idx >= self.row0) & (idx < self.row0 + self.n_loc)
        if not mine.any():
            return
        if isinstance(rows, torch.Tensor):
            rows = rows.reshape(idx.size, self.dim)[
                torch.from_numpy(np.nonzero(mine)[0])]
            rows = rows.to(self.device, torch.float32)
        else:
            rows = torch.from_numpy(np.asarray(rows, np.float32).reshape(
                idx.size, self.dim)[mine]).to(self.device)
        loc = torch.from_numpy(idx[mine] - self.row0).to(self.device)
        self._bufs[self._cur].index_copy_(0, loc, rows)
        self._pending.append((loc, rows))

    def front_for_aggregate(self) -> torch.Tensor:
        front = self._bufs[self._cur]
        back = 1 - self._cur
        for loc, rows in self._pending:
            self._bufs[back].index_copy_(0, loc, rows)
        self._pending.clear()
        self._cur = back
        self.swaps += 1
        return front

    def host(self) -> np.ndarray:
        """The whole ``(n, P)`` ledger as host f32, on every rank
        (bit-exact: ``ledger_all_rows``)."""
        from repro_torch.dist import collectives as C
        full = C.ledger_all_rows(self.data, self.axes, self.n_agents,
                                 mesh=self.mesh)
        return full.cpu().numpy().copy()

    def load(self, arr) -> None:
        """Restore both buffers from a whole ``(n, P)`` snapshot (a
        snapshot is a settled ledger: no pending uploads survive)."""
        block = np.array(arr, np.float32, copy=True).reshape(
            self.n_agents, self.dim)[self.row0:self.row0 + self.n_loc]
        self._bufs = [torch.from_numpy(block.copy()).to(self.device)
                      for _ in range(2)]
        self._pending.clear()


def make_sharded_aggregate_apply(rule: str, f: int, gamma: float, mesh,
                                 axes, n_agents: int,
                                 combine: str = "gather") -> Callable:
    """Sharded twin of :func:`make_aggregate_apply` over a dp-sharded
    ledger: the same rule -> step-size scale -> ``project_ball``, but the
    rule is the registry's ``bind_sharded`` twin on this rank's
    ``(n_loc, P)`` block. The iterate and mask are the same on every
    rank, and so is the update computed after the all-reduce.
    Signature: ``(x (P,) f32, g_loc (n_loc, P) f32, received (n,) bool,
    eta)``.
    """
    from repro_torch.core import gradagg
    from repro_torch.dist.registry import get_rule
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    agg_loc = get_rule(rule).bind_sharded(f, axes=axes, n=n_agents,
                                          mesh=mesh, combine=combine)

    def step(x, g_loc, received, eta):
        agg = agg_loc(g_loc, received).to(torch.float32)
        return gradagg.project_ball(x - float(np.float32(eta)) * agg, gamma)

    return step
