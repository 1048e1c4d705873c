"""Logical-axis -> mesh-axis resolution and per-dimension axis specs
(counterpart of ``repro.dist.sharding``).

``MeshRules`` names the mesh axes playing each *role* (fsdp / tp / ep /
dp) plus the axis sizes; ``tree_specs`` / ``batch_specs`` /
``cache_specs`` walk trees and emit one *spec* per leaf: a tuple with one
entry per dimension, each None (replicated), an axis name or a tuple of
axis names — the entries of the reference's ``PartitionSpec``, which is
a tuple of the same. A candidate axis group whose size does not divide
the dimension is trimmed from the right (fsdp axes drop before tp axes)
until it fits.

Placement by leaf name, as the reference's:
- column weights (w_gate/w_up/wq/...): fan-out (last) dim <- tp+fsdp
- row weights (w_down/w_out/wo): fan-in <- tp, fan-out <- fsdp
- kv projections (wk/wv): fan-out <- fsdp only (repeat-KV layout)
- MoE expert stacks (4D under "ffn"): expert dim <- ep, last <- fsdp
- embeddings ("tok"): vocab <- fsdp, d_model <- tp
- norms / biases / scalars: replicated

The placed train step stores each leaf of its state as this rank's
block under these specs (:func:`shard_tree`; :func:`gather_tree` is the
inverse) and gathers each block to its block of the compute layout
(:func:`compute_rules`, the reference's ``param_cspecs``: whole leaves
for the families without tensor-parallel compute; :class:`Placement`,
the gather ``act_sharding.constrain_tree`` runs); :func:`bytes_per_rank`
counts what a rank holds. The serving engine splits its page pools by
``cache_specs``' kv-head rule applied to its mesh's own extents
(``kv_head_block``), and ``serve_tp`` carries the mesh and that block to
the attention code.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.tp import TP, join_sq_norms

Tree = Any

# leaves replicated regardless of shape (norm scales, biases, timestamps)
_REPLICATED = {"scale", "bias", "b_in", "b_out", "bq", "bk", "bv",
               "q_norm", "kv_norm", "step", "ts", "u"}
_ROW = {"w_down", "w_out", "wo"}          # row-parallel second matrices
_KV = {"wk", "wv"}                        # repeat-KV projections
_EMBED_POS = {"pos", "enc_pos"}


def _default_sizes(multi_pod: bool) -> Dict[str, int]:
    sizes = {"data": 16, "model": 16}
    if multi_pod:
        sizes["pod"] = 2
    return sizes


@dataclasses.dataclass
class MeshRules:
    """Role -> mesh-axis mapping with divisibility-aware spec building."""
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ("model",)
    ep_axes: Optional[Tuple[str, ...]] = None
    dp_axes: Optional[Tuple[str, ...]] = None
    axis_sizes: Optional[Dict[str, int]] = None
    multi_pod: bool = False
    overrides: Optional[Dict[str, tuple]] = None

    def __post_init__(self):
        self.fsdp_axes = tuple(self.fsdp_axes)
        self.tp_axes = tuple(self.tp_axes)
        if self.axis_sizes is None:
            self.axis_sizes = _default_sizes(self.multi_pod)
        if self.ep_axes is None:
            self.ep_axes = self.tp_axes
        self.ep_axes = tuple(self.ep_axes)
        if self.dp_axes is None:
            self.dp_axes = (("pod", "data")
                            if (self.multi_pod or "pod" in self.axis_sizes)
                            else ("data",))
        self.dp_axes = tuple(self.dp_axes)
        self.overrides = dict(self.overrides or {})

    @property
    def dp(self) -> Tuple[str, ...]:
        return self.dp_axes

    def size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.axis_sizes.get(a, 1)
        return n

    def fit(self, axes: Tuple[str, ...], dim: int):
        """Trim ``axes`` from the right until their product divides
        ``dim``. Returns a spec entry: None, one axis name, or a tuple."""
        axes = tuple(axes)
        while axes and (self.size(axes) == 0 or dim % self.size(axes)):
            axes = axes[:-1]
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes


# ---------------------------------------------------------------------------
# serving TP context
#
# The model code never sees a mesh. The serving engine installs an
# ambient (mesh, tp_axes, kv_block) context around its decode calls; the
# paged decode branches of ``models/attention.py`` consult it and route
# the attention through ``kernels/decode_attention.tp_paged_decode``
# (GQA) or split MLA's absorbed decode over query heads. With no context
# (the replicated engine) the model code runs as before.

_SERVE_TP = threading.local()


class serve_tp:
    """Context manager installing the serving tensor-parallel mesh, its
    tp axes and this rank's KV-head block of the paged pools
    (:func:`kv_head_block`; None where the pools hold every head)."""

    def __init__(self, mesh, tp_axes: Tuple[str, ...] = ("model",),
                 kv_block: Optional[Tuple[int, int]] = None):
        self._val = (mesh, tuple(tp_axes), kv_block)

    def __enter__(self):
        stack = getattr(_SERVE_TP, "stack", None)
        if stack is None:
            stack = _SERVE_TP.stack = []
        stack.append(self._val)
        return self._val

    def __exit__(self, *exc):
        _SERVE_TP.stack.pop()
        return False


def current_serve_tp() -> Optional[Tuple[Any, Tuple[str, ...],
                                         Optional[Tuple[int, int]]]]:
    """(mesh, tp_axes, kv_block) of the active serving TP context, or
    None."""
    stack = getattr(_SERVE_TP, "stack", None)
    return stack[-1] if stack else None


def kv_head_split(tp: int, n_kv_heads: int,
                  n_query_heads: Optional[int]) -> int:
    """The tp extent the page pools' kv-head dim splits over, or 1: the
    full extent ``tp`` where it divides Hkv (and H, when given), else no
    split: ``cache_specs``' predicate, which :func:`kv_head_block`
    applies to a mesh's own tp extent."""
    if (tp > 1 and n_kv_heads % tp == 0
            and (n_query_heads is None or n_query_heads % tp == 0)):
        return tp
    return 1


def kv_head_block(mesh, tp_axes: Tuple[str, ...], n_kv_heads: int,
                  n_query_heads: int) -> Optional[Tuple[int, int]]:
    """This rank's contiguous KV-head block ``(h0, h1)`` of the paged
    pools under the tp extent of ``mesh`` itself, or None where the pools
    stay whole. The one decision the serving engine's pools, the model's
    page append and ``tp_paged_decode`` all read."""
    ts = kv_head_split(mesh.axis_size(tp_axes), n_kv_heads, n_query_heads)
    if ts == 1:
        return None
    hb, r = n_kv_heads // ts, mesh.axis_index(tp_axes)
    return r * hb, (r + 1) * hb


# ---------------------------------------------------------------------------
# tree walking


def _leaves_with_path(tree, path: Tuple[str, ...] = ()):
    """(names, leaf) in the reference's order: dict keys sorted, sequence
    positions as digit strings; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, it) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return next(it)


def _map_with_path(fn, tree):
    specs = [fn(names, leaf) for names, leaf in _leaves_with_path(tree)]
    return _rebuild(tree, iter(specs))


def _used(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


# ---------------------------------------------------------------------------
# parameter / state specs


def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
                rules: MeshRules) -> tuple:
    nd = len(shape)
    name = ""
    for n in reversed(names):
        if not n.isdigit():
            name = n
            break
    if nd == 0:
        return ()
    dims: list = [None] * nd
    if name in _REPLICATED:
        return tuple(dims)
    is_expert = nd == 4 and "ffn" in names and name not in ("shared", "dense")
    if is_expert:
        dims[1] = rules.fit(rules.ep_axes, shape[1])
        free = tuple(a for a in rules.fsdp_axes if a not in _used(dims[1]))
        dims[-1] = rules.fit(free, shape[-1])
    elif name == "tok":
        dims[0] = rules.fit(rules.fsdp_axes, shape[0])
        if nd > 1:
            free = tuple(a for a in rules.tp_axes if a not in _used(dims[0]))
            dims[-1] = rules.fit(free, shape[-1])
    elif name in _EMBED_POS:
        dims[0] = rules.fit(rules.fsdp_axes, shape[0])
    elif nd >= 2 and name in _ROW:
        dims[-2] = rules.fit(rules.tp_axes, shape[-2])
        free = tuple(a for a in rules.fsdp_axes if a not in _used(dims[-2]))
        dims[-1] = rules.fit(free, shape[-1])
    elif nd >= 2 and name in _KV and ("mixer" in names or "cross" in names):
        dims[-1] = rules.fit(rules.fsdp_axes, shape[-1])
    elif nd >= 2:
        dims[-1] = rules.fit(rules.tp_axes + rules.fsdp_axes, shape[-1])
    return tuple(dims)


def tree_specs(tree: Tree, rules: MeshRules) -> Tree:
    """Spec tree for a parameter / train-state tree. Optimizer moments
    and ledgers are classified by the same trailing path names as the
    parameters they mirror."""
    def spec(names, leaf):
        joined = "/".join(names)
        for pat, ov in rules.overrides.items():
            if fnmatch.fnmatch(joined, pat):
                return tuple(ov)
        return _param_spec(names, tuple(leaf.shape), rules)

    return _map_with_path(spec, tree)


# ---------------------------------------------------------------------------
# batch / cache specs


def batch_specs(rules: MeshRules, batch: Tree) -> Tree:
    """Global-batch inputs: leading (batch) dim over the dp axes, the rest
    replicated; indivisible batch dims fall back to replicated."""
    def spec(names, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        dims = [None] * len(shape)
        dims[0] = rules.fit(rules.dp_axes, shape[0])
        return tuple(dims)

    return _map_with_path(spec, batch)


def cache_specs(rules: MeshRules, cache: Tree,
                n_query_heads: Optional[int] = None) -> Tree:
    """Decode/prefill KV and SSM caches.

    Dense caches ``(n_periods, batch, ...)``: batch over dp, the trailing
    (head_dim / state) dim over tp; the stacked leading dim replicated.

    Paged pools (``*_pages``): never batch-sharded. GQA ``k_pages`` /
    ``v_pages`` ``(n_periods, N, PS, n_kv, hd)`` split the kv-head dim
    over tp where the full tp extent divides Hkv and H
    (:func:`kv_head_split`; a tp extent of 1 is named, as the reference
    names it); MLA's latent pools carry no head axis and replicate."""
    def spec(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        if name.endswith("_pages"):
            ts = rules.size(rules.tp_axes)
            if (name in ("k_pages", "v_pages") and len(shape) >= 2
                    and rules.tp_axes and (ts == 1 or kv_head_split(
                        ts, shape[-2], n_query_heads) > 1)):
                dims[-2] = (rules.tp_axes[0] if len(rules.tp_axes) == 1
                            else rules.tp_axes)
            return tuple(dims)
        if len(shape) >= 2:
            dims[1] = rules.fit(rules.dp_axes, shape[1])
        if len(shape) >= 3:
            dims[-1] = rules.fit(rules.tp_axes, shape[-1])
        return tuple(dims)

    return _map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# storage: this rank's block of each leaf, and the way back
#
# A spec entry splits its dimension into equal blocks over its axes,
# row-major in the order the entry lists them (JAX's PartitionSpec
# layout); axes the mesh lacks, or of size 1, do not split. Every entry
# ``tree_specs`` keeps divides its dimension, so blocks are even.
#
# Every collective is an all-reduce. A gather writes the bytes of this
# rank's block into a zero byte buffer of the whole leaves and sums the
# bytes (uint8) over the mesh: a byte plus zeros is that byte, so every
# bit pattern comes back whatever the order of the sum, NaN payloads
# included (a float sum keeps ``-0.0`` pads exact but not NaNs: gloo's
# bf16 sum returns one canonical NaN, and an f32 sum quiets a signalling
# one). Only the ranks at coordinate 0 of every axis a leaf is
# replicated over write it, so no block is counted twice, and all of a
# call's leaves, of any dtype, travel in one all-reduce.

ALIGN = 16          # byte offset of each leaf in a gather's buffer


def _split_axes(entry, mesh) -> Tuple[str, ...]:
    """The axes of a spec entry that split its dimension on ``mesh``."""
    return tuple(a for a in _used(entry) if mesh.shape.get(a, 1) > 1)


def block_slices(spec, shape, mesh) -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` stored under ``spec``."""
    out = []
    for entry, dim in zip(tuple(spec) + (None,) * len(shape), shape):
        axes = _split_axes(entry, mesh)
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"spec entry {entry!r} splits {dim} into "
                             f"{n} uneven blocks")
        size = dim // n
        start = mesh.axis_index(axes) * size
        out.append(slice(start, start + size))
    return tuple(out)


def _spec_axes(spec, mesh) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in _split_axes(e, mesh))


def _zip_specs(tree, specs):
    """(leaf, spec) pairs in ``tree``'s leaf order (dict keys sorted);
    the structure is read from ``tree``, so spec tuples stay leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _zip_specs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, sp in zip(tree, specs):
            yield from _zip_specs(t, sp)
    elif tree is not None:
        yield tree, tuple(specs)


def shard_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """This rank's block of every leaf (a contiguous copy)."""
    out = [leaf[block_slices(sp, leaf.shape, mesh)].clone(
               memory_format=torch.contiguous_format)
           for leaf, sp in _zip_specs(tree, specs)]
    return _rebuild(tree, iter(out))


def _gather_leaves(leaves: Sequence[torch.Tensor], specs, full_shapes,
                   mesh, targets=None
                   ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Each leaf from this rank's block under its storage spec to its
    block under its ``targets`` spec (None: every leaf whole); a leaf
    whose block is already that comes back as it is. The all-reduce runs
    over the mesh axes no target splits, so each target block is
    gathered from the ranks that share it. Returns (leaves, the byte
    buffer the others view, or None where nothing is gathered)."""
    out: List[Optional[torch.Tensor]] = list(leaves)
    targets = list(targets) if targets is not None else [()] * len(leaves)
    kept = {a for t in targets for a in _spec_axes(t, mesh)}
    group = tuple(a for a in mesh.axis_names if a not in kept)
    tshape = [block_shape(t, s, mesh) for t, s in zip(targets, full_shapes)]
    idx = [i for i, sp in enumerate(specs)
           if _spec_axes(sp, mesh) != _spec_axes(targets[i], mesh)]
    if not idx:
        return out, None
    offs, n = [], 0
    for i in idx:
        offs.append(n)
        n += -(-math.prod(tshape[i]) * leaves[i].element_size()
               // ALIGN) * ALIGN
    flat = torch.zeros(n, dtype=torch.uint8, device=leaves[idx[0]].device)

    def view(buf, i, off):
        size = math.prod(tshape[i]) * leaves[i].element_size()
        return buf[off:off + size].view(leaves[i].dtype).view(tshape[i])

    c = mesh.coords()
    for i, off in zip(idx, offs):
        used = set(_spec_axes(specs[i], mesh))
        if all(c[a] == 0 for a in group if a not in used):
            view(flat, i, off)[_within(specs[i], targets[i], full_shapes[i],
                                       mesh)] = leaves[i]
    flat = mesh.all_reduce(flat, group)
    for i, off in zip(idx, offs):
        out[i] = view(flat, i, off)
    return out, flat


def block_shape(spec, shape, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under ``spec``."""
    return tuple(s.stop - s.start for s in block_slices(spec, shape, mesh))


def _within(spec, target, shape, mesh) -> Tuple[slice, ...]:
    """Where this rank's block under ``spec`` lies in its block under
    ``target``, which must hold it: per dimension, the target's
    splitting axes lead the storage spec's."""
    out = []
    pad = (None,) * len(shape)
    for s, t, se, te in zip(block_slices(spec, shape, mesh),
                            block_slices(target, shape, mesh),
                            tuple(spec) + pad, tuple(target) + pad):
        ax, tx = _split_axes(se, mesh), _split_axes(te, mesh)
        if ax[:len(tx)] != tx:
            raise ValueError(f"a block under {spec} does not lie in one "
                             f"block under {target}")
        out.append(slice(s.start - t.start, s.stop - t.start))
    return tuple(out)


def full_shape(spec, local_shape, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from this rank's block's."""
    return tuple(d * mesh.axis_size(_split_axes(e, mesh))
                 for e, d in zip(tuple(spec) + (None,) * len(local_shape),
                                 local_shape))


def gather_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """The inverse of :func:`shard_tree`: every leaf whole on every rank,
    bit for bit (every rank must call it)."""
    pairs = list(_zip_specs(tree, specs))
    leaves = [l for l, _ in pairs]
    sp = [s for _, s in pairs]
    shapes = [full_shape(s, l.shape, mesh) for l, s in pairs]
    out, _ = _gather_leaves(leaves, sp, shapes, mesh)
    return _rebuild(tree, iter(out))


def bytes_per_rank(tree: Tree, specs: Tree, sizes: Dict[str, int]) -> int:
    """Bytes of ``tree``'s leaves one rank holds under ``specs`` on a mesh
    of axis ``sizes`` (shapes only: meta tensors do)."""
    total = 0
    for leaf, sp in _zip_specs(tree, specs):
        n = math.prod(leaf.shape)
        for e in sp:
            n //= math.prod(sizes.get(a, 1) for a in _used(e))
        total += n * leaf.element_size()
    return total


def compute_rules(mesh_shape: Dict[str, int], **kw) -> MeshRules:
    """The reference's compute layout on a mesh of axis sizes
    ``mesh_shape``: its storage rules with no fsdp axes
    (``tree_specs(params, compute_rules(...))`` is its ``param_cspecs``):
    column weights split their fan-out over tp, row weights their fan-in,
    the embedding its model columns; the rest whole."""
    return MeshRules(axis_sizes=dict(mesh_shape), fsdp_axes=(), **kw)


class _Gather(torch.autograd.Function):
    """Storage blocks -> compute blocks (one all-reduce of bytes over the
    axes the compute layout does not split; whole leaves where it splits
    nothing). The backward all-reduces the compute blocks' gradients over
    the dp axes only: a leaf the tp ranks split holds this rank's block
    of the gradient, and a leaf they replicate arrives whole and
    tp-reduced already (``dist.tp.copy_to_tp``). It records each reduced
    leaf's squared norm on the placement, split or replicated over tp,
    and returns this rank's storage block of each."""

    @staticmethod
    def forward(ctx, plc, specs, *leaves):
        mesh = plc.mesh
        ctx.plc, ctx.specs, ctx.device = plc, specs, leaves[0].device
        ctx.dtypes = [l.dtype for l in leaves]
        shapes = [full_shape(s, l.shape, mesh) for l, s in zip(leaves, specs)]
        ctx.targets = [plc.target(s) for s in specs]
        ctx.full = shapes
        out, flat = _gather_leaves(leaves, specs, shapes, mesh, ctx.targets)
        if flat is not None:
            plc._hold(flat)
        return tuple(o if o is not l else l.view_as(l)
                     for o, l in zip(out, leaves))

    @staticmethod
    def backward(ctx, *grads):
        plc, mesh = ctx.plc, ctx.plc.mesh
        out = []
        for g, full, sp, t in zip(
                _dp_reduce(plc, grads, ctx.targets, ctx.full, ctx.dtypes,
                           ctx.device),
                ctx.full, ctx.specs, ctx.targets):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            (plc.sq_norms_split if _spec_axes(t, mesh)
             else plc.sq_norms).append(sq)
            out.append(g[_within(sp, t, full, mesh)].contiguous())
        return (None, None) + tuple(out)


def _dp_reduce(plc, grads, targets, full, dtypes, device
               ) -> List[torch.Tensor]:
    """Compute-block gradients ``grads`` (None: zeros) of leaves of whole
    shapes ``full`` under ``targets``, summed over ``plc``'s dp axes in
    f32 in one all-reduce, each cast to its leaf's dtype."""
    mesh = plc.mesh
    shapes = [block_shape(t, s, mesh) for t, s in zip(targets, full)]
    blocks = [torch.zeros(s, dtype=torch.float32, device=device)
              if g is None else g.to(torch.float32)
              for g, s in zip(grads, shapes)]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in blocks]),
                           plc.dp)
    return [g.view(s).to(dtype) for g, s, dtype in zip(
        torch.split(flat, [math.prod(s) for s in shapes]), shapes, dtypes)]


class Placement:
    """The gather of a placed train step on ``mesh`` with dp axes ``dp``:
    :meth:`gather` is what ``act_sharding.constrain_tree`` runs under
    ``act_sharding.placement``. It brings each storage block to its block
    of the compute layout: the storage spec less every axis but ``tp``
    (the tensor-parallel axes the compute keeps; none: whole leaves). It
    records the squared norm of every dp-reduced gradient leaf as its
    backward sees it (``sq_norms`` for leaves whole on every rank,
    ``sq_norms_split`` for this rank's tp block; :meth:`global_sq_norm`
    joins them), and the most bytes of gathered leaves alive at once
    (``peak_bytes``). A step that accumulates microbatches gathers once
    outside autograd and takes each microbatch's gradient to the storage
    blocks with :meth:`reduce`, its norm with :meth:`storage_sq_norm`."""

    def __init__(self, mesh, dp: Tuple[str, ...], tp: Tuple[str, ...] = ()):
        self.mesh, self.dp, self.tp = mesh, tuple(dp), tuple(tp)
        self.sq_norms: List[torch.Tensor] = []
        self.sq_norms_split: List[torch.Tensor] = []
        self.live_bytes = self.peak_bytes = 0

    def target(self, spec) -> tuple:
        """The compute-layout spec of a leaf stored under ``spec``."""
        out = []
        for e in spec:
            axes = tuple(a for a in _used(e) if a in self.tp)
            out.append(None if not axes else
                       axes[0] if len(axes) == 1 else axes)
        return tuple(out)

    def clear(self) -> None:
        self.sq_norms.clear()
        self.sq_norms_split.clear()

    def global_sq_norm(self) -> torch.Tensor:
        """The squared norm of the whole gradient: the replicated leaves
        once, the split leaves' squares summed over the tp axes (one
        all-reduce, where any leaf is split; ``dist.tp.join_sq_norms``)."""
        n = self.mesh.axis_size(self.tp)
        return join_sq_norms(
            self.sq_norms + self.sq_norms_split,
            [1] * len(self.sq_norms) + [n] * len(self.sq_norms_split),
            TP(self.mesh, self.tp) if self.tp else None)

    def _hold(self, flat: torch.Tensor) -> None:
        n = flat.numel() * flat.element_size()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(flat.untyped_storage(), self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def gather(self, tree: Tree, specs: Tree) -> Tree:
        pairs = list(_zip_specs(tree, specs))
        out = _Gather.apply(self, tuple(s for _, s in pairs),
                            *(l for l, _ in pairs))
        return _rebuild(tree, iter(out))

    def reduce(self, grads: Tree, specs: Tree) -> Tree:
        """This rank's storage blocks (``specs``) of the gradient whose
        compute blocks ``grads`` are, as the gather's backward makes them:
        summed over dp in f32 (one all-reduce), cast to each leaf's dtype,
        sliced to the block. For gradients taken at leaves that
        :meth:`gather` gave outside autograd."""
        pairs = list(_zip_specs(grads, specs))
        targets = [self.target(sp) for _, sp in pairs]
        full = [full_shape(t, g.shape, self.mesh)
                for (g, _), t in zip(pairs, targets)]
        red = _dp_reduce(self, [g for g, _ in pairs], targets, full,
                         [g.dtype for g, _ in pairs], pairs[0][0].device)
        return _rebuild(grads, iter(
            g[_within(sp, t, f, self.mesh)].contiguous()
            for g, (_, sp), t, f in zip(red, pairs, targets, full)))

    def storage_sq_norm(self, blocks: Tree, specs: Tree) -> torch.Tensor:
        """The squared norm of the whole tree of which ``blocks`` are this
        rank's storage blocks (``specs``): each block's squares added by
        the first of the ranks that hold it, one all-reduce over the
        mesh."""
        mesh, c = self.mesh, self.mesh.coords()
        pairs = list(_zip_specs(blocks, specs))
        total = torch.zeros((), dtype=torch.float32,
                            device=pairs[0][0].device)
        for b, sp in pairs:
            used = _spec_axes(sp, mesh)
            if all(c[a] == 0 for a in mesh.axis_names if a not in used):
                total = total + torch.sum(torch.square(b.to(torch.float32)))
        return mesh.all_reduce(total, mesh.axis_names)
