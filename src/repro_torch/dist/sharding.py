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

The port places no training parameter by these specs yet (its train
meshes replicate parameters); the serving engine splits its page pools
by ``cache_specs``' kv-head rule applied to its mesh's own extents
(``kv_head_block``), and ``serve_tp`` carries the mesh and that block to
the attention code.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import threading
from typing import Any, Dict, Optional, Tuple

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
