"""Activation layout constraints: logical constraint points for the model
(counterpart of ``repro.dist.act_sharding``).

The model files never name mesh axes. They call ``constrain(x, kind)``
at the reference's layout-critical points with a *logical* kind
("act", "ffn", "heads4", "hd_tp", "moe_tokens", "logits"); an ambient
``act_policy`` context maps each kind to a spec over the active (dp, tp)
axes, with the reference's divisibility fallback (an axis group that does
not divide the dimension is trimmed from the right). A spec is a tuple
with one entry per dimension: None, an axis name or a tuple of axis
names, as in ``dist/sharding.py``.

The port has no partitioner: each rank already holds its per-rank
tensor, so ``constrain`` never reshapes or communicates and returns ``x``
itself. What it keeps is the decision: under a policy with a
``recorder`` list (its own or, nested, the enclosing policy's), every
constraint appends ``(kind, shape, spec)``, the record a dry run reads
and the parity tests hold against the reference's. With no policy active, every function here is the identity.

Kinds (x layout -> pinned dims):
- ``act``        (B, S, D)      batch over dp
- ``ffn``        (B, S, F)      batch over dp, hidden F over tp
- ``heads4``     (B, S, H, hd)  batch over dp, heads over tp
- ``hd_tp``      (B, S, H, hd)  batch over dp, head_dim over tp
- ``moe_tokens`` (G, T, D)      dispatch groups over dp
- ``logits``     (B, S, V)      batch over dp, vocab over tp

``constrain_tree`` is the one that acts: under an active placement
(:class:`placement`, installed by the placed train step) it gathers a
tree of storage shards into the compute layout, and the backward pass of
that gather reduces the gradients back to this rank's shards.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple, Union

Tree = Any
Axes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


def _norm_axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


class _Policy:
    __slots__ = ("dp", "tp", "sizes", "recorder")

    def __init__(self, dp: Axes, tp: Axes,
                 sizes: Optional[Dict[str, int]] = None,
                 recorder: Optional[List[tuple]] = None):
        self.dp = _norm_axes(dp)
        self.tp = _norm_axes(tp)
        self.sizes = dict(sizes) if sizes else None
        self.recorder = recorder

    def fit(self, axes: Tuple[str, ...], dim: int):
        """Largest suffix-trimmed axis group whose size divides ``dim``.
        Unknown sizes are assumed divisible."""
        axes = tuple(axes)
        while axes:
            if self.sizes is None:
                break
            prod = 1
            for a in axes:
                prod *= self.sizes.get(a, 1)
            if prod and dim % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes


class act_policy:
    """Context manager installing the logical -> mesh activation mapping;
    ``recorder`` (a list) collects every ``(kind, shape, spec)``. A
    policy with no recorder of its own records into the enclosing
    policy's, so an outer recorder (a dry run's) sees the decisions of
    the steps' own policies."""

    def __init__(self, dp: Axes, tp: Axes,
                 sizes: Optional[Dict[str, int]] = None,
                 recorder: Optional[List[tuple]] = None):
        self._policy = _Policy(dp, tp, sizes, recorder)

    def __enter__(self):
        stack = getattr(_STATE, "stack", None)
        if stack is None:
            stack = _STATE.stack = []
        pol = self._policy
        if pol.recorder is None and stack and stack[-1].recorder is not None:
            pol = _Policy(pol.dp, pol.tp, pol.sizes, stack[-1].recorder)
        stack.append(pol)
        return pol

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def current_policy() -> Optional[_Policy]:
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def _spec_for(kind: str, shape: Tuple[int, ...], pol: _Policy) -> tuple:
    nd = len(shape)
    if nd == 0:
        return ()
    dims: list = [None] * nd
    dims[0] = pol.fit(pol.dp, shape[0])
    if kind == "ffn" and nd >= 3:
        dims[-1] = pol.fit(pol.tp, shape[-1])
    elif kind == "heads4" and nd == 4:
        dims[2] = pol.fit(pol.tp, shape[2])
    elif kind == "hd_tp" and nd == 4:
        dims[-1] = pol.fit(pol.tp, shape[-1])
    elif kind == "logits" and nd >= 2:
        dims[-1] = pol.fit(pol.tp, shape[-1])
    # "act" / "moe_tokens": dp on the leading dim only
    return tuple(dims)


def constrain(x, kind: str):
    """Pin ``x`` to the active policy's layout for ``kind``: records the
    decision and returns ``x`` itself (the identity with no policy)."""
    pol = current_policy()
    if pol is not None and pol.recorder is not None:
        shape = tuple(x.shape)
        pol.recorder.append((kind, shape, _spec_for(kind, shape, pol)))
    return x


def strip_leading(specs: Tree) -> Tree:
    """Drop the leading (layer-stacked) entry of every spec leaf: specs
    of ``(n_periods, ...)``-stacked parameters become those of one
    layer's slice."""
    if isinstance(specs, dict):
        return {k: strip_leading(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [strip_leading(v) for v in specs]
    if isinstance(specs, tuple) and not _is_spec(specs):
        return tuple(strip_leading(v) for v in specs)
    if specs is None:
        return None
    return tuple(specs)[1:]


def _is_spec(t) -> bool:
    """A spec leaf is a tuple of None / str / tuples of str; the trees
    around it (parameter trees' tuples) hold dicts or deeper tuples."""
    return all(e is None or isinstance(e, str)
               or (isinstance(e, tuple) and all(isinstance(a, str)
                                                for a in e))
               for e in t)


# ---------------------------------------------------------------------------
# placement: the storage -> compute gather of the placed train step

_PLACE = threading.local()


class placement:
    """Context manager installing the gather that ``constrain_tree``
    runs: ``gather(tree, specs) -> tree`` (``dist.sharding.Placement.
    gather``, bound to a mesh)."""

    def __init__(self, gather):
        self._gather = gather

    def __enter__(self):
        stack = getattr(_PLACE, "stack", None)
        if stack is None:
            stack = _PLACE.stack = []
        stack.append(self._gather)
        return self._gather

    def __exit__(self, *exc):
        _PLACE.stack.pop()
        return False


def current_placement():
    stack = getattr(_PLACE, "stack", None)
    return stack[-1] if stack else None


def constrain_tree(tree: Tree, specs: Tree, gather=None) -> Tree:
    """Bring every leaf of ``tree`` from its storage layout (``specs``)
    to the compute layout: ``gather``, else the active :class:`placement`'s
    (every storage shard made whole on every rank, its backward reducing
    the gradients to this rank's shards); with neither, the identity. A
    caller whose call may be recomputed on the autograd engine's thread
    (a checkpointed layer) resolves ``current_placement()`` first and
    passes it, the context being thread-local."""
    gather = gather or current_placement()
    if gather is None or specs is None:
        return tree
    return gather(tree, specs)
