"""Cost of one rank's step, counted from its dispatched op trace
(counterpart of ``repro.launch.hlo_analysis``).

The reference reads the optimized HLO of a compiled step. The port has
no compiler between the program and the card: every aten op the step
dispatches runs as it is, so the trace of dispatched ops is the port's
counterpart of optimized HLO, and counting it needs no card. A step run
on the ``meta`` device under :class:`OpCounter` (a
``TorchDispatchMode``) dispatches the same ops, with the same shapes, as
on a card, and allocates nothing.

Accounting (per rank: every tensor the step sees is this rank's):

- flops: the FLOP formulas of ``torch.utils.flop_counter`` for the dot
  and convolution ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolution, SDPA), as the reference counts dot ops; elementwise work
  is not counted.
- hbm bytes: operand bytes plus result bytes of every dispatched op. Ops
  whose results alias an operand (views, reshapes, ``detach``) and ops
  that move no data (``empty``) are free, as the reference's
  ``FREE_OPS``. Everything else materializes in eager mode (a ``clone``
  is a copy, as the reference's ``copy`` is), so this is the
  counterpart of the reference's fusion-boundary count with one op per
  fusion.
- collective wire bytes by kind, in the reference's ring convention: an
  all-reduce counts twice its payload. Every collective of the port goes
  through ``launch.mesh.Mesh.all_reduce`` (``watch_collectives``), so the
  other kinds stay 0, and one over a group of one rank moves nothing.
- ``unknown_trip_counts`` is 0: eager mode dispatches every layer and
  every loop iteration, so there is no loop body to multiply.

The counter also tracks the bytes of the storages the step allocates
while they are alive: ``peak_temp_bytes`` is the most alive at once,
the counterpart of the reference's ``temp_size_in_bytes``.

The counts are kept per op (:meth:`OpCounter.table`, JSON-ready), and
:func:`analyze` and :func:`breakdown` read either a counter or such a
table, so a saved table is analysed again without running the step.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from typing import Any, Dict, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import watch_collectives

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
# results that alias no operand yet move no data (views the schema does
# not annotate, allocations, metadata reads)
FREE_OPS = {aten._unsafe_view, aten.detach, aten.lift_fresh, aten.alias,
            aten.empty, aten.empty_like, aten.empty_strided,
            aten.new_empty, aten.new_empty_strided, aten._local_scalar_dense,
            aten.sym_size, aten.sym_stride, aten.sym_numel,
            aten.sym_storage_offset, aten.set_, aten.resize_}
# the collectives' own ops (a real mesh's all-reduce dispatches one):
# counted by kind through watch_collectives, not as memory traffic
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

Table = Dict[str, Any]


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (flat, in order)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _op_info(func):
    """(name, which results are new storages, whether the op moves bytes,
    its FLOP formula or None), read once per op from its schema."""
    rets = func._schema.returns
    fresh = tuple(r.alias_info is None for r in rets)
    views = bool(rets) and all(r.alias_info is not None
                               and not r.alias_info.is_write for r in rets)
    packet = func._overloadpacket
    return (str(func), fresh if any(fresh) else None,
            packet not in FREE_OPS and not views, flop_registry.get(packet))


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of what runs inside it, op by
    op, and the peak bytes of the storages allocated inside it.

    ``with OpCounter() as c: out = step(*args)`` on any device; the
    dispatch mode follows the backward pass onto autograd's threads, and
    the collective sink is process-wide. ``c.table()`` is the JSON-ready
    record that :func:`analyze` and :func:`breakdown` read."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.collectives: Dict[tuple, int] = defaultdict(int)
        self.live_bytes = self.peak_temp_bytes = 0
        self._live: Dict[int, int] = {}
        self._info: Dict[Any, tuple] = {}
        self._lock = threading.Lock()
        self._watch = watch_collectives(self._collective)

    def __enter__(self):
        self._watch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._watch.__exit__(*exc)

    # -- collectives --------------------------------------------------------
    def _collective(self, kind, axes, group_size, nbytes) -> None:
        if group_size > 1:
            with self._lock:
                self.collectives[(kind, tuple(axes), group_size,
                                  nbytes)] += 1

    # -- temporaries ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), st.nbytes()
        with self._lock:
            if key in self._live:
                return
            self._live[key] = n
            self.live_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # -- ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in COLLECTIVE_NAMESPACES:
            return out
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        name, fresh, moves, formula = info
        if fresh is not None:
            rets = out if isinstance(out, (tuple, list)) else (out,)
            for is_new, r in zip(fresh, rets):
                if is_new:
                    for t in _tensors(r, []):
                        self._track(t)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        nbytes = (_nbytes(_tensors((args, kwargs, out), [])) if moves
                  else 0)
        with self._lock:
            row = self.ops[name]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out

    def table(self) -> Table:
        """{"ops": {op: {"count", "flops", "bytes"}}, "collectives":
        [{"kind", "axes", "group", "bytes", "count"}]}."""
        with self._lock:
            ops = {k: {"count": c, "flops": f, "bytes": b}
                   for k, (c, f, b) in sorted(self.ops.items())}
            coll = [{"kind": k, "axes": list(a), "group": g, "bytes": n,
                     "count": c}
                    for (k, a, g, n), c in sorted(self.collectives.items())]
        return {"ops": ops, "collectives": coll}


def _table(src: Union[OpCounter, Table]) -> Table:
    return src.table() if isinstance(src, OpCounter) else src


def analyze(src: Union[OpCounter, Table]) -> Dict:
    """The reference's keys from a counter or its saved table."""
    t = _table(src)
    coll = {k: 0.0 for k in COLLECTIVES}
    count = 0
    for c in t["collectives"]:
        wire = 2 * c["bytes"] if c["kind"] == "all-reduce" else c["bytes"]
        coll[c["kind"]] += float(wire * c["count"])
        count += c["count"]
    return {
        "flops": float(sum(r["flops"] for r in t["ops"].values())),
        "hbm_bytes": float(sum(r["bytes"] for r in t["ops"].values())),
        "collective_bytes": sum(coll.values()),
        "collectives": coll,
        "collective_count": float(count),
        "unknown_trip_counts": 0,
    }


def breakdown(src: Union[OpCounter, Table], top: int = 20) -> Dict:
    """The ``top`` ops by FLOPs and by HBM bytes: {"flops": [(flops, op,
    count)], "bytes": [(bytes, op, count)]}, each in descending order."""
    ops = _table(src)["ops"]
    out = {}
    for key in ("flops", "bytes"):
        rows = sorted(((r[key], op, r["count"]) for op, r in ops.items()
                       if r[key]), key=lambda row: (-row[0], row[1]))
        out[key] = rows[:top]
    return out


def diff(a: Union[OpCounter, Table], b: Union[OpCounter, Table]) -> Dict:
    """{op: (a's row, b's row)} for every op whose FLOPs or bytes differ
    between two counts of one step (on two devices, say); an op missing
    from one side has the row None there. Free ops that move nothing may
    dispatch a different number of times (a host scalar lifted to another
    device) and are not named."""
    ra, rb = _table(a)["ops"], _table(b)["ops"]
    out = {}
    for op in sorted(set(ra) | set(rb)):
        x, y = ra.get(op), rb.get(op)
        key = [(r["flops"], r["bytes"]) if r else (0, 0) for r in (x, y)]
        if key[0] != key[1]:
            out[op] = (x, y)
    return out
