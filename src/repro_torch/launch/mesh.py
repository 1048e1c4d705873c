"""Meshes of named axes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``), and a runner that spawns one process per rank.

JAX drives every shard of a mesh from one process; here each rank is a
process of the default process group, and every rank runs the same
host code. A :class:`Mesh` lays the ranks out row-major over its axes
(rank = the linear index of its coordinates) and makes one process
sub-group per set of axes, so a collective over ``("pod", "data")``
all-reduces among the ranks that share every other coordinate. Groups
are made when the mesh is built, by every rank in the same order, as
``torch.distributed.new_group`` requires. An axis set of one rank needs
no group, and a collective over it is the identity — except in a
process group of one rank, where it runs through that group (a
one-rank NCCL group then carries every collective).

:func:`run_ranks` starts W processes with an explicit backend, device
and time limit, rendezvousing through a ``FileStore``; a rank that
raises or overruns the limit makes it raise, after every process it
started has ended.

A :class:`RecordingMesh` is a mesh seen from one rank with no process
group behind it: its collectives return a copy and are only reported,
which is what the dry run (``launch.dryrun``) runs the port's steps on,
on the meta device. Every ``all_reduce``, of a real mesh or a recording
one, reports ``(kind, axes, group size, bytes)`` to the collective
sinks installed with :func:`watch_collectives`, from whatever thread
calls it (a backward pass on a card runs on autograd's own thread).
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve as resolve_device

DP_AXES = ("pod", "data")

_sinks: list = []               # process-wide: every thread reports here
_sinks_lock = threading.Lock()


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class watch_collectives:
    """Context manager: while active, ``sink(kind, axes, group_size,
    nbytes)`` is called for every collective any :class:`Mesh` of this
    process runs, on any thread (``axes`` in the mesh's axis order,
    ``nbytes`` the payload of one rank)."""

    def __init__(self, sink: Callable):
        self._sink = sink

    def __enter__(self):
        with _sinks_lock:
            _sinks.append(self._sink)
        return self._sink

    def __exit__(self, *exc):
        with _sinks_lock:
            _sinks.remove(self._sink)
        return False


def _report(kind: str, mesh, axes, x: torch.Tensor, parts: int = 1) -> None:
    with _sinks_lock:
        sinks = list(_sinks)
    if not sinks:
        return
    sub = tuple(a for a in mesh.axis_names if a in _axes(axes))
    nbytes = x.numel() * x.element_size()
    for sink in sinks:
        sink(kind, sub, mesh.axis_size(sub) // parts, nbytes)


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis name -> size (insertion order is the axis
    order), ``axis_names`` is that order, ``device`` is where this
    rank's tensors live. With ``groups=False`` the mesh is a shape only
    (no process group needed) and its collectives refuse to run."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device="cuda", groups: bool = True):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.device = resolve_device(device)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self.has_groups = groups
        if not groups:
            self.rank = 0
            return
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"process group {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        sizes = [self.shape[a] for a in self.axis_names]
        coords = list(itertools.product(*(range(s) for s in sizes)))
        for k in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                n = math.prod(self.shape[a] for a in sub)
                if n == 1 and (world > 1 or not dist.is_initialized()):
                    continue
                if n == self.size:
                    self._groups[sub] = dist.group.WORLD
                    continue
                keep = [i for i, a in enumerate(self.axis_names)
                        if a not in sub]
                blocks: Dict[Tuple[int, ...], list] = {}
                for r, c in enumerate(coords):
                    blocks.setdefault(tuple(c[i] for i in keep), []).append(r)
                for ranks in blocks.values():    # every rank, same order
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = g

    # -- coordinates -------------------------------------------------------
    def coords(self) -> Dict[str, int]:
        return self._coords_of(self.rank)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """Row-major linear index of this rank over ``axes``."""
        c, idx = self.coords(), 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of this rank over ``axes`` (sorted into the
        mesh's axis order), or None where the axes hold one rank."""
        sub = tuple(a for a in self.axis_names if a in _axes(axes))
        if sub in self._groups:
            return self._groups[sub]
        if self.axis_size(sub) == 1:
            return None
        if not self.has_groups:
            raise RuntimeError(f"mesh {self.shape} was built without "
                               "process groups")
        raise KeyError(f"no process group for axes {sub}")

    def part_group(self, axes, parts: int):
        """The process group of this rank among ``parts`` blocks of
        consecutive ranks over ``axes`` (their row-major index), or None
        where a block holds one rank. Made at first use, by every rank of
        the world in the same order (each calls it at the same point of
        the same program), one group for every block of every
        coordinate of the other axes."""
        sub = tuple(a for a in self.axis_names if a in _axes(axes))
        n = self.axis_size(sub)
        if parts == 1:
            return self.group(sub)
        if n % parts:
            raise ValueError(f"{n} ranks over {sub} do not split into "
                             f"{parts} blocks")
        if n == parts:
            return None
        key = (sub, parts)
        if key in self._groups:
            return self._groups[key]
        if not self.has_groups:
            raise RuntimeError(f"mesh {self.shape} was built without "
                               "process groups")
        keep = [a for a in self.axis_names if a not in sub]
        blocks: Dict[tuple, list] = {}
        for r in range(self.size):
            c = self._coords_of(r)
            within = 0
            for a in sub:
                within = within * self.shape[a] + c[a]
            blocks.setdefault((tuple(c[a] for a in keep),
                               within // (n // parts)), []).append(r)
        for ranks in blocks.values():        # every rank, same order
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[key] = g
        return self._groups[key]

    def _coords_of(self, r: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    def all_reduce(self, x: torch.Tensor, axes,
                   inplace: bool = False, parts: int = 1) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axes``, as a new tensor (``x``
        itself is left alone), or with ``inplace`` in ``x`` itself (a
        contiguous buffer the caller no longer needs: no second copy of
        it), which is returned. With ``parts`` the sum runs within each
        of that many blocks of consecutive ranks over ``axes``
        (:meth:`part_group`). Every rank of the group must call it."""
        g = self.part_group(axes, parts)
        y = _target(x, inplace)
        _report("all-reduce", self, axes, y, parts)
        if g is not None:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
        return y


class RecordingMesh(Mesh):
    """The mesh ``shape`` seen from rank ``rank`` alone, with no process
    group: ``all_reduce`` returns a contiguous copy of ``x`` (this rank's
    own contribution, of the sum's shape and dtype) and reports the
    collective to the sinks of :func:`watch_collectives`. Tensors live on
    ``device``, the meta device by default, so a step runs on it with
    shapes alone."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, device="meta"):
        super().__init__(shape, axis_names, device=device, groups=False)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.rank = rank

    def all_reduce(self, x: torch.Tensor, axes,
                   inplace: bool = False, parts: int = 1) -> torch.Tensor:
        y = _target(x, inplace)
        _report("all-reduce", self, axes, y, parts)
        return y


def _target(x: torch.Tensor, inplace: bool) -> torch.Tensor:
    """The tensor an all-reduce of ``x`` sums into."""
    if not inplace:
        return x.clone(memory_format=torch.contiguous_format)
    if not x.is_contiguous():
        raise ValueError("an in-place all-reduce needs a contiguous buffer")
    return x


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         record: bool = False):
    """Single pod: (16, 16) ("data", "model") = 256 ranks. Multi-pod:
    (2, 16, 16) ("pod", "data", "model") = 512. With ``record`` the mesh
    is a :class:`RecordingMesh` of rank 0 (on the meta device unless
    ``device`` says otherwise). Otherwise groups are made only when a
    process group of that size exists, and the mesh is its shape alone
    when none does; its device is the card unless ``device`` says
    otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if record:
        return RecordingMesh(shape, axes, device=device or "meta")
    device = device or "cuda"
    live = dist.is_initialized() and dist.get_world_size() == math.prod(shape)
    return Mesh(shape, axes, device=device, groups=live)


def make_test_mesh(*, data: int = 4, model: int = 2, pod: int = 1,
                   device="cuda"):
    """A small mesh over the current process group (its world size must
    be data * model * pod)."""
    if pod > 1:
        return Mesh((pod, data, model), ("pod", "data", "model"),
                    device=device)
    return Mesh((data, model), ("data", "model"), device=device)


def dp_axis_names(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def n_agents_of(mesh) -> int:
    n = 1
    for a in dp_axis_names(mesh):
        n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# one process per rank


def _rank_main(target, rank, world, backend, store_path, timeout, threads,
               device, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = target(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a tensor put on the queue as it is would
        # travel as a handle to this process's memory, gone once it exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                      # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, rank, tb, world, grace: float = 2.0) -> str:
    """The first failure and any other rank's that follows within
    ``grace`` seconds: a rank that raises leaves the others failing in
    their next collective, and the root cause may arrive second."""
    msgs = [f"rank {rank} of {world} failed:\n{tb}"]
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            r, ok, val = results.get(timeout=max(end - time.monotonic(),
                                                 0.01))
        except queue.Empty:
            break
        if not ok:
            msgs.append(f"rank {r} of {world} failed:\n{val}")
    return "\n".join(msgs)


def run_ranks(target: Callable, world: int, *, backend: str, device: str,
              timeout: float, args: tuple = (), threads: int = 0,
              store_dir: Optional[str] = None) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    joined in one process group of ``backend`` ("gloo" or "nccl"), each
    on ``device`` ("cpu" or a card; every rank of a one-card machine
    takes the same card, which only gloo allows). Returns the targets'
    results in rank order. Raises if a rank raises, or if the ranks do
    not all finish within ``timeout`` seconds (also the process group's
    collective time limit); every process is ended before it returns.
    ``target`` must be importable by name (a module-level function)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    device = str(resolve_device(device))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=store_dir)
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, backend, store_path,
                               timeout, threads, device, args, results),
                         daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks did "
                                   f"not finish within {timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank process exited with code {dead[0].exitcode} "
                        "before reporting")
                continue
            if not ok:
                raise RuntimeError(_failures(results, rank, val, world))
            out[rank] = pickle.loads(val)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        results.join_thread()
        try:
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
            os.rmdir(tmp)
        except OSError:
            pass
