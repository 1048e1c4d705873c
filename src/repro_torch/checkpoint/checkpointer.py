"""Atomic, async checkpointing (counterpart of
``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
``.tmp`` directory and atomically renamed — a crash mid-save can never
corrupt the latest checkpoint (the restore path only reads directories with
a manifest). Saves run on a background thread (training continues; the
checkpointer joins before starting the next save). Keeps ``keep`` newest.

The state is a tree of nested dicts, lists and tuples whose leaves are
tensors, numpy arrays or scalars. It is flattened here, with the keys
``jax.tree_util.tree_flatten_with_path`` gives the reference: path
elements joined by ``/``, dict keys in sorted order, sequence positions
as integers, ``None`` an empty subtree. Tensors come to the host on the
caller's thread, bf16 widened to f32 (numpy has no bf16), so the arrays
written are the reference's and either package restores the other's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _leaves(tree: PyTree, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """(``/``-joined key, leaf) in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield "/".join(str(k) for k in path), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy().copy()
    return np.array(leaf)


def _flatten(state: PyTree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(state)}


def _unflatten_into(template: PyTree, flat: Dict[str, np.ndarray],
                    path: Tuple = ()) -> PyTree:
    """``template``'s structure with every leaf read from ``flat``: a
    tensor leaf gives a tensor of its dtype, shape and device, a numpy
    leaf an array of its dtype and shape, any other leaf the array."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, path + (i,))
               for i, v in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    if template is None:
        return None
    key = "/".join(str(k) for k in path)
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = np.asarray(flat[key])
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr).to(template.device, template.dtype
                                       ).reshape(template.shape)
    if hasattr(template, "dtype"):
        return arr.astype(template.dtype).reshape(template.shape)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, state: PyTree, step: int, blocking: bool = False,
             meta: Optional[Dict] = None) -> None:
        self.wait()
        # materialize on the caller's thread (device -> host)
        flat = _flatten(state)

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {"step": step, "time": time.time(),
                        "keys": sorted(flat), "meta": meta or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def _steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def _gc(self):
        steps = self._steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, template: PyTree, step: Optional[int] = None
                ) -> Tuple[PyTree, int]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat), step

    def restore_flat(self, step: Optional[int] = None
                     ) -> Tuple[Dict[str, np.ndarray], int]:
        self.wait()
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return {k: z[k] for k in z.files}, step
