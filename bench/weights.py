"""Weights made from the seed, on the device, in the dtype they are served in.

The tree's keys and shapes are the port's parameter layout (``init_model``
on the meta device: no storage, no draws); the values are the
benchmark's own. Each leaf (a stacked leaf holds every period of its
layer) is one draw of a generator of its own, seeded from the seed and
the leaf's path, so any leaf can be drawn again alone: the reference
re-draws the first step's parameters leaf by leaf, without a copy held
through the run. The distributions are the port's: normal weights with
std 1/sqrt(fan-in), embeddings 0.02, the Mamba convolution 0.1, unit
norm scales and Mamba skips, zero biases, the Mamba ``dt_b`` at
softplus^-1(0.01) and ``a_log`` at log(1..N).
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, Tuple

import torch

ZEROS = ("bias", "b_in", "b_out", "bq", "bk", "bv", "conv_b")
ONES = ("scale", "d")
STD = {"tok": 0.02, "conv_w": 0.1}


def leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a tree of dicts and tuples, in a fixed order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], f"{path}.{k}" if path else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


def map_tree(fn: Callable[[str, torch.Tensor], torch.Tensor], tree,
             path: str = ""):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v, f"{path}.{i}" if path else str(i))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(seed: int, path: str, shape, dtype, device) -> torch.Tensor:
    """The leaf at ``path`` of the seed's weights."""
    key = path.rsplit(".", 1)[-1]
    shape = tuple(shape)
    if key in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if key in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if key == "dt_b":
        return torch.full(shape, -4.6, dtype=dtype, device=device)
    if key == "a_log":
        n = shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(shape).to(dtype).contiguous()
    std = STD.get(key, 1.0 / math.sqrt(shape[-2]))
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(std)


def shapes(arch) -> Dict:
    """The port's parameter tree of ``arch`` on the meta device."""
    from repro_torch.models.model import init_model
    return init_model(None, arch, device="meta")


def make_params(arch, seed: int, device) -> Dict:
    return map_tree(lambda p, t: make_leaf(seed, p, t.shape, t.dtype, device),
                    shapes(arch))
