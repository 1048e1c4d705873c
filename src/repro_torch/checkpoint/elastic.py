"""Elastic scaling: restore a checkpoint across a *different* mesh /
agent-count (counterpart of ``repro.checkpoint.elastic``: numpy, copied).

Model/optimizer state is agent-independent (global arrays re-sharded by the
new mesh at device_put), so elasticity reduces to fixing up the per-agent
leaves:

- gradient ledger (rule 15)  (n_agents, ...) -> surviving agents keep their
  entry; joiners start from the aggregated mean (timestamp -1, so they are
  excluded from T^t until they deliver — semantics match a fresh agent).
- error-feedback residuals   joiners start at zero.
- agent masks / straggler telemetry -> resized.

The paper's theory needs no warmup after a change of n or r: Theorems 1-4
hold per-iteration for whatever S^t the new configuration produces.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

PyTree = Any


def resize_agent_axis(arr: np.ndarray, new_n: int,
                      fill: str = "zero") -> np.ndarray:
    """Resize leading agent axis. fill: zero | mean."""
    old_n = arr.shape[0]
    if new_n == old_n:
        return arr
    if new_n < old_n:
        return arr[:new_n]
    pad_shape = (new_n - old_n,) + arr.shape[1:]
    if fill == "mean" and old_n:
        pad = np.broadcast_to(arr.mean(0, keepdims=True), pad_shape)
    else:
        pad = np.zeros(pad_shape, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def reshard_agent_state(flat: Dict[str, np.ndarray], new_n: int
                        ) -> Dict[str, np.ndarray]:
    """Fix every per-agent leaf in a flat checkpoint dict. Per-agent leaves
    are identified by path convention: keys under 'ledger/', 'err/',
    'agent_' prefixes carry a leading n_agents axis."""
    out = {}
    for k, v in flat.items():
        if k.startswith(("ledger/", "err/")) or k.startswith("agent_"):
            fill = "mean" if k.startswith("ledger/g") else "zero"
            out[k] = resize_agent_axis(v, new_n, fill)
        elif k == "ledger_ts" or k.endswith("/ledger_ts"):
            ts = resize_agent_axis(v, new_n, "zero")
            if new_n > v.shape[0]:
                ts[v.shape[0]:] = -1          # joiners: no delivery yet
            out[k] = ts
        else:
            out[k] = v
    return out


def rebatch_global(batch_leaf: np.ndarray, new_batch: int) -> np.ndarray:
    """Adapt a global-batch-shaped leaf (B, ...) when global batch changes
    with the agent count (keeps per-agent batch constant)."""
    b = batch_leaf.shape[0]
    if new_batch == b:
        return batch_leaf
    if new_batch < b:
        return batch_leaf[:new_batch]
    reps = int(np.ceil(new_batch / b))
    return np.concatenate([batch_leaf] * reps, axis=0)[:new_batch]
