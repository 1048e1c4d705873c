"""Agent data partitioning with controllable overlap.

``overlap=1`` is a disjoint split (redundancy only from distributional
similarity, the §5 setting); ``overlap=k`` replicates each sample across k
agents, strengthening (r, eps)-redundancy toward exact r-redundancy — the
lever the redundancy benchmarks sweep.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import Dataset


def partition(ds: Dataset, n_agents: int, overlap: int = 1, seed: int = 0
              ) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    assignments: List[List[int]] = [[] for _ in range(n_agents)]
    for j in range(len(ds)):
        owners = rng.choice(n_agents, size=min(overlap, n_agents),
                            replace=False)
        for a in owners:
            assignments[a].append(j)
    return [Dataset(ds.x[idx], ds.y[idx]) for idx in assignments]


def agent_batch(ds: Dataset, batch: int, rng: np.random.Generator):
    idx = rng.integers(0, len(ds), size=batch)
    return ds.x[idx], ds.y[idx]


def agent_of_example(global_batch: int, n_agents: int) -> np.ndarray:
    """Contiguous example->agent map used by the SPMD masked-loss path
    (batch dim sharded over the DP axis in agent-contiguous order)."""
    assert global_batch % n_agents == 0
    per = global_batch // n_agents
    return np.repeat(np.arange(n_agents), per)


def mask_to_weights(agent_mask: np.ndarray, global_batch: int,
                    seq: int | None = None) -> np.ndarray:
    """Per-example (or per-token) loss weights implementing Algorithm 1's
    S^t selection: examples owned by masked-out (straggler) agents get
    weight 0. Shape (B,) or (B,S)."""
    n_agents = agent_mask.shape[0]
    owners = agent_of_example(global_batch, n_agents)
    w = agent_mask[owners].astype(np.float32)
    if seq is not None:
        w = np.broadcast_to(w[:, None], (global_batch, seq)).copy()
    return w
