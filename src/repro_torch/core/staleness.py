"""T^{t;k} bookkeeping of §3.2.

The paper defines T^{t;t-i} inductively; operationally it is the latest
delivered gradient per agent, partitioned by the iterate timestamp it was
computed at. ``partition_T`` materializes that partition from a ledger and
checks the paper's invariants (disjointness; T^t = union over ages <= tau).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def partition_T(ledger_ts: np.ndarray, t: int, tau: int
                ) -> Dict[int, List[int]]:
    """ledger_ts[j] = timestamp of agent j's latest delivered gradient
    (-1 = none). Returns {age i: agents in T^{t;t-i}} for 0 <= i <= tau."""
    out: Dict[int, List[int]] = {i: [] for i in range(tau + 1)}
    for j, ts in enumerate(ledger_ts):
        if ts < 0:
            continue
        age = t - int(ts)
        if 0 <= age <= tau:
            out[age].append(j)
    return out


def check_invariants(parts: Dict[int, List[int]]) -> bool:
    """Disjointness: T^{t;t-i} ∩ T^{t;t-j} = ∅ for i != j."""
    seen = set()
    for agents in parts.values():
        for a in agents:
            if a in seen:
                return False
            seen.add(a)
    return True


def t_set_size(parts: Dict[int, List[int]]) -> int:
    """|T^t| = |∪_i T^{t;t-i}|."""
    return sum(len(v) for v in parts.values())
