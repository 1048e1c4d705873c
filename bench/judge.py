"""The comparison that decides ``correct``: each number compared, its
limit, and how the numbers are read from the program's and the
reference's results."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# leaves whose reference gradient is under this share of the median
# leaf's move by rounding alone and are not compared
NOUGHT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def median(gaps: Dict[str, float]) -> Tuple[float, str]:
    return float(np.median(list(gaps.values()))), f"median of {len(gaps)} leaves"


def compared_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= NOUGHT * med]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """``prog``/``ref``: {"loss": [per step], "grad1": {leaf: norm},
    "change": {leaf: norm}}; ``ref`` also "ref_grad1" (the reference's
    clipped first gradient by leaf, which picks the leaves compared).
    The first gradient is compared by its worst leaf; the change after
    the steps by its median leaf (the embedding's change, a bfloat16
    scatter-add of many rows in an order that varies run to run, swings
    the worst leaf)."""
    n = min(len(prog["loss"]), len(ref["loss"]))
    loss = max(abs(p - r) / abs(r) for p, r in
               zip(prog["loss"][:n], ref["loss"][:n]))
    keep = compared_leaves(ref["ref_grad1"])
    return {"loss_gap": (loss, f"steps 1-{n}"),
            "grad1_gap": worst(leaf_gaps(prog["grad1"], ref["grad1"], keep)),
            "change_gap": median(leaf_gaps(prog["change"], ref["change"],
                                           keep))}


def decide(numbers: Dict[str, Tuple[float, str]],
           limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """``correct`` (every number that has a limit within it, and finite)
    and those numbers beside their limits, in the result line's form."""
    out, ok = {}, True
    for name, lim in limits.items():
        value, where = numbers[name]
        good = bool(np.isfinite(value)) and value <= lim
        ok = ok and good
        out[name] = {"value": value, "limit": lim, "at": where}
    return ok, out
