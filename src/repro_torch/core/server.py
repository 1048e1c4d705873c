"""AsyncDGDServer — operational facade over the async engine.

Adds the production concerns around Algorithm 1: state snapshot/restore
(checkpoint-restart fault tolerance for the *server*), mid-run
reconfiguration (change r / rule / step size = elastic policy changes), and
run segments. Torch port of ``repro.core.server``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.async_engine import (AsyncEngine, EngineConfig,
                                           History, LatencyModel, Transport)


def _copy_hist(h: History) -> History:
    """Field-generic deep-ish copy: new History fields are picked up
    automatically instead of being silently dropped from snapshots."""
    kw = {}
    for f in dataclasses.fields(History):
        v = getattr(h, f.name)
        kw[f.name] = list(v) if isinstance(v, list) else v
    return History(**kw)


class AsyncDGDServer:
    def __init__(self, grad_fn, x0, cfg: EngineConfig,
                 latency: Optional[LatencyModel] = None, loss_fn=None,
                 x_star=None, transport: Optional[Transport] = None):
        self._mk = dict(grad_fn=grad_fn, latency=latency, loss_fn=loss_fn,
                        x_star=x_star, transport=transport)
        self.engine = AsyncEngine(grad_fn, x0, cfg, latency, loss_fn, x_star,
                                  transport=transport)

    # -- checkpoint / restart -------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        e = self.engine
        return {
            "x": e.x.copy(), "t": e.t, "clock": e.clock,
            "cfg": dataclasses.asdict(
                dataclasses.replace(e.cfg, step_size=None)),  # fn not stored
            # host mode: the f64 reference matrix; device mode: the
            # resident f32 GradLedger pulled back (bit-exact round trip)
            "ledger_ts": e._ledger_ts.copy(),
            "ledger_g": e.ledger_host(),
            "busy_until": e._busy_until.copy(),
            "working_on": e._working_on.copy(),
            # iterate history: in-flight agents reference x^{t'} by
            # timestamp; without it a restored run would skip their
            # deliveries and diverge from the uninterrupted one
            "x_hist": {k: v.copy() for k, v in e._x_hist.items()},
            "rng_state": e.rng.bit_generator.state,
            # run history: without it every restore/reconfigure would
            # zero bytes_tx / comm_time / loss and corrupt comm-savings
            # comparisons that span a reconfiguration
            "hist": _copy_hist(e.hist),
            # stateful transports keep their own event rng;
            # without it a restored run would re-order deliveries and
            # diverge from the uninterrupted one
            "transport": e.transport.state_dict(),
        }

    def restore(self, snap: Dict[str, Any], cfg: EngineConfig) -> None:
        """Rebuild the engine from a snapshot. ``cfg`` supplies the
        non-serializable step_size fn (and may change r/rule — elastic)."""
        e = AsyncEngine(self._mk["grad_fn"], snap["x"], cfg,
                        self._mk["latency"], self._mk["loss_fn"],
                        self._mk["x_star"], transport=self._mk["transport"])
        e.t = snap["t"]
        e.clock = snap["clock"]
        e._ledger_ts = snap["ledger_ts"].copy()
        e.load_ledger(snap["ledger_g"])
        e._busy_until = snap["busy_until"].copy()
        e._working_on = snap["working_on"].copy()
        e._x_hist = {k: v.copy() for k, v in snap.get("x_hist", {}).items()}
        e.rng.bit_generator.state = snap["rng_state"]
        if "hist" in snap:              # older snapshots carry no history
            e.hist = _copy_hist(snap["hist"])
        if snap.get("transport"):
            e.transport.load_state(snap["transport"])
        self.engine = e

    # -- elastic reconfiguration ----------------------------------------
    def reconfigure(self, **changes) -> None:
        """Change r / rule / tau / crash schedule mid-run without losing
        optimizer progress (the paper's theory holds per-iteration for any
        S^t, so online changes of r are sound)."""
        snap = self.snapshot()
        cfg = dataclasses.replace(self.engine.cfg, **changes)
        self.restore(snap, cfg)

    def run(self, iters: int) -> History:
        return self.engine.run(iters)

    @property
    def x(self) -> np.ndarray:
        return self.engine.x
