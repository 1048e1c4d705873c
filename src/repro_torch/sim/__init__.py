"""repro_torch.sim — deterministic fault-injection cluster simulator.

Torch port of ``repro.sim``: a virtual-clock, event-driven scenario
engine (DESIGN.md §10) that drives both the training stack
(``core.async_engine`` fresh+stale) and the serving stack
(``serve.dispatch``) through one shared fault model:

- :mod:`repro_torch.sim.clock` — virtual time + seeded event heap (no
  wall-clock anywhere).
- :mod:`repro_torch.sim.faults` — composable fault schedules
  (crash/recover windows, straggler ramps, message drop/duplicate/
  reorder, mid-run Byzantine switches, elastic churn) and the
  :class:`SimTransport` that injects them through the
  ``core.async_engine.Transport`` seam.
- :mod:`repro_torch.sim.scenario` — declarative :class:`Scenario` spec,
  the named-scenario registry, and the train/serve runners.
- :mod:`repro_torch.sim.conformance` — paper-bound checks (Theorem-2
  error envelope via ``core.redundancy``, §3.2 T-set invariants,
  liveness).
- :mod:`repro_torch.sim.golden` — replay of the committed golden traces.
- :mod:`repro_torch.sim.e2e` — the same fault model over real replicated
  ``ServeEngine``s.
- :mod:`repro_torch.sim.fleet_e2e` — the same replay through the fleet
  controller: detection from silence, hedged re-dispatch, checkpoint
  rejoin.
- :mod:`repro_torch.sim.realtime_chaos` — kill/pause/slow plans against
  the wall-clock fleet on real threads and timers.
"""
from repro_torch.sim.clock import EventHeap, VirtualClock
from repro_torch.sim.faults import (ByzantineSwitch, ChurnEvent, CrashWindow,
                                    FaultSchedule, MessageFaults,
                                    SimTransport, StragglerRamp)
from repro_torch.sim.scenario import (SCENARIOS, Scenario, get_scenario,
                                      run_serve, run_train)

__all__ = [
    "EventHeap", "VirtualClock",
    "CrashWindow", "StragglerRamp", "MessageFaults", "ByzantineSwitch",
    "ChurnEvent", "FaultSchedule", "SimTransport",
    "Scenario", "SCENARIOS", "get_scenario", "run_train", "run_serve",
]
