"""repro_torch.checkpoint — atomic checkpoints and elastic resizing
(counterpart of ``repro.checkpoint``).

- ``checkpointer`` ``Checkpointer``: ``step_<N>/arrays.npz`` plus a
                   manifest, written by a background thread into a
                   ``.tmp`` directory and renamed into place; the flat
                   keys are the reference's, so a checkpoint written by
                   either package restores through the other.
- ``elastic``      resizes the per-agent leaves of a flat checkpoint when
                   the agent (replica) count changes.
"""
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import (rebatch_global,
                                            reshard_agent_state,
                                            resize_agent_axis)

__all__ = ["Checkpointer", "rebatch_global", "reshard_agent_state",
           "resize_agent_axis"]
