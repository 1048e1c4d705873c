"""Device selection for the port's entry points: a CUDA card unless the
caller asks for the CPU, and never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA on a machine
    without it. A bare ``"cuda"`` gets the current card's index, so the
    result compares equal to the ``.device`` of tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
