"""The card's published peaks and its power limit.

A frozen copy of ``chip_smoke.py:card_peaks``: NVIDIA's data sheet for
the H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16), at the full 700 W. A card
set below that runs slower under load, so every result carries the
limit that ``nvidia-smi`` reads beside the peaks.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional


def card_peaks(name: str) -> Dict[str, float]:
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12}
    raise RuntimeError(f"no data-sheet peaks for {name!r}: the bounds are "
                       "stated for an H100 SXM")


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s power limit of card 0 (e.g. ``700.00 W``), or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
