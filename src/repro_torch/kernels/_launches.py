"""Launch counters of the kernel wrappers, shared by every thread.

Each wrapper adds one to its entry of its module's ``LAUNCHES`` table
where it launches its kernel. Engines decoding on several threads (the
wall-clock fleet) launch concurrently, and ``table[name] += 1`` is a
read-modify-write a thread switch can tear, so every update and reset
goes through one lock.
"""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()


def count(table: Dict[str, int], name: str) -> None:
    with _lock:
        table[name] += 1


def reset(table: Dict[str, int]) -> None:
    with _lock:
        for k in table:
            table[k] = 0
