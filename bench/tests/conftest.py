"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the repository. Tests that need an NVIDIA card carry the ``card``
marker and skip without one (decided inside the ``card`` fixture, never
while a module is imported)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")
