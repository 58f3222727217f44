"""The benchmark's tests: ``python -m pytest -q bench/tests`` from the root
of the repository.  They put ``src`` and ``bench`` on the path and run on
the CPU at smoke size; those marked ``chip`` need a CUDA card and skip
without one (the fixture ``card`` decides, when the test runs)."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control and the faults are read "
                    "at the cell's own size on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
