"""Tests of the benchmark.  They run on the CPU at tiny sizes; those marked
``card`` run the cells on a CUDA device and skip without one.

    python3 -m pytest portbench/tests            # here, on the CPU
    python3 -m pytest portbench/tests -m card    # on the machine with the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs a cell on a CUDA device; skipped without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda")
