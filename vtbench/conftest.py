"""Test settings of the benchmark's own tests (``pytest vtbench/tests``).

Tests that need the card take the ``card`` fixture, which skips without
CUDA; the marker ``card`` names them, so ``pytest vtbench/tests -m card``
runs them alone on the card's machine.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
