"""pytest settings of the benchmark's own tests (`benchmark/tests/`).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which decides inside the test whether a card is there and skips
with a reason when it is not.  Run them on the card with

    python3 -m pytest benchmark/tests -q -m card
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")
