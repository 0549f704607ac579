"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

They run on the CPU at tiny sizes; a test that needs the card takes the
``card`` fixture and is marked ``card``, and skips where there is none (the
fixture decides, when the test runs).  On the card:
``python -m pytest benchmark/tests -q -m card``."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; run on the card with -m card")
    return torch.device("cuda")
