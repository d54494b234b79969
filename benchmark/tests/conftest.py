"""Tests of the benchmark harness.  They run here on the CPU at tiny
sizes through the program's plain path; those marked ``card`` need a
CUDA card and skip without one (the check is made inside a fixture,
never at import).  On a machine with the card:

    python -m pytest benchmark/tests -q -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def spec():
    from benchmark import harness

    return harness.load_spec(ROOT)
