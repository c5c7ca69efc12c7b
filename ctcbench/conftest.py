"""pytest settings of the benchmark's own tests (``ctcbench/tests``).

``card`` marks a test that needs a CUDA card; the ``card`` fixture decides
inside the test whether there is one and skips with a reason where there is
not, so every worker collects the same tests.

    python -m pytest ctcbench/tests -q             # here, on the CPU
    python -m pytest ctcbench/tests -q -m card     # on a machine with a card
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)
