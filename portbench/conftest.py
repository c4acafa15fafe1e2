"""pytest settings of the benchmark's own tests (portbench/tests).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch finds no card; the decision is made
when the test runs, never when a module is imported.

    python -m pytest portbench/tests -q            # CPU: card tests skip
    python -m pytest portbench/tests -q -m card    # on a machine with a card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where torch finds none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
