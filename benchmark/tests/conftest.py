"""Tests of the benchmark harness.

``card`` marks a test that needs a CUDA card; the ``card`` fixture decides
at run time, never at import, and skips without one. On the card:

    python -m pytest benchmark/tests -m card -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs on the chip")
    return "cuda"
