"""Tests of the benchmark.  Those that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is
none; nothing decides at import time whether a card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
