"""The benchmark's own tests. ``card`` marks a test that needs a CUDA
device: it asks for the ``card`` fixture, which skips it where there is
none (decided when the test runs, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
