"""pytest settings of the benchmark's own tests (`benchmark/tests/`):
the `card` marker, for tests that need a CUDA card; the `card` fixture
skips them elsewhere.  Whether a card is present is decided in the
fixture, when a test runs, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card machine")
    return torch.device("cuda")
