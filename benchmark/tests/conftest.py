"""Settings of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``).

Tests that need an NVIDIA GPU carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the decision is
made when the fixture runs, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return "cuda:0"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
