import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (inside a fixture) "
        "where there is none")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def no_card():
    """Skips the test where there is a CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
