"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the checkout. Tests that need the card are marked `cuda` and skip
where there is none (decided inside the `card` fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
