"""Fixtures of the benchmark's own tests. ``cuda`` skips a test that needs
the card, deciding when the test runs, never at import."""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
