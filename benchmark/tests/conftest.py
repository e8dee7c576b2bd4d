import pytest


@pytest.fixture
def card():
    """The first CUDA device; skips without one (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda benchmark/tests)")
    return torch.device("cuda", 0)
