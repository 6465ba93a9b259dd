"""The benchmark's own tests: `python -m pytest benchmark/tests -q` on the CPU;
the tests marked `gpu` run on the card (`-m gpu`) and skip elsewhere."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test asks, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
