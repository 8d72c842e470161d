"""The harness, its reference and the port importable from the tests; a
fixture that decides inside itself whether a card is present."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a cell of the benchmark runs only on the card")
    return torch.device("cuda", 0)
