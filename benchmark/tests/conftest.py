"""The benchmark's own tests: on the CPU at debug widths, but for those
marked ``cuda``, which run the cells' own sizes on the card.

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m cuda    # on a machine with a card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
