"""The benchmark's own tests: on the CPU at tiny sizes, and, marked
``cuda``, on the card (``python -m pytest cellbench/tests -m cuda``)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(4)


@pytest.fixture
def card():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
