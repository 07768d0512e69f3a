"""pytest settings for the benchmark's own tests (``python -m pytest
kbench -q``). Tests marked ``card`` need a CUDA device; each decides so in
its ``card`` fixture and skips without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips on the CPU)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100 only")
    return torch.device("cuda")
