"""CPU tests of the benchmark; tests that need a CUDA card carry the ``card`` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on the chip (perfbench/README.md)")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided when the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
