"""Shared set-up of the benchmark's tests: the checkout's root on the
import path, the ``card`` marker, and a fixture that skips a test that
needs a CUDA card where there is none (decided when the test runs, never
at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest portbench/tests -m card)")
    return torch.device("cuda", 0)
