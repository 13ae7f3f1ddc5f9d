"""The benchmark's own tests: CPU tests, and tests marked `card` that run
only where a CUDA card is present (python -m pytest portbench/tests -m card
on the chip machine). Whether a card is present is decided inside the
`card` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip machine")
    return torch.device("cuda", 0)
