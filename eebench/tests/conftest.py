"""Settings of the benchmark's own tests (``python -m pytest eebench/tests -q``).

Tests that need the card carry the ``chip`` marker and take the ``cuda``
fixture, which skips them where there is no CUDA device; whether there is
one is decided inside the fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (run on the H100)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return "cuda"
