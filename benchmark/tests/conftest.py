"""The benchmark's CPU tests (``python -m pytest benchmark/tests -q``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them, inside the test, where torch sees no CUDA device.
On the card: ``python -m pytest benchmark/tests -q -m card``.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    return tmp_path
