"""Fixtures of the benchmark's CPU tests."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for path in (str(REPO), str(Path(__file__).resolve().parent)):
    if path not in sys.path:
        sys.path.insert(0, path)

from tiny_cell import make_tiny_root  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips where there is none")


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
