"""The benchmark's own tests.  They import ``benchmark/`` modules by the
names ``run.py`` gives them (the checkout's root and ``benchmark/`` on
the path), never JAX.

Tests marked ``card`` need an NVIDIA card and skip without one; on the
card: ``python3 -m pytest benchmark/tests -m card``.  Whether a card is
present is decided inside the ``card`` fixture, never at import."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return "cuda"
