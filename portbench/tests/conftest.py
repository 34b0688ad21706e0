"""The benchmark's own tests: run from the repository's root with

    python -m pytest portbench/tests -q

They import the harness as the benchmark does (portbench/ and the
repository's root on sys.path) and run on the CPU at toy sizes; the tests
marked `card` need a CUDA device and skip without one."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, BENCH, os.path.dirname(BENCH)) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips on the CPU")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's own size on the card)")
    return torch.device("cuda")
