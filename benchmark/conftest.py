"""pytest settings of the benchmark's tests (``python -m pytest
benchmark/tests``).  Tests that need the card carry the ``cuda`` marker and
skip without one; they decide in the ``cuda_device`` fixture, never while a
module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one); on the card: "
                   "python3 -m pytest benchmark/tests -m cuda")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reference's CUDA-graph path runs only there")
    return "cuda"
