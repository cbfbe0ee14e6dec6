"""The benchmark's CPU tests, and its card tests (marked `cuda`, skipped
without a CUDA device; the `cuda_device` fixture decides, never an import).

  python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")
