"""pytest settings of the PyTorch port's tests.

Registers the ``cuda`` marker: tests that need an NVIDIA GPU (the CUDA
kernel has no CPU mode) carry it and skip, with a reason, where there is
no card.  ``tests/conftest.py`` sets up paths and shared fixtures.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skipped with a reason where there is none",
    )
