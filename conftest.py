"""pytest settings of the PyTorch port's tests.

Registers the ``cuda`` marker: tests that need an NVIDIA GPU (the CUDA
kernel has no CPU mode) carry it and skip, with a reason, where there is
no card.  ``tests/conftest.py`` sets up paths and shared fixtures.

Under pytest-xdist each worker gives PyTorch its share of the CPU's cores
for its intra-op threads: six workers of as many threads as cores each
oversubscribe the CPU, and OpenMP's spinning threads then make a CPU-bound
test 20× slower (LeNet's two training epochs of ``test_torch_train.py``:
17 s a worker with one thread each, 365 s with eight, six at once on
eight cores).
"""
import os


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skipped with a reason where there is none",
    )
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers and os.environ.get("PYTEST_XDIST_WORKER"):
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
