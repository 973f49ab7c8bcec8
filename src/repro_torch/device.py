"""The one place the port picks a device.

The JAX package decides between the TPU kernels and interpret mode in
``repro.kernels.ops._on_tpu``.  The port's entry points run on the GPU
unless the caller asks for the CPU: nothing falls back to the CPU when
CUDA is missing.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device raises when CUDA is missing.

    Pass ``"cpu"`` explicitly to run the plain PyTorch versions of the
    kernels (what the CPU tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions instead"
        )
    return dev
