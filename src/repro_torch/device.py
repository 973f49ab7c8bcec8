"""The one place the port picks a device.

The JAX package decides between the TPU kernels and interpret mode in
``repro.kernels.ops._on_tpu``.  The port's entry points run on the GPU
unless the caller asks for the CPU: nothing falls back to the CPU when
CUDA is missing.  Under a ``FakeTensorMode`` (the dry run, ``launch.dryrun``)
a CUDA device is taken as it is asked for: a fake tensor allocates nothing
and launches nothing, so no card is needed.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device raises when CUDA is missing.

    Pass ``"cpu"`` explicitly to run the plain PyTorch versions of the
    kernels (what the CPU tests do).  Under a ``FakeTensorMode`` a CUDA
    device needs no card (:func:`fake_mode_active`).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not fake_mode_active():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions instead"
        )
    return dev


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is active: the tensors made now hold no
    memory, and no kernel may be built or launched for them."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None
