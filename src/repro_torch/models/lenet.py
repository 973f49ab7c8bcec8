"""LeNet-5, the architecture of the paper's Fig. 2, in PyTorch.

32x32x1 input → C1 conv 5x5x6 → pool → C3 conv 5x5x16 → pool →
C5 conv 5x5x120 (1x1 spatial) → F6 dense 84 → output dense 10.

The port of ``repro.models.lenet``.  Parameters are the reference's tree,
``{layer: {"w", "b"}}``, with HWIO conv weights and NHWC activations, so
weights carry across unchanged (:func:`lenet_params_from_numpy`).  Conv MAC
counts (valid padding, stride 1) give the paper's Table-I baseline of
405 600 multiplications:

    C1: 28·28·6·(5·5·1)   = 117 600
    C3: 10·10·16·(5·5·6)  = 240 000
    C5:  1·1·120·(5·5·16) =  48 000
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.paired_conv import conv_im2col, paired_conv, pool2_reference

# (kernel shape, output spatial positions) per conv layer — used by Table I.
LENET_CONV_SHAPES = {
    "conv1": ((5, 5, 1, 6), 28 * 28),
    "conv2": ((5, 5, 6, 16), 10 * 10),
    "conv3": ((5, 5, 16, 120), 1 * 1),
}
LENET_CONV_POSITIONS = {k: pos for k, (_, pos) in LENET_CONV_SHAPES.items()}
LENET_LAYERS = ("conv1", "conv2", "conv3", "fc1", "fc2")
_DENSE_SHAPES = {"fc1": (120, 84), "fc2": (84, 10)}

# "torch" is F.conv2d (the counterpart of the reference's "xla"), "im2col"
# the patch GEMM in plain PyTorch, "paired" the subtractor kernel (the
# counterpart of "pallas_paired").
CONV_IMPLS = ("torch", "im2col", "paired")


def init_lenet(
    seed: int = 0, *, device: str | torch.device | None = None, dtype=torch.float32
) -> dict:
    """He-initialised LeNet-5 parameters from a numpy generator."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (shape, _) in LENET_CONV_SHAPES.items():
        fan_in = shape[0] * shape[1] * shape[2]
        params[name] = {
            "w": rng.normal(size=shape) * np.sqrt(2.0 / fan_in),
            "b": np.zeros(shape[-1]),
        }
    for name, shape in _DENSE_SHAPES.items():
        params[name] = {
            "w": rng.normal(size=shape) * np.sqrt(2.0 / shape[0]),
            "b": np.zeros(shape[-1]),
        }
    return lenet_params_from_numpy(params, device=device, dtype=dtype)


def lenet_params_from_numpy(
    np_params: dict | str | os.PathLike,
    *,
    device: str | torch.device | None = None,
    dtype=torch.float32,
) -> dict:
    """Carry the JAX package's LeNet params across: a ``{layer: {"w", "b"}}``
    tree of arrays, or the trainer's ``.npz`` (keys ``<layer>_w``/``<layer>_b``).
    Layouts are unchanged (HWIO conv weights)."""
    dev = resolve_device(device)
    if not isinstance(np_params, dict):
        with np.load(np_params) as z:
            np_params = {
                layer: {"w": z[f"{layer}_w"], "b": z[f"{layer}_b"]}
                for layer in LENET_LAYERS
            }
    return {
        layer: {
            k: torch.tensor(np.asarray(np_params[layer][k]), dtype=dtype, device=dev)
            for k in ("w", "b")
        }
        for layer in LENET_LAYERS
    }


def _torch_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID, stride-1 F.conv2d on NHWC/HWIO tensors."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    return y.permute(0, 2, 3, 1)


def lenet_apply(
    params: dict,
    x: torch.Tensor,
    *,
    conv_impl: str = "torch",
    paired: dict | None = None,
    fuse_pool: bool = False,
) -> torch.Tensor:
    """Forward pass: x (N, 32, 32, 1) → logits (N, 10).

    ``conv_impl="paired"`` runs every conv through the subtractor kernel and
    needs ``paired`` — per-layer artifacts from
    ``repro_torch.core.transform.build_conv_pairings``, in any pairing mode.
    ``fuse_pool`` (paired only) moves the 2×2 max-pool after conv1/conv2 into
    the kernel epilogue, so one forward is three kernel launches, each with
    one (pooled) store.
    """
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
    if conv_impl == "paired" and paired is None:
        raise ValueError(
            "conv_impl='paired' needs per-layer pairing artifacts: pass "
            "paired=build_conv_pairings(params, rounding)"
        )
    fuse_pool = fuse_pool and conv_impl == "paired"

    def conv(name, x, pool=False):
        w, b = params[name]["w"], params[name]["b"]
        if conv_impl == "paired":
            if pool and fuse_pool:
                return paired_conv(
                    x, w, b, pairing=paired[name], activation="relu", pool="max2"
                )
            y = paired_conv(x, w, b, pairing=paired[name], activation="relu")
        elif conv_impl == "im2col":
            y = conv_im2col(x, w, b, activation="relu")
        else:
            y = F.relu(_torch_conv(x, w, b))
        return pool2_reference(y, "max2") if pool else y

    x = conv("conv1", x, pool=True)  # 28 → 14
    x = conv("conv2", x, pool=True)  # 10 → 5
    x = conv("conv3", x)  # 1
    x = x.reshape(x.shape[0], -1)  # (N, 120)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def lenet_loss(params: dict, images: torch.Tensor, labels: torch.Tensor):
    """Mean negative log-softmax of the label over F.conv2d's forward, and
    the batch accuracy as aux: ``(loss, acc)``, both 0-d tensors."""
    logits = lenet_apply(params, images)
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.long()
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


@torch.no_grad()
def lenet_accuracy(
    params: dict,
    images,
    labels,
    batch: int = 512,
    *,
    conv_impl: str = "torch",
    paired: dict | None = None,
    fuse_pool: bool = False,
) -> float:
    """Accuracy over a dataset (numpy or tensors), batched to bound memory.
    Runs on the device the params lie on."""
    ref = params["fc2"]["w"]
    hits = 0
    for i in range(0, images.shape[0], batch):
        xb = torch.as_tensor(images[i : i + batch], dtype=ref.dtype, device=ref.device)
        yb = torch.as_tensor(labels[i : i + batch], device=ref.device)
        logits = lenet_apply(
            params, xb, conv_impl=conv_impl, paired=paired, fuse_pool=fuse_pool
        )
        hits += int((logits.argmax(-1) == yb).sum())
    return hits / images.shape[0]
