"""Train LeNet-5 for the paper reproduction, with an on-disk cache.

The port of ``repro.train.lenet_trainer``.  Table I and Fig. 8
(``repro_torch.benchmarks``) and the examples need the same trained
weights; :func:`get_trained_lenet` trains once and caches them under
``.cache/``, in the reference's keys (``<layer>_w``, ``<layer>_b``, HWIO
conv weights), so ``lenet_params_from_numpy`` reads either package's file.
"""
from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.data.mnist import batches, load_mnist, pad_to_32
from repro_torch.device import resolve_device
from repro_torch.models.lenet import (
    init_lenet,
    lenet_accuracy,
    lenet_loss,
    lenet_params_from_numpy,
)
from repro_torch.train.loop import train
from repro_torch.train.optimizer import adamw, cosine_schedule

CACHE = Path(".cache")
BATCH = 128


def _save_atomic(path: Path, params: dict) -> None:
    """Write the weights to a temporary file beside ``path``, then rename:
    several processes (test workers) may train the same file at once."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{f"{layer}_{k}": t.cpu().numpy()
                           for layer, sub in params.items() for k, t in sub.items()})
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def get_trained_lenet(
    *,
    epochs: int = 3,
    train_n: int = 20000,
    test_n: int = 4000,
    seed: int = 0,
    cache: bool = True,
    verbose: bool = False,
    device: str | torch.device | None = None,
):
    """Returns ``(params, test_images32, test_labels, info)``; the params lie
    on ``device`` (the card unless ``"cpu"`` is asked for).

    Trains from the port's seeded ``init_lenet(seed)`` with AdamW under a
    cosine schedule (warm-up 50 steps), batches of 128, the reference's
    recipe.  ``info`` has ``source``, ``test_acc`` and ``cached``; after
    training also ``train_steps``, ``train_seconds`` and ``losses``.
    """
    dev = resolve_device(device)
    # A name of its own: a file the JAX trainer wrote (``lenet_e…``) would
    # otherwise be read back here and the port's trainer never run.
    cache_file = CACHE / f"lenet_torch_e{epochs}_n{train_n}_s{seed}.npz"

    test_x, test_y, source = load_mnist("test", synthetic_n=test_n, seed=seed)
    test_x32 = pad_to_32(test_x)

    if cache and cache_file.exists():
        params = lenet_params_from_numpy(cache_file, device=dev)
        acc = lenet_accuracy(params, test_x32, test_y)
        return params, test_x32, test_y, {"source": source, "test_acc": acc, "cached": True}

    train_x, train_y, _ = load_mnist("train", synthetic_n=train_n, seed=seed)
    train_x32 = pad_to_32(train_x)

    params = init_lenet(seed, device=dev)
    steps_per_epoch = train_n // BATCH
    opt = adamw(cosine_schedule(1e-3, steps_per_epoch * epochs, warmup_steps=50))
    data = batches(train_x32, train_y, BATCH, seed=seed, epochs=epochs)
    t0 = time.perf_counter()
    params, info = train(params, lenet_loss, opt, data, log_every=0, verbose=verbose)
    seconds = time.perf_counter() - t0  # each step ends in reading its loss

    if cache:
        CACHE.mkdir(exist_ok=True)
        _save_atomic(cache_file, params)

    acc = lenet_accuracy(params, test_x32, test_y)
    return params, test_x32, test_y, {
        "source": source,
        "test_acc": acc,
        "cached": False,
        "train_steps": info["steps"],
        "train_seconds": seconds,
        "losses": info["losses"],
    }
