"""MNIST: the IDX reader and a deterministic synthetic fallback (numpy only).

The port of ``repro.data.mnist``; it downloads nothing.  The real IDX files
(``train-images-idx3-ubyte`` etc., optionally ``.gz``) are read from
``data_dir`` or ``$MNIST_DIR`` when they are there.  Otherwise
:func:`load_mnist` returns the *synthetic MNIST* of the reference:
seven-segment digit skeletons rasterised at 28x28 with random affine jitter,
stroke thickness and pixel noise, seeded: the reference's images for the
same seed, returned as the float32 its docstring promises (the reference
returns float64, which JAX casts to float32 on use).
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

# ---------------------------------------------------------------------------
# Real MNIST (IDX format)
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: Path):
    if path.exists():
        return open(path, "rb")
    gz = path.with_name(path.name + ".gz")
    if gz.exists():
        return gzip.open(gz, "rb")
    return None


def _read_idx(f) -> np.ndarray:
    magic, = struct.unpack(">I", f.read(4))
    ndim = magic & 0xFF
    shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
    return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _try_load_real(split: str, data_dir: str | None):
    dirs = [data_dir, os.environ.get("MNIST_DIR")]
    img_name, lbl_name = _FILES[split]
    for d in dirs:
        if not d:
            continue
        base = Path(d).expanduser()
        fi = _open_maybe_gz(base / img_name)
        fl = _open_maybe_gz(base / lbl_name)
        if fi and fl:
            with fi, fl:
                images = _read_idx(fi).astype(np.float32) / 255.0
                labels = _read_idx(fl).astype(np.int32)
            return images[..., None], labels
        for f in (fi, fl):
            if f:
                f.close()
    return None


# ---------------------------------------------------------------------------
# Synthetic fallback: jittered seven-segment digits
# ---------------------------------------------------------------------------

# segment endpoints in a unit box: (x0, y0, x1, y1); y grows downward
_SEGS = {
    "a": (0.2, 0.1, 0.8, 0.1),  # top
    "b": (0.8, 0.1, 0.8, 0.5),  # top-right
    "c": (0.8, 0.5, 0.8, 0.9),  # bottom-right
    "d": (0.2, 0.9, 0.8, 0.9),  # bottom
    "e": (0.2, 0.5, 0.2, 0.9),  # bottom-left
    "f": (0.2, 0.1, 0.2, 0.5),  # top-left
    "g": (0.2, 0.5, 0.8, 0.5),  # middle
}

_DIGIT_SEGS = {
    0: "abcdef",
    1: "bc",
    2: "abged",
    3: "abgcd",
    4: "fgbc",
    5: "afgcd",
    6: "afgedc",
    7: "abc",
    8: "abcdefg",
    9: "abcdfg",
}


def _raster_digit(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    """Rasterise one jittered seven-segment digit into (size, size) [0,1]."""
    img = np.zeros((size, size), dtype=np.float32)
    # random affine: scale, rotation, shift
    scale = rng.uniform(0.62, 0.92)
    theta = rng.uniform(-0.22, 0.22)
    cx, cy = rng.uniform(0.38, 0.62), rng.uniform(0.38, 0.62)
    ct, st_ = np.cos(theta), np.sin(theta)
    thick = rng.uniform(0.055, 0.095)
    seg_jit = rng.normal(0.0, 0.012, size=(7, 4))

    ys, xs = np.mgrid[0:size, 0:size]
    px = (xs + 0.5) / size
    py = (ys + 0.5) / size

    for si, seg in enumerate(_SEGS):
        if seg not in _DIGIT_SEGS[digit]:
            continue
        x0, y0, x1, y1 = np.array(_SEGS[seg]) + seg_jit[si % 7]
        # transform endpoints: center, rotate, scale, shift
        pts = []
        for (u, v) in ((x0, y0), (x1, y1)):
            u, v = u - 0.5, v - 0.5
            u, v = ct * u - st_ * v, st_ * u + ct * v
            pts.append((cx + scale * u, cy + scale * v))
        (ax, ay), (bx, by) = pts
        # distance from each pixel to the segment
        dx, dy = bx - ax, by - ay
        L2 = dx * dx + dy * dy + 1e-9
        t = np.clip(((px - ax) * dx + (py - ay) * dy) / L2, 0.0, 1.0)
        dist = np.sqrt((px - (ax + t * dx)) ** 2 + (py - (ay + t * dy)) ** 2)
        img = np.maximum(img, np.clip(1.2 - dist / thick, 0.0, 1.0))

    img = np.clip(img, 0.0, 1.0)
    img += rng.normal(0.0, 0.06, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthetic_mnist(
    n: int, seed: int = 0, size: int = 28
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic digits: (n, size, size, 1) float32, (n,) int32."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.stack([_raster_digit(int(d), rng, size) for d in labels])
    return images[..., None].astype(np.float32), labels


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def load_mnist(
    split: str = "train",
    *,
    data_dir: str | None = None,
    synthetic_n: int | None = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, str]:
    """Returns (images NHWC float32 [0,1], labels int32, source).

    source is "real" when IDX files were found, else "synthetic".
    """
    real = _try_load_real(split, data_dir)
    if real is not None:
        return real[0], real[1], "real"
    n = synthetic_n or (20000 if split == "train" else 4000)
    # different seeds per split so test is disjoint from train
    imgs, lbls = synthetic_mnist(n, seed=seed + (0 if split == "train" else 10_007))
    return imgs, lbls, "synthetic"


def pad_to_32(images: np.ndarray) -> np.ndarray:
    """LeNet-5 takes 32x32 inputs (paper Fig. 2); MNIST is 28x28 → pad."""
    return np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)))


def batches(images, labels, batch_size: int, *, seed: int = 0, epochs: int = 1):
    """Shuffled minibatches, host-side and seeded: one permutation of the
    whole set per epoch, no ragged last batch.  The reference's batches, in
    the reference's order, for the same arrays and seed."""
    n = images.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i : i + batch_size]
            yield images[sel], labels[sel]
