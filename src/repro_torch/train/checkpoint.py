"""Atomic, keep-N checkpoints of parameter and optimizer-state trees.

The port of ``repro.train.checkpoint``.  A tree is nested dicts, lists and
tuples whose leaves are tensors, numpy arrays or Python numbers: the
parameter tree and an optimizer's per-parameter state dicts.  A checkpoint
is the directory ``step_<step:010d>`` holding ``shard_0.npz`` (one array a
leaf) and ``manifest.json`` (the step, the leaves' paths, the
caller's metadata):

* **atomic**: written into a temporary directory beside it and renamed into
  place, so a process that dies mid-write never leaves a partial step;
* **keep-N**: after each save only the newest ``keep`` steps remain;
* **resumable**: :func:`latest_step` and :func:`restore_checkpoint` bring
  back whatever survived, into the structure, dtypes and devices of a tree
  the caller passes.

One process writes; the shard's name keeps the reference's layout, which
numbers a shard by its process.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch


def flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs, dict keys in sorted order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str) for kv in flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree) for kv in flatten(sub, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like, key=str)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        return np.asarray(leaf)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _like(saved: np.ndarray, leaf: Any) -> Any:
    """``saved`` as the type, dtype and device of ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(saved).to(dtype=leaf.dtype, device=leaf.device)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.asarray(saved, dtype=leaf.dtype)
    return type(leaf)(saved.item())


SHARD = "shard_0.npz"


def save_checkpoint(
    ckpt_dir: str | os.PathLike,
    step: int,
    tree: Any,
    *,
    metadata: dict | None = None,
    keep: int = 3,
) -> Path:
    """Atomically write ``tree`` as checkpoint ``step``; returns its path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = flatten(tree)
    manifest = {
        "step": int(step),
        "paths": [p for p, _ in flat],
        "metadata": metadata or {},
    }
    final = ckpt_dir / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / SHARD,
                 **{f"arr_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():  # a retry after a partial failure
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(p.name for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore_checkpoint(
    ckpt_dir: str | os.PathLike, tree_like: Any, *, step: int | None = None
) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (the newest step unless
    ``step`` is given): each leaf comes back as the type, dtype and device
    of its counterpart there.  Returns ``(tree, metadata)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    final = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((final / "manifest.json").read_text())
    flat_like = flatten(tree_like)
    if [p for p, _ in flat_like] != manifest["paths"]:
        raise ValueError(
            f"checkpoint leaves {manifest['paths']} do not match the target tree's "
            f"{[p for p, _ in flat_like]}"
        )
    with np.load(final / SHARD) as z:
        leaves = [_like(z[f"arr_{i}"], leaf) for i, (_, leaf) in enumerate(flat_like)]
    return _unflatten(tree_like, iter(leaves)), manifest["metadata"]
