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

:func:`save_train_state` and :func:`restore_train_state` checkpoint a
training run: its parameters and the optimizer's moments, with the step.
A tensor-parallel run stores "plain host arrays, re-placed on load", as
the JAX package does: every rank gathers each weight and moment whole
(``whole``, ``launch.steps.TrainStep.whole``), one rank writes, and a run
on any mesh shape, or on one device, restores by slicing the whole arrays
to its own blocks (``take``).

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
    ckpt_dir: str | os.PathLike, tree_like: Any, *, step: int | None = None, load=None
) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (the newest step unless
    ``step`` is given): each leaf comes back as the type, dtype and device
    of its counterpart there, or as ``load(i, saved, leaf)`` gives it for
    the ``i``-th leaf.  Returns ``(tree, metadata)``."""
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
    load = load or (lambda i, saved, leaf: _like(saved, leaf))
    with np.load(final / SHARD) as z:
        leaves = [load(i, z[f"arr_{i}"], leaf) for i, (_, leaf) in enumerate(flat_like)]
    return _unflatten(tree_like, iter(leaves)), manifest["metadata"]


def _train_state(params: dict, optimizer: torch.optim.Optimizer):
    """``(params, [the optimizer's state of each leaf])``: what a run needs
    to continue, beside its step counter."""
    return params, [optimizer.state[leaf] for _, leaf in flatten(params)]


def _named_leaves(params: dict, optimizer: torch.optim.Optimizer) -> list[tuple[str, Any]]:
    """Each leaf of :func:`_train_state` in its flattened order (every
    parameter leaf, then each one's moments), beside the key of ``params``
    it sits under: the parameter's name."""
    keyed = [(k, leaf) for k in sorted(params, key=str) for _, leaf in flatten(params[k])]
    return [*keyed, *((k, v) for k, leaf in keyed for _, v in flatten(optimizer.state[leaf]))]


def save_train_state(ckpt_dir: str | os.PathLike, step: int, params: dict,
                     optimizer: torch.optim.Optimizer, *, keep: int = 3,
                     whole=None, write: bool = True) -> Path | None:
    """Checkpoint ``params`` (the optimizer's parameters by name) and their
    optimizer state as step ``step``.  ``whole(name, tensor)`` gives the
    whole tensor of parameter ``name``'s leaf (a tensor-parallel rank
    gathers it: every rank calls this, in the same order); only a caller
    with ``write`` writes (returns None otherwise)."""
    state = _train_state(params, optimizer)
    if whole is not None:
        gathered = iter([whole(name, t) for name, t in _named_leaves(params, optimizer)])
        state = _unflatten(state, gathered)
    if not write:
        return None
    return save_checkpoint(ckpt_dir, step, state, metadata={"step": int(step)}, keep=keep)


def restore_train_state(ckpt_dir: str | os.PathLike, params: Any,
                        optimizer: torch.optim.Optimizer, *, take=None) -> int:
    """Copy the newest checkpoint's parameters and optimizer state into
    ``params`` and ``optimizer`` in place; returns its step.  ``take(name,
    array)`` gives this rank's block of parameter ``name``'s whole saved
    array (a tensor-parallel rank's slice of it; by default the whole
    array), one leaf at a time."""
    take = take or (lambda name, a: torch.as_tensor(a))
    names = [name for name, _ in _named_leaves(params, optimizer)]

    def load(i, saved, dst):
        return dst.copy_(take(names[i], saved))

    with torch.no_grad():
        _, meta = restore_checkpoint(ckpt_dir, _train_state(params, optimizer), load=load)
    return int(meta.get("step", latest_step(ckpt_dir)))
