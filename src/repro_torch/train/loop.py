"""The single-process train loop: step, metrics, periodic checkpoints and
resume-from-latest.

The port of ``repro.train.loop``.  Parameters are a tree of tensors (the
LeNet layout ``{layer: {"w", "b"}}``); the loop trains a copy of them on
the device they lie on and returns it.
"""
from __future__ import annotations

import time
from collections.abc import Callable, Iterable
from typing import Any

import torch

from repro_torch.train.checkpoint import flatten, latest_step, restore_checkpoint, save_checkpoint


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer) -> Callable:
    """``loss_fn(params, *batch) -> (loss, aux)``.  Returns
    ``step(params, step_idx, *batch) -> (loss, aux)``: zero the gradients,
    run the loss, back-propagate, and step the optimizer as step
    ``step_idx`` (the index the reference passes to ``update``), which
    updates the leaves of ``params`` in place."""

    def step(params, step_idx: int, *batch):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(params, *batch)
        loss.backward()
        for group in optimizer.param_groups:
            group["step"] = step_idx
        optimizer.step()
        return loss.detach(), _map(torch.Tensor.detach, aux)

    return step


def train(
    params: Any,
    loss_fn: Callable,
    optimizer: Callable[..., torch.optim.Optimizer],
    data: Iterable,
    *,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    log_every: int = 50,
    max_steps: int | None = None,
    verbose: bool = True,
) -> tuple[Any, dict]:
    """Run the loop; resumes from ``ckpt_dir`` if it already has checkpoints.

    ``optimizer`` is what ``adamw(...)``/``sgd(...)`` return: a constructor
    over the parameter leaves (the reference's ``init``).  Batches are moved
    to the parameters' device.  Returns ``(params, info)``, with
    ``info = {"last_loss", "last_aux", "steps", "losses"}``: ``losses`` (the
    loss of every step, as floats) is the port's addition.
    """
    params = _map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = [leaf for _, leaf in flatten(params)]
    device = leaves[0].device
    opt = optimizer(leaves)
    moments = [opt.state[p] for p in leaves]
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        saved, meta = restore_checkpoint(ckpt_dir, (params, moments))
        with torch.no_grad():
            for (_, live), (_, value) in zip(flatten((params, moments)), flatten(saved),
                                             strict=True):
                live.copy_(value)
        start = meta.get("step", latest_step(ckpt_dir))
        if verbose:
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(loss_fn, opt)
    t0 = time.time()
    i = start
    last_loss, last_aux, losses = float("nan"), None, []
    for i, batch in enumerate(data, start=start):
        if max_steps is not None and i >= max_steps:
            break
        batch = tuple(torch.as_tensor(b, device=device) for b in batch)
        loss, aux = step_fn(params, i, *batch)
        last_loss, last_aux = float(loss), aux
        losses.append(last_loss)
        if verbose and log_every and (i + 1) % log_every == 0:
            print(
                f"[train] step {i+1} loss {last_loss:.4f} aux {_map(float, aux)}"
                f" ({(i + 1 - start) / (time.time() - t0):.1f} it/s)"
            )
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, (params, moments), metadata={"step": i + 1})
    if ckpt_dir and ckpt_every:
        save_checkpoint(ckpt_dir, i + 1, (params, moments), metadata={"step": i + 1})
    params = _map(torch.Tensor.detach, params)
    return params, {"last_loss": last_loss, "last_aux": last_aux, "steps": i + 1 - start,
                    "losses": losses}
