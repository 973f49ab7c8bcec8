"""Optimizers: AdamW and SGD with momentum, global-norm clipping, and the
cosine schedule.

The port of ``repro.train.optimizer``.  There an optimizer is an
``(init, update)`` pair over parameter pytrees; here it is a
``torch.optim.Optimizer`` subclass whose ``step()`` does what ``update``
does, on every parameter's ``.grad``.  :func:`adamw` and :func:`sgd` bind
the hyper-parameters and return the constructor, so ``optimizer(params)``
takes the place of the reference's ``init``.  Kept exactly:

* each param group counts the steps taken in ``group["step"]``; a step sees
  ``t = step + 1`` (the reference's ``step1``), in the schedule and in the
  bias corrections;
* the schedule and the bias corrections are computed in fp32;
* global-norm clipping (AdamW's default: 1.0) scales the gradients of all
  groups together before the moments see them; a tensor-parallel rank's
  optimizer clips by the whole model's norm (:func:`mesh_global_norm`, its
  ``norm_fn``), so every rank scales alike;
* the moments are fp32 whatever the parameter's dtype, created when the
  optimizer is (as ``init`` does);
* AdamW's weight decay is decoupled and added to the update direction
  ``delta``; the parameter moves by ``lr·delta`` in fp32 and is cast back.

``torch.optim.AdamW`` and ``SGD`` are not reused: AdamW decays the
parameter before the update (``p *= 1 − lr·wd``) rather than adding to
``delta``, both keep their state in the parameter's dtype, both read a
float ``lr`` from the group instead of a schedule of the step, and neither
clips.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Iterable, Sequence
from functools import partial

import torch

from repro_torch.parallel.collectives import all_reduce

Schedule = Callable[[int], "float | torch.Tensor"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def mesh_global_norm(grads: Sequence[torch.Tensor], *, split: Sequence[tuple],
                     groups: dict) -> torch.Tensor:
    """The global norm of a whole model from one tensor-parallel rank's
    gradients, summed over the mesh already (``launch.steps.TrainStep``):
    each tensor's squares summed over the ranks that hold its other blocks,
    ``groups[split[i]]`` for the mesh axes ``split[i]`` that split tensor
    ``i`` (``model``; FSDP's data axes; both), one all-reduce of one fp32
    scalar for each set of axes in ``groups`` (a set no tensor splits over
    sums 0), in their sorted order; those of the tensors every rank holds
    whole (``()``) counted once; in fp32."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sq: dict[tuple, torch.Tensor] = {}
    for g, axes in zip(grads, split, strict=True):
        sq[axes] = sq.get(axes, zero) + torch.sum(torch.square(g.float()))
    total = sq.pop((), zero)
    for axes in sorted(set(sq) | set(groups)):
        total = total + all_reduce(sq.get(axes, zero).clone(), groups.get(axes))
    return torch.sqrt(total)


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float, norm_fn=global_norm
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` so their global norm (``norm_fn(grads)``) is at most
    ``max_norm``.

    Returns ``(clipped, norm)``.  The scale is fp32 and promotes the
    gradients as the reference's does (a bf16 gradient comes back fp32).
    """
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [g.to(torch.promote_types(g.dtype, scale.dtype)) * scale for g in grads], norm


def cosine_schedule(
    base_lr: float, total_steps: int, warmup_steps: int = 0, min_ratio: float = 0.1
) -> Callable[[int], torch.Tensor]:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``base_lr``
    down to ``min_ratio·base_lr`` at ``total_steps``; an fp32 0-d tensor."""

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * warm * cos

    return lr


class _ScheduledOptimizer(torch.optim.Optimizer):
    """Shared plumbing: an fp32 learning-rate schedule of ``t``, optional
    global-norm clipping over every group (by ``norm_fn``, :func:`global_norm`
    unless set; the last step's norm in ``last_norm``), fp32 state made up
    front."""

    STATE: tuple[str, ...] = ()

    def __init__(self, params, lr: float | Schedule, grad_clip: float | None, defaults: dict):
        super().__init__(params, {**defaults, "step": 0})
        self.lr_fn: Schedule = lr if callable(lr) else (lambda _: lr)
        self.grad_clip = grad_clip
        self.norm_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm
        self.last_norm: torch.Tensor | None = None
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    k: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.preserve_format)
                    for k in self.STATE
                }

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        # a parameter without a gradient moves as under a zero gradient, as in the reference
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.grad_clip is not None:
            grads, self.last_norm = clip_by_global_norm(grads, self.grad_clip, self.norm_fn)
        grads = iter(grads)
        for group in self.param_groups:
            t = group["step"] + 1
            lr_t = self.lr_fn(t)
            for p in group["params"]:
                self._update(group, t, lr_t, p, next(grads).float(), self.state[p])
            group["step"] = t
        return loss

    def _update(self, group, t, lr_t, p, g32, state) -> None:
        raise NotImplementedError


class AdamW(_ScheduledOptimizer):
    """AdamW with decoupled weight decay and global-norm clipping."""

    STATE = ("m", "v")

    def __init__(self, params, lr: float | Schedule = 1e-3, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float | None = 1.0):
        super().__init__(params, lr, grad_clip,
                         dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))

    def _update(self, group, t, lr_t, p, g32, state) -> None:
        b1, b2 = group["b1"], group["b2"]
        t32 = torch.tensor(t, dtype=torch.float32)
        c1, c2 = 1.0 - b1**t32, 1.0 - b2**t32
        m, v = state["m"], state["v"]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        delta = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
        p32 = p.float()
        if group["weight_decay"]:
            delta = delta + group["weight_decay"] * p32
        p.copy_(p32 - lr_t * delta)


class SGD(_ScheduledOptimizer):
    """SGD with (heavy-ball) momentum and optional global-norm clipping."""

    STATE = ("mom",)

    def __init__(self, params, lr: float | Schedule = 1e-2, *, momentum: float = 0.9,
                 grad_clip: float | None = None):
        super().__init__(params, lr, grad_clip, dict(momentum=momentum))

    def _update(self, group, t, lr_t, p, g32, state) -> None:
        mom = state["mom"]
        mom.mul_(group["momentum"]).add_(g32)
        p.copy_(p.float() - lr_t * mom)


def adamw(lr: float | Schedule = 1e-3, **kw) -> Callable[..., AdamW]:
    """The AdamW constructor with these hyper-parameters bound:
    ``adamw(lr, ...)(params)`` is the reference's ``adamw(lr, ...).init``."""
    return partial(AdamW, lr=lr, **kw)


def sgd(lr: float | Schedule = 1e-2, **kw) -> Callable[..., SGD]:
    """The SGD constructor with these hyper-parameters bound."""
    return partial(SGD, lr=lr, **kw)
