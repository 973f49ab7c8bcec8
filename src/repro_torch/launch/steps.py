"""The LM training step.

The port of ``repro.launch.steps.build_train_step``, on one device: the
mesh and sharding rules of the JAX package wait for tensor parallelism, and
its abstract-shape builders for the dry run have no counterpart.  The GEMM
policy comes from ``knobs``, as the JAX package's ``perf_context(knobs)``
sets it: under ``gemm="pallas"`` every layer GEMM's forward is a launch of
K1's dense form, under ``"pallas_paired"`` every weight that carries
pairing metadata is one of K1's paired forms, an MoE layer's experts one
launch a projection over the expert grid; the backward is ``torch.matmul``
or ``torch.einsum`` on the folded weights either way (``kernels.ops``).
Every family trains: dense, MoE (olmoe, deepseek with MLA and shared
experts), SSM, hybrid, encoder-decoder and vision-language models, the last
two with their ``frames`` or ``patches`` in the batch.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as M


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """``step(model, opt_state, step, batch) -> metrics``: the gradient of
    ``lm_loss`` and one optimizer update, as step ``step`` (the index the
    JAX package passes to ``opt.update``; the schedule and bias corrections
    see ``step + 1``).  ``opt_state`` is the optimizer :meth:`init` builds,
    which holds the moments and updates the model's weights in place.
    ``metrics`` holds ``loss``, ``xent`` and ``aux``, detached fp32 scalars
    on the device."""

    cfg: ModelConfig
    opt: Callable[..., torch.optim.Optimizer]  # train.optimizer.adamw(...) or sgd(...)
    knobs: M.PerfKnobs

    def init(self, model: M.LM) -> torch.optim.Optimizer:
        """Make ``model``'s weights trainable and build the optimizer over
        them (the JAX package's ``opt.init(params)``).  Copies of the model
        share these weights; the serving engines run under ``no_grad``, so
        theirs track nothing."""
        model.requires_grad_(True)
        return self.opt(list(model.parameters()))

    def __call__(self, model: M.LM, opt_state: torch.optim.Optimizer, step: int,
                 batch: dict) -> dict[str, torch.Tensor]:
        opt_state.zero_grad(set_to_none=True)
        loss, metrics = M.lm_loss(self.cfg, model, batch, knobs=self.knobs)
        loss.backward()
        for group in opt_state.param_groups:
            group["step"] = int(step)
        opt_state.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def build_train_step(cfg: ModelConfig, opt: Callable[..., torch.optim.Optimizer],
                     knobs: M.PerfKnobs) -> TrainStep:
    """The training step of ``cfg`` under ``knobs`` with optimizer ``opt``
    (a constructor over the parameters, the JAX package's ``Optimizer``)."""
    return TrainStep(cfg, opt, knobs)
