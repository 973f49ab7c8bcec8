"""FSDP beyond mistral-large-123b: every family whose weights a data split
can close, under its own ``train`` rules with ``embed`` put over ``data``.

The rules give FSDP to mistral-large-123b alone (the one config past
``FSDP_PARAM_THRESHOLD``), but nothing in the port's FSDP path is
mistral's: each layer's data-split leaves are read from the resolved specs
and gathered at the layer's top, whatever blocks it holds. On one (2, 2)
spawn of gloo ranks on the CPU, each smoke config in fp32 with
``embed`` over ``data`` takes one AdamW step (lr 1e-4, eps 1e-6, r = 0,
``gemm="pallas_paired"``, K1's plain version) on a global batch of 4 × 16
tokens; every rank's loss and its weights after the update (gathered
whole) are held to the single-device step's (rtol 1e-4 / atol 1e-5), and
its collectives, calls and bytes, to ``analysis.mesh_train_collectives``
under the same rules:

* deepseek-v2-lite-16b: MLA, a dense segment and an MoE segment with shared
  experts (the experts' d_model dims, the router's in fp32);
* olmoe-1b-7b: routed experts; qwen2-1.5b: qkv biases; qwen3-4b: qk-norm;
  granite-3-2b;
* mamba2-2.7b: the SSM block's d_model dims (w_z, w_x, w_B, w_C, w_dt,
  w_out);
* whisper-base: the encoder's layers and final norm, LayerNorm's biases,
  the cross-attention.

hymba-1.5b's ``meta`` tokens and internvl2-2b's ``vision_proj`` would split
over ``data`` too; the forward does not gather them, and the layout
refuses them by name.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch import analysis
from repro_torch.benchmarks.mesh_train import (
    PARITY_EPS,
    PARITY_LR,
    batch_dict,
    knobs_for,
    smoke_batches,
    train_many,
    violation,
)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as TM
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh, Rules
from repro_torch.parallel.tp import train_layout_for
from repro_torch.train.optimizer import adamw

ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b", "qwen2-1.5b", "qwen3-4b", "granite-3-2b",
         "mamba2-2.7b", "whisper-base")
REFUSED = {"hymba-1.5b": "meta", "internvl2-2b": "vision_proj"}
SHAPE = (2, 2)
MESH = Mesh({"data": 2, "model": 2})
B, S = 4, 16
KNOBS = knobs_for(0.0)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _rules(arch):
    """The config's own ``train`` rules with ``embed`` over ``data`` (FSDP)."""
    return Rules({**rules_for(_cfg(arch), "train", MESH).table, "embed": "data"})


@functools.cache
def _batches(arch):
    return smoke_batches(_cfg(arch), B, S, 1)


@pytest.fixture(scope="module")
def ranks():
    jobs = {arch: ("train_job", (_cfg(arch), 0, KNOBS, _batches(arch)),
                   {"gather": True, "lr": PARITY_LR, "eps": PARITY_EPS, "rules": _rules(arch)})
            for arch in ARCHS}
    return spawn(train_many, SHAPE, backend="gloo", device="cpu", args=(jobs,), timeout=300)


@functools.cache
def _single(arch):
    """The port's single-device step: its loss and its weights after it."""
    cfg = _cfg(arch)
    model = TM.init_lm(cfg, 0, device="cpu")
    step = build_train_step(cfg, adamw(PARITY_LR, eps=PARITY_EPS), KNOBS)
    opt = step.init(model)
    m = step(model, opt, 0, batch_dict(cfg, _batches(arch)[0], "cpu"))
    return float(m["loss"]), {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_step_equals_the_single_device(ranks, arch):
    loss, want = _single(arch)
    for r in ranks:
        rec = r[arch]
        assert rec["fsdp_axes"] == ("data",)
        assert violation(rec["metrics"][0]["loss"], loss) <= 0, arch
        assert max(violation(rec["params"][n], want[n]) for n in want) <= 0, arch
        assert np.isfinite(rec["metrics"][0]["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_equal_the_analysis(ranks, arch):
    """Each segment's layers gathered (twice: the recompute) and
    reduce-scattered, the encoder's too; the top gathers; the sums."""
    want = analysis.mesh_train_collectives(_cfg(arch), KNOBS, MESH, B, S, rules=_rules(arch))
    for r in ranks:
        assert r[arch]["collectives"][0] == want == r[arch]["want_collectives"], arch
    cfg = _cfg(arch)
    layers = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder is not None else 0)
    plain = analysis.mesh_train_collectives(cfg, KNOBS, MESH, B, S)
    assert want["reduce_scatter"]["calls"] - plain["reduce_scatter"]["calls"] >= layers + 2


@pytest.mark.parametrize("arch", list(REFUSED))
def test_ungathered_leaves_are_refused(arch):
    cfg = _cfg(arch)
    rules = Rules({**rules_for(cfg, "train", MESH).table, "embed": "data"})
    with pytest.raises(NotImplementedError, match=REFUSED[arch]):
        train_layout_for(cfg, MESH, rules, B, S)
