"""deepseek-v2-lite-16b's training path (MLA, shared experts, a dense first
layer) against the JAX package's ``jax.grad``, in fp32.

* ``lm_loss`` and every weight's gradient under ``gemm="pallas_paired"``,
  the routed experts on K1's expert grid, the shared experts and MLA's
  projections on K1's paired forms: structured and blocked at bn 16, r ∈
  {0, 0.05}, on the routed branch (2 × 7 tokens) and the dense one (1 × 4)
  (``test_torch_moe_train.py``'s ``_check_moe_lm``);
* the same config with every layer dense (MLA alone, no experts) under
  ``gemm="pallas"`` and ``"pallas_paired"`` (``test_torch_family_train.py``'s
  ``_check_family``).

Loss within 1e-5 relative, gradients within rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import pytest

from test_torch_family_train import POLICIES, _check_family
from test_torch_moe_train import MODEL_CASES, _check_moe_lm

ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("mode,block_n,rounding,branch", MODEL_CASES)
def test_deepseek_lm_loss_and_grads_match_jax(mode, block_n, rounding, branch):
    _check_moe_lm(ARCH, mode, block_n, rounding, branch)


@pytest.mark.parametrize("gemm,mode,block_n,rounding", POLICIES)
def test_mla_only_lm_loss_and_grads_match_jax(gemm, mode, block_n, rounding):
    """Every layer dense (``first_k_dense = n_layers``): MLA's projections
    and the dense MLP on K1."""
    every_layer_dense = lambda c: {"moe": dataclasses.replace(c.moe, first_k_dense=c.n_layers)}
    cfg = _check_family(ARCH, gemm, mode, block_n, rounding, fields=every_layer_dense)
    assert cfg.segments() == (("dense", cfg.n_layers),) and cfg.mla is not None
