"""``lm_loss`` of hymba-1.5b (attention beside SSM heads, meta tokens as
the sliding window's sinks) under the K1 policies against the JAX package's
``jax.grad``, in fp32: 2 × 20 tokens after its 8 meta tokens, so that the
smoke config's window of 16 drops keys past the sinks in its swa layer,
beside its two full layers.  ``tests/test_torch_family_train.py``'s
``_check_family``: ``gemm="pallas"`` and ``"pallas_paired"`` structured and
blocked at bn 16, r ∈ {0, 0.05}; loss within 1e-5 relative, every weight's
gradient within rtol 1e-4 / atol 1e-5.
"""
import pytest

from test_torch_family_train import POLICIES, _check_family


@pytest.mark.parametrize("gemm,mode,block_n,rounding", POLICIES)
def test_hybrid_lm_loss_and_grads_match_jax(gemm, mode, block_n, rounding):
    cfg = _check_family("hymba-1.5b", gemm, mode, block_n, rounding, shape=(2, 20))
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert "hybrid_swa" in kinds and "hybrid_full" in kinds
    assert cfg.meta_tokens + 20 > cfg.sliding_window  # the window drops keys
