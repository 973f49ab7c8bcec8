"""``lm_loss`` of the port's other families under the K1 policies against
the JAX package's ``jax.grad``, in fp32.

The families whose forward earlier slices ported: mamba2-2.7b (SSM),
whisper-base (encoder-decoder, zero frames) and internvl2-2b (vision
prefix, zero patches: what the training CLI feeds them) here; hymba-1.5b in
``test_torch_hybrid_train.py`` and deepseek-v2-lite-16b with every layer
dense (MLA alone) in ``test_torch_mla_train.py``, through
:func:`_check_family`.  Same numpy inputs through ``repro`` and
``repro_torch``: the JAX package's seeded smoke init, its layer matrices
(the encoder's too) times 0.3 at r = 0.05, the JAX ``pair_lm_params``
metadata; JAX's Pallas kernels in interpret mode, the port's kernels as
their plain versions.  Under ``gemm="pallas"`` (K1's dense form) and
``"pallas_paired"`` structured and blocked at bn 16, r ∈ {0, 0.05}: loss
within 1e-5 relative, every weight's gradient within rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import transform as j_transform
from repro.models import lm as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as TM
from test_torch_lm_train import (
    LOSS_RTOL,
    _assert_grads,
    _jax,
    _port,
    _port_grad_tree,
    _values,
)

CHUNK = 4
POLICIES = [("pallas", "structured", 0, 0.0),
            ("pallas_paired", "structured", 0, 0.0), ("pallas_paired", "structured", 0, 0.05),
            ("pallas_paired", "column_blocked", 16, 0.0),
            ("pallas_paired", "column_blocked", 16, 0.05)]


def _extras(cfg, batch: int) -> dict:
    """Zero patches or frames, as the training CLI feeds them."""
    if cfg.vision_prefix:
        return {"patches": np.zeros((batch, cfg.vision_prefix, cfg.vision_embed_dim), np.float32)}
    if cfg.encoder is not None:
        return {"frames": np.zeros((batch, cfg.encoder.frames, cfg.d_model), np.float32)}
    return {}


def _check_family(arch, gemm, mode, block_n, rounding, *, shape=(2, 7), fields=None):
    """``lm_loss`` and every gradient of ``arch``'s smoke config (with the
    config ``fields`` that ``fields(cfg)`` returns replaced, in both
    packages) under one policy, on ``shape`` tokens, against ``jax.grad``."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if fields:
        jcfg, tcfg = (dataclasses.replace(c, **fields(c)) for c in (jcfg, tcfg))
    cfg, vals = _values(arch, 0.3 if rounding else 1.0, cfg=jcfg)
    if gemm == "pallas_paired":
        vals, rep = j_transform.pair_lm_params(vals, rounding, mode=mode, block_n=block_n)
        assert (rep.total_pairs > 0) == (rounding > 0)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[0, -1] = -1
    extras = _extras(cfg, shape[0])
    kw = dict(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4, gemm=gemm, pair_block_n=block_n)
    want_loss, want, want_grads = _jax(cfg, vals, JM.PerfKnobs(remat="none", **kw),
                                       tokens, labels, extras)
    got_loss, got, got_grads = _port(tcfg, vals, TM.PerfKnobs(**kw), tokens, labels, extras)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=LOSS_RTOL)
    tree = _port_grad_tree(tcfg, got_grads)
    n = _assert_grads(tree, want_grads, f"{arch} {gemm} {mode} r={rounding}")
    assert n == len(jax.tree_util.tree_leaves(tree))  # every weight's gradient checked
    return tcfg


@pytest.mark.parametrize("gemm,mode,block_n,rounding", POLICIES)
@pytest.mark.parametrize("arch,shape", [("mamba2-2.7b", (2, 7)), ("whisper-base", (2, 7)),
                                        ("internvl2-2b", (2, 12))])
def test_family_lm_loss_and_grads_match_jax(arch, shape, gemm, mode, block_n, rounding):
    """internvl2's 12 tokens run past its 8 patch positions."""
    _check_family(arch, gemm, mode, block_n, rounding, shape=shape)
