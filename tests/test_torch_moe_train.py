"""The port's MoE training path (olmoe-1b-7b, deepseek-v2-lite-16b) against
the JAX package's, in fp32.

Same numpy inputs through ``repro`` and ``repro_torch``: the JAX package's
seeded smoke init, its layer matrices (the experts' and shared experts',
MLA's, attention's) times 0.3 at r = 0.05 so that every pairing mode pairs
lanes, handed to the port by ``lm_params_from_numpy`` with the JAX
``pair_lm_params`` metadata; JAX on the CPU, its Pallas kernels in
interpret mode, the port's kernels as their plain versions.

* ``ops.fused_paired_expert_dense`` (one K1 launch over the expert grid, its
  backward autograd of the einsum on the folded experts) against the JAX
  ``fused_paired_expert_dense`` and its ``jax.vjp``: shared activations
  with silu on gate, per-expert ones on down; structured and blocked within
  each expert at bn ∈ {1, 3} (bn 3 leaves a short last block of down's 64
  columns); r ∈ {0, 0.05}: output within 1e-5 relative, ``dx`` and ``dw``
  within rtol 1e-4 / atol 1e-5;
* ``lm_loss`` and every weight's gradient under ``gemm="pallas_paired"``,
  structured and blocked at bn 16, r ∈ {0, 0.05}, against ``jax.grad`` of
  the JAX ``lm_loss`` under the same policy: olmoe here, deepseek (its dense
  first layer, MLA and the shared experts) in ``test_torch_mla_train.py``
  through :func:`_check_moe_lm`; on the routed branch (2 × 7 tokens: T·K =
  28 > 2E = 16) and the dense one (1 × 4 tokens): loss and the router's aux
  loss within 1e-5 relative, gradients within rtol 1e-4 / atol 1e-5;
* four AdamW steps of olmoe under ``pallas_paired`` at r = 0 against
  ``gemm="xla"``: every loss within 1e-5.

The K1 calls of a training step of both families against
``analysis.train_launches`` are in ``tests/test_torch_lm_train.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transform as j_transform
from repro.kernels import ops as j_ops
from repro.models import lm as JM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rel_err
from repro_torch.models import lm as TM
from test_torch_lm_train import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_RTOL,
    _assert_grads,
    _jax,
    _port,
    _port_grad_tree,
    _values,
)

CHUNK = 4
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]
BRANCHES = {"routed": (2, 7), "dense": (1, 4)}


def _tokens(vocab: int, shape: tuple[int, int], seed: int = 5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[0, 1] = -1  # a masked position
    return tokens, labels


# ---------------------------------------------------------------------------
# the expert-grid op
# ---------------------------------------------------------------------------


def _layer_experts(rounding: float, mode: str, block_n: int) -> dict:
    """Layer 0's expert weights of olmoe smoke (times 0.3) with the JAX
    package's pairing of them: ``{name: (w, meta)}``."""
    _, vals = _values("olmoe-1b-7b", scale=0.3)
    moe = {k: v for k, v in vals["segments"][0]["moe"].items()}
    fake = {"segments": [{"moe": moe}]}
    out, _ = j_transform.pair_params(fake, rounding, mode=mode, block_n=block_n,
                                     leaves=(("moe", "w_gate"), ("moe", "w_down")))
    moe = out["segments"][0]["moe"]
    return {name: (moe[name][0], {k: v[0] for k, v in moe[name + "_pairing"].items()})
            for name in ("w_gate", "w_down")}


@functools.cache
def _jax_expert_vjp(activation: str, per_expert: bool, block_n: int):
    def f(x, w, meta, dy):
        y, vjp = jax.vjp(lambda x, w: j_ops.fused_paired_expert_dense(
            x, w, meta, activation=activation, x_per_expert=per_expert, pair_block_n=block_n,
            interpret=True), x, w)
        return (y, *vjp(dy))

    return jax.jit(f)


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_fused_paired_expert_dense_matches_jax_vjp(mode, block_n, per_expert, rounding):
    """Shared rows through gate (silu in the epilogue), per-expert rows
    through down; the output and the gradients of x and w for one random
    cotangent, the metadata carried across from the JAX package."""
    name, act = ("w_down", "none") if per_expert else ("w_gate", "silu")
    w, meta = _layer_experts(rounding, mode, block_n)[name]
    assert (meta["pair_mask"].sum() > 0) == (rounding > 0)
    E, K, n_ff = w.shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=(E, 6, K) if per_expert else (6, K)).astype(np.float32)
    dy = rng.normal(size=(6, E, n_ff)).astype(np.float32)
    want_y, want_dx, want_dw = _jax_expert_vjp(act, per_expert, block_n)(
        jnp.asarray(x), jnp.asarray(w), jax.tree.map(jnp.asarray, meta), jnp.asarray(dy))
    tx = torch.as_tensor(x).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    tmeta = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in meta.items()}
    got = ops.fused_paired_expert_dense(tx, tw, tmeta, activation=act, x_per_expert=per_expert,
                                        pair_block_n=block_n)
    assert got.shape == (6, E, n_ff)
    assert rel_err(got.detach(), want_y) <= 1e-5
    got.backward(torch.as_tensor(dy))
    assert tw.grad.dtype == tw.dtype
    for g, want, what in ((tx.grad, want_dx, "dx"), (tw.grad, want_dw, "dw")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=what)
    # the forward is the frozen path's: expert_dense on the same segments
    seg = ops.lm_expert_segments(tw.detach(), tmeta, block_n)
    assert torch.equal(got.detach(), ops.expert_dense(tx.detach(), seg, activation=act,
                                                      x_per_expert=per_expert))


def test_fused_paired_expert_dense_refuses_blocked_meta_without_block_n():
    w, meta = _layer_experts(0.0, "column_blocked", 3)["w_gate"]
    tmeta = {k: torch.as_tensor(v) for k, v in meta.items()}
    with pytest.raises(ValueError, match="pair_block_n"):
        ops.fused_paired_expert_dense(torch.zeros(2, w.shape[1]), torch.as_tensor(w), tmeta)


def test_expert_grid_trains_from_the_live_weights():
    """Under grad the experts run from the live weights (a change of a
    weight shows in the next forward) and gather a gradient; a frozen
    serving copy of the same block keeps its segments and tracks none."""
    from repro_torch.core.transform import pair_lm_params

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype="float32")
    model, _ = pair_lm_params(TM.init_lm(cfg, 0, device="cpu"), 0.0)
    model.requires_grad_(True)
    tokens = torch.as_tensor(_tokens(cfg.vocab, (2, 7))[0], dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}
    knobs = TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, gemm="pallas_paired")
    loss, _ = TM.lm_loss(cfg, model, batch, knobs=knobs)
    loss.backward()
    w = model.layers[0].moe.w_up
    assert float(w.grad.abs().max()) > 0
    with torch.no_grad():
        w.mul_(0.5)
    assert float(TM.lm_loss(cfg, model, batch, knobs=knobs)[0]) != float(loss)
    frozen = model.copy(frozen=True)
    with torch.no_grad():
        logits, _ = TM.lm_forward(cfg, frozen, tokens, knobs=knobs)
    assert not logits.requires_grad
    assert any(k[0] == "paired" for k in frozen.layers[0].moe._derived)


# ---------------------------------------------------------------------------
# the whole model: lm_loss and every gradient against jax.grad
# ---------------------------------------------------------------------------


def _check_moe_lm(arch, mode, block_n, rounding, branch):
    """``lm_loss`` and every weight's gradient under ``gemm="pallas_paired"``,
    the experts on K1's expert grid, against ``jax.grad`` of the JAX
    ``lm_loss`` under the same policy (its Pallas kernels in interpret
    mode), on ``branch``'s tokens."""
    cfg, vals = _values(arch, scale=0.3 if rounding else 1.0)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    vals, rep = j_transform.pair_lm_params(vals, rounding, mode=mode, block_n=block_n)
    assert (rep.total_pairs > 0) == (rounding > 0)
    assert any(".moe.w_" in leaf.path for leaf in rep.leaves)  # the experts carry metadata
    shape = BRANCHES[branch]
    mo = cfg.moe
    assert (shape[0] * shape[1] * mo.top_k > 2 * mo.n_experts) == (branch == "routed")
    tokens, labels = _tokens(cfg.vocab, shape)
    kw = dict(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4, gemm="pallas_paired",
              pair_block_n=block_n)
    want_loss, want, want_grads = _jax(cfg, vals, JM.PerfKnobs(remat="none", **kw),
                                       tokens, labels)
    got_loss, got, got_grads = _port(tcfg, vals, TM.PerfKnobs(**kw), tokens, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL, atol=1e-7)
    assert (got["aux"] > 0) == (branch == "routed")
    tree = _port_grad_tree(tcfg, got_grads)
    n = _assert_grads(tree, want_grads, f"{arch} {mode} r={rounding} {branch}")
    assert n == len(jax.tree_util.tree_leaves(tree))  # every weight's gradient checked
    moe = tree["segments"][-1]["moe"]
    for name in ("w_gate", "w_up", "w_down"):  # the expert grid's gradients carry signal
        assert np.abs(moe[name]).max() > 1e-6, name
    if tcfg.moe.n_shared:
        assert np.abs(moe["shared"]["w_gate"]).max() > 1e-6


MODEL_CASES = [(mode, block_n, rounding, branch)
               for mode, block_n in (("structured", 0), ("column_blocked", 16))
               for rounding in (0.0, 0.05) for branch in BRANCHES]


@pytest.mark.parametrize("mode,block_n,rounding,branch", MODEL_CASES)
def test_olmoe_lm_loss_and_grads_match_jax(mode, block_n, rounding, branch):
    _check_moe_lm("olmoe-1b-7b", mode, block_n, rounding, branch)


def test_four_adamw_steps_paired_equal_xla():
    """Four AdamW steps of olmoe smoke from one init under
    ``gemm="pallas_paired"`` at r = 0 (the experts on the expert grid) and
    under ``gemm="xla"``: every loss within 1e-5 relative."""
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.data.tokens import token_batches
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train.optimizer import adamw, cosine_schedule

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype="float32")

    def run(gemm: str) -> list[float]:
        model = TM.init_lm(cfg, 0, device="cpu")
        if gemm == "pallas_paired":
            model, _ = pair_lm_params(model, 0.0)
        step = build_train_step(cfg, adamw(cosine_schedule(3e-3, 4)),
                                TM.PerfKnobs(q_chunk=8, k_chunk=8, gemm=gemm))
        opt_state = step.init(model)
        data = token_batches(2, 16, cfg.vocab, seed=1)
        losses = []
        for i in range(4):
            tok, lab = next(data)
            batch = {"tokens": torch.as_tensor(tok).long(), "labels": torch.as_tensor(lab).long()}
            losses.append(float(step(model, opt_state, i, batch)["loss"]))
        return losses

    xla, paired = run("xla"), run("pallas_paired")
    np.testing.assert_allclose(paired, xla, rtol=LOSS_RTOL)
