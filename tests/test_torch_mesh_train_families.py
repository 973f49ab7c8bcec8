"""The training mesh of the other five families against the JAX package's
training step: deepseek's MLA and shared experts, mamba2's SSM, hymba's
hybrid layers and meta tokens, whisper's encoder-decoder and internvl2's
vision prefix.

Gloo ranks on the CPU (``launch.mesh.spawn``), spawned once per mesh shape,
(1, 2), (1, 4) and (2, 2), for the whole module; every job of a shape runs
inside its ranks (``benchmarks.mesh_train.train_many``).  The batches carry
seeded random frames and patches (``launch.inputs.make_batch``'s stubs,
through ``benchmarks.mesh_train.smoke_batches``): zero patches would leave
``vision_proj``'s gradient zero whatever the code did.

* the smoke configs, fp32, r = 0, ``gemm="pallas_paired"`` (K1's plain
  version), one AdamW step (lr 1e-4, eps 1e-6, as in
  ``test_torch_mesh_train.py``) on a global batch of 4 × 16 tokens: every
  rank's loss, xent and aux, its gradients gathered whole, and its weights
  after the update against the JAX ``build_train_step`` on a one-device
  mesh (``jax.grad`` of ``lm_loss`` for the gradients, the JAX AdamW update
  of them for the weights: the step's body, held to the step itself for
  whisper), rtol 1e-4 / atol 1e-5.  hymba's 8 meta tokens make a stream of 24 positions: 12 or 6 a
  rank; internvl2's 8 patch positions are all rank 0's on (1, 2).
* hymba with SSM heads that do not divide ``model`` while its channels do
  (``ssm.expand`` 5, ``head_dim`` 32: 10 heads over 320 channels), on
  (1, 4): the channels split, the heads whole (the conv'd channels
  all-gathered, whose gradient is reduce-scattered; ``A_log``, ``D``,
  ``dt_bias`` and ``w_dt`` whole, their gradients summed over ``model``),
  as hymba-1.5b's 50 heads over 3200 channels resolve on four ranks.
* hymba at 15 tokens on (1, 2): 23 positions, which 2 ranks do not divide:
  the stream stays whole.  The stream is sized with its meta tokens: on 3
  ranks 16 tokens split (24 positions) and 15 do not.
* r = 0.05 on (1, 2) (structured, per-shard pairing, the matrices scaled by
  0.3 so pairs form): the step's loss and gradients equal the same mesh
  step's under ``gemm="xla"`` on the rank's folded weights.
* each rank's weight, gradient and moment shapes against its resolved
  spec; the segments' and the encoder's splits.
* the collectives a step (calls and bytes by kind) and K1 calls a step
  against ``analysis.mesh_train_collectives`` and ``train_launches``.
* whisper through the CLI: a run checkpointed at step 2 on 1 × 2 and
  resumed on 2 × 1 (the encoder's weights and moments in the checkpoint,
  whole) gives the straight run's losses.
* ``build_train_step`` takes every one of the five full configs on a mesh.
* the SSM scan's decay matrix keeps a finite gradient where its masked sums
  overflow fp32 (hymba-1.5b's at full width; the JAX package's gradient is
  NaN there), and a NaN fails the parity gates' ``violation``.
"""
import concurrent.futures
import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import layers as JL
from repro.models import lm as JM
from repro.parallel.rules import rules_for as j_rules_for
from repro.parallel.sharding import make_mesh_compat, set_mesh_compat
from repro.train import optimizer as j_opt
from repro_torch import analysis
from repro_torch.benchmarks.mesh_train import (
    PARITY_EPS,
    PARITY_LR,
    knobs_for,
    smoke_batches,
    train_many,
    violation,
)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh
from repro_torch.parallel.tp import train_layout_for
from repro_torch.train.optimizer import adamw
from test_torch_lm_train import _assert_grads, _jax, _port_grad_tree, _values

ARCHS = {"deepseek": "deepseek-v2-lite-16b", "mamba2": "mamba2-2.7b", "hymba": "hymba-1.5b",
         "whisper": "whisper-base", "internvl2": "internvl2-2b"}
HEADS_WHOLE = "hymba_heads_whole"  # on (1, 4) only
ODD = "hymba_odd"  # on (1, 2) only: 8 meta tokens + 15 tokens
MESHES = [(1, 2), (1, 4), (2, 2)]
R05_MESH = (1, 2)
B, S, ODD_S = 4, 16, 15
LR, EPS = PARITY_LR, PARITY_EPS
KNOBS = knobs_for(0.0)
JAX_KNOBS = JM.PerfKnobs(q_chunk=16, k_chunk=16)


def _variant(cfg):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, expand=5, head_dim=32))


def _arch(name):
    return ARCHS["hymba"] if name in (HEADS_WHOLE, ODD) else ARCHS[name]


def _cfgs(name):
    """(JAX config, port config), fp32."""
    jcfg = dataclasses.replace(jax_smoke_config(_arch(name)), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(_arch(name)), dtype="float32")
    return (_variant(jcfg), _variant(cfg)) if name == HEADS_WHOLE else (jcfg, cfg)


@functools.cache
def _vals(name, scale=1.0):
    return _values(_arch(name), scale, cfg=_cfgs(name)[0])[1]


@functools.cache
def _batches(name):
    return smoke_batches(_cfgs(name)[1], B, ODD_S if name == ODD else S, 1)


def _names(shape):
    return [*ARCHS, *([HEADS_WHOLE] if shape == (1, 4) else []),
            *([ODD] if shape == R05_MESH else [])]


def _mesh(shape):
    return Mesh(dict(zip(("data", "model"), shape, strict=True)))


def _jobs(shape):
    jobs = {}
    for name in _names(shape):
        jobs[name] = ("train_job", (_cfgs(name)[1], _vals(name), KNOBS, _batches(name)),
                      {"gather": True, "lr": LR, "eps": EPS})
    if shape == R05_MESH:
        for name in ARCHS:
            jobs[name + "_r05"] = ("train_job", (_cfgs(name)[1], _vals(name, 0.3),
                                                 knobs_for(0.05), _batches(name)),
                                   {"fold_oracle": True, "lr": LR, "eps": EPS})
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, per mesh shape: one spawn a shape, one after
    the other in a thread of their own, while this one computes the JAX
    references."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        runs = {shape: pool.submit(spawn, train_many, shape, backend="gloo", device="cpu",
                                   args=(_jobs(shape),), timeout=300)
                for shape in MESHES}
        for name in (*ARCHS, HEADS_WHOLE, ODD):
            _jax_ref(name)
        return {shape: run.result() for shape, run in runs.items()}


@functools.cache
def _jax_ref(name):
    """The JAX package's loss, metrics and gradients (``jax.grad`` of
    ``lm_loss``), and its weights after the JAX AdamW update of those
    gradients (the body of its ``build_train_step``, which
    :func:`test_jax_step_is_grad_then_update` holds to the step on a
    one-device mesh); the frames or patches beside the tokens.  One
    compile of the loss's gradient a config: the step's would be a second."""
    jcfg, vals = _cfgs(name)[0], _vals(name)
    tok, lab, *rest = _batches(name)[0]
    loss, metrics, grads = _jax(jcfg, vals, JAX_KNOBS, tok, lab, rest[0] if rest else {})
    opt = j_opt.adamw(LR, eps=EPS)
    params = jax.tree.map(jnp.asarray, vals)
    new, _ = jax.jit(opt.update)(grads, opt.init(params), params, jnp.int32(0))
    return {"loss": loss, **metrics}, grads, jax.tree.map(np.asarray, new)


def _cases():
    return [(shape, name) for shape in MESHES for name in _names(shape)]


@pytest.mark.parametrize("shape,name", _cases())
def test_step_equals_jax(ranks, shape, name):
    """Loss, xent and aux, every gradient gathered whole (``meta``,
    ``vision_proj`` and the encoder's among them), and every weight after
    the update, on every rank, against the JAX step."""
    want_m, want_g, want_p = _jax_ref(name)
    cfg = _cfgs(name)[1]
    for r in ranks[shape]:
        rec = r[name]
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(rec["metrics"][0][k], want_m[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{shape} {name} {k}")
        tree = _port_grad_tree(cfg, rec["grads"])
        n = _assert_grads(tree, want_g, f"{shape} {name}")
        assert n == len(jax.tree_util.tree_leaves(tree))  # every weight's gradient checked
        _assert_grads(_port_grad_tree(cfg, rec["params"]), want_p, f"{shape} {name} params")
    if name == "deepseek":
        assert ranks[shape][0][name]["metrics"][0]["aux"] > 0  # routed: the aux loss acts
    if name == "internvl2":  # the patches reach vision_proj's gradient
        assert np.abs(ranks[shape][0][name]["grads"]["vision_proj"]).max() > 0


#: the splits each config's segments resolve to on (1, 2) / (1, 4)
SPLITS = {
    "deepseek": lambda n: [{"q_split", "ff_split"},
                           {"q_split", "experts_split", "router_split", "shared_split"}],
    "mamba2": lambda n: [{"ssm_in_split", "ssm_heads_split"}],
    "hymba": lambda n: [{"q_split", "ff_split", "ssm_in_split", "ssm_heads_split"}
                        | ({"kv_split"} if n == 2 else set())] * 3,
    HEADS_WHOLE: lambda n: [{"q_split", "ff_split", "ssm_in_split"}] * 3,
    ODD: lambda n: [{"q_split", "kv_split", "ff_split", "ssm_in_split", "ssm_heads_split"}] * 3,
    "whisper": lambda n: [{"q_split", "kv_split", "xq_split", "xkv_split", "ff_split"}],
    "internvl2": lambda n: [{"q_split", "ff_split"} | ({"kv_split"} if n == 2 else set())],
}


@pytest.mark.parametrize("shape,name", _cases())
def test_layout_follows_the_train_specs(ranks, shape, name):
    """Each rank's weights, gradients and moments are its blocks of the
    whole shapes under its resolved spec; each segment splits what the
    ``train`` rules split; the stream splits where its ``meta_tokens + S``
    positions divide ``model``; the encoder's frames stay whole."""
    cfg, mesh = _cfgs(name)[1], _mesh(shape)
    whole = {n: tuple(p.shape) for n, p in TM.init_lm(cfg, 0, device="cpu").named_parameters()}
    for r in ranks[shape]:
        rec = r[name]
        assert rec["tp"]["seq_split"] == (name != ODD)
        assert rec["tp"]["batch_split"] == (shape[0] > 1)
        for n, s in rec["shapes"].items():
            want = tuple(d // (mesh.axis_size(e) if e else 1)
                         for d, e in zip(whole[n], s["spec"], strict=True))
            assert s["param"] == s["grad"] == want, (shape, n)
            assert s["moments"] == [want, want], (shape, n)
    rec = ranks[shape][0][name]
    segs = [{k for k, v in seg.items() if v} for seg in rec["tp_segments"]]
    assert segs == SPLITS[name](shape[1]), (shape, name)
    if name == "whisper":
        assert {k for k, v in rec["tp_encoder"].items() if v} == {"q_split", "kv_split",
                                                                 "ff_split"}
        assert rec["tp_encoder"]["seq_split"] is False
    if name == HEADS_WHOLE:  # the heads' weights whole: their gradients summed over model
        for leaf in ("A_log", "D", "dt_bias", "w_dt"):
            assert all(e is None for e in rec["shapes"][f"layers.0.mamba.{leaf}"]["spec"])


@pytest.mark.parametrize("shape,name", _cases())
def test_collectives_and_k1_calls_equal_the_analysis(ranks, shape, name):
    cfg = _cfgs(name)[1]
    seq = ODD_S if name == ODD else S
    want = analysis.mesh_train_collectives(cfg, KNOBS, _mesh(shape), B, seq)
    for r in ranks[shape]:
        rec = r[name]
        assert rec["collectives"][0] == want == rec["want_collectives"], (shape, name)
        assert rec["k1"] == [analysis.train_launches(cfg, KNOBS)], (shape, name)
    if name == HEADS_WHOLE:  # the conv'd channels gathered (twice: remat), once a layer
        plain = analysis.mesh_train_collectives(_cfgs("hymba")[1], KNOBS, _mesh(shape), B, S)
        assert want["all_gather"]["calls"] - plain["all_gather"]["calls"] == 2 * cfg.n_layers
        assert want["reduce_scatter"]["calls"] - plain["reduce_scatter"]["calls"] == cfg.n_layers


@pytest.mark.parametrize("name", list(ARCHS))
def test_r05_step_equals_its_fold_oracle(ranks, name):
    for r in ranks[R05_MESH]:
        rec = r[name + "_r05"]
        assert rec["pair_report"]["total_pairs"] > 0
        assert rec["oracle_loss_violation"] <= 0 and rec["oracle_grad_violation"] <= 0


@pytest.mark.parametrize("seq,split", [(16, True), (15, False)])
def test_stream_is_sized_with_its_meta_tokens(seq, split):
    """On 3 model ranks hymba's stream of 8 meta tokens + 16 splits (24
    positions) though 16 tokens do not divide 3, and 8 + 15 does not."""
    cfg, mesh = _cfgs("hymba")[1], _mesh((1, 3))
    tp = train_layout_for(cfg, mesh, rules_for(cfg, "train", mesh), B, seq)
    assert tp.seq_split == split


@pytest.mark.parametrize("name", list(ARCHS))
def test_full_configs_train_on_a_mesh(name):
    """``build_train_step`` wires each of the five families' full configs on
    a (2, 2) mesh (the fused attention stays refused:
    ``test_torch_mesh_train.py``; FSDP: ``test_torch_fsdp.py``)."""
    cfg = get_config(ARCHS[name])
    step = build_train_step(cfg, adamw(LR), KNOBS, _mesh((2, 2)))
    seq = 384 if cfg.vision_prefix else 128
    tp = step.layout(8, seq)
    assert tp.train and tp.seq_split and tp.batch_split
    assert (tp.encoder_splits is not None) == (cfg.encoder is not None)
    want = analysis.mesh_train_collectives(cfg, KNOBS, _mesh((2, 2)), 8, seq)
    assert want["reduce_scatter"]["calls"] > 0 and want["all_gather"]["calls"] > 0


def test_jax_step_is_grad_then_update():
    """The JAX ``build_train_step`` of whisper on a one-device mesh (its
    frames in the batch) gives the loss and the weights of
    :func:`_jax_ref`'s gradient and update."""
    want_m, _, want_p = _jax_ref("whisper")
    jcfg, vals = _cfgs("whisper")[0], _vals("whisper")
    tok, lab, extras = _batches("whisper")[0]
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    opt = j_opt.adamw(LR, eps=EPS)
    step = jax.jit(j_build_train_step(jcfg, opt, JAX_KNOBS, mesh,
                                      j_rules_for(jcfg, "train", mesh)))
    params = jax.tree.map(jnp.asarray, vals)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
             **{k: jnp.asarray(v) for k, v in extras.items()}}
    with set_mesh_compat(mesh):
        new, _, m = step(params, opt.init(params), jnp.int32(0), batch)
    assert float(m["loss"]) == pytest.approx(want_m["loss"], rel=1e-6)
    for got, want in zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(want_p),
                         strict=True):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-7)


def test_whisper_resumes_across_mesh_shapes(tmp_path):
    """whisper through the CLI on 1 × 2 checkpointing every 2 steps (whole
    arrays, the encoder's among them), its newest checkpoint removed,
    resumed on 2 × 1: steps 3–4 give the straight run's losses."""
    ckpt = tmp_path / "ckpt"
    kw = dict(arch="whisper-base", smoke=True, steps=4, batch=2, seq=16, lr=3e-3,
              gemm="pallas_paired", device="cpu", dtype="float32", log_every=0,
              ckpt_dir=str(ckpt), ckpt_every=2)
    straight = t_train.train(mesh="1x2", **kw)
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_0000000002", "step_0000000004"]
    paths = json.loads((ckpt / "step_0000000002" / "manifest.json").read_text())["paths"]
    assert any("encoder" in str(p) for p in paths)
    shutil.rmtree(ckpt / "step_0000000004")
    resumed = t_train.train(mesh="2x1", **kw)
    assert resumed["start"] == 2 and [r["start"] for r in resumed["ranks"]] == [2, 2]
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               [h["loss"] for h in straight["history"][2:]], rtol=1e-5)


@pytest.mark.parametrize("scale,jax_finite", [(0.01, True), (8.0, False)])
def test_segsum_decay_gradient_stays_finite(scale, jax_finite):
    """``layers._segsum_decay`` masks above the diagonal before the exp: its
    values are the JAX package's, and so is its gradient where that is
    finite; with sums of −dA past fp32's exp range above the diagonal (as
    hymba-1.5b's 50 heads make over a 256-position chunk) the JAX gradient
    is NaN and the port's finite."""
    rng = np.random.default_rng(0)
    dA = (-scale * rng.random((2, 3, 64))).astype(np.float32)
    w = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(JL._segsum_decay(jnp.asarray(dA)))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(JL._segsum_decay(a) * w))(jnp.asarray(dA)))
    t = torch.tensor(dA, requires_grad=True)
    got = TL._segsum_decay(t)
    (got * torch.tensor(w)).sum().backward()
    # the cumulative sums round apart (torch's and XLA's): 1e-4 of the largest
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(t.grad.numpy()).all()
    assert np.isfinite(want_g).all() == jax_finite
    if jax_finite:
        np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_g).max())


def test_violation_fails_on_nan():
    assert violation([1.0, np.nan], [1.0, 1.0]) == np.inf
    assert violation([1.0, 2.0], [1.0, np.nan]) == np.inf
    assert violation([1.0, 2.0], [1.0, 2.0]) < 0
