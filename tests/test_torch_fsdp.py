"""FSDP on the port's mesh: mistral-large-123b's ``embed``-over-``data``
split, trained and served, against the JAX package.

mistral-large-123b's smoke config (2 layers, d 96, 6 heads, 2 KV heads,
fp32) under its *published* config's rules (``rules_for(get_config(…),
mode, mesh)``: the smoke config is under ``FSDP_PARAM_THRESHOLD``), on gloo
ranks on the CPU (``launch.mesh.spawn``), one spawn of (2, 1) and one of
(2, 2) for the whole module, every job inside the ranks
(``benchmarks.mesh_train.train_many``), each rank building only its own
blocks from the JAX value tree (``launch.steps.local_model``):

* the specs of every weight and cache entry, the shard plan and the
  shard-aware pairing ledgers (structured, per column, column-blocked at
  r = 0.05) against the JAX package's, exactly;
* one AdamW step (lr 1e-4, eps 1e-6, r = 0, ``gemm="pallas_paired"``, K1's
  plain version) on a global batch of 4 × 16 tokens: every rank's loss,
  its gradients gathered whole and its weights after the update against
  ``jax.grad`` of the JAX ``lm_loss`` and the JAX AdamW update of it, rtol
  1e-4 / atol 1e-5; clipping at 1e-3 by the whole model's norm (the
  single-device step's norm and update);
* r = 0.05 on (2, 2), structured and column-blocked: the step's loss and
  gradients equal the same mesh step's under ``gemm="xla"`` on the rank's
  weights folded through its own pairing metadata (the forward reads the
  data-gathered metadata: a wrong concatenation would differ);
* each rank's weight, gradient and moment shapes against its resolved spec;
* the collectives a step, calls and bytes by kind, against
  ``analysis.mesh_train_collectives``, and those of a decode step and a
  prefill against ``mesh_decode_collectives`` / ``mesh_prefill_collectives``;
* served on (2, 2), fp32, r = 0: every rank's tokens equal the JAX engine's
  and the single-rank port engine's, the logits within 1e-5 of the
  largest; at r = 0.05 against the folded-dense oracle;
* a checkpoint written on (2, 2) by the train CLI (its smoke config sharded
  by the published config's rules, ``parallel.rules.arch_rules``), resumed
  on (2, 1): the straight run's losses, rtol 1e-5; ``arch_rules`` of every
  arch is its published config's table, a cut config's own but for
  mistral-large-123b's ``embed``;
* the full config builds on (2, 1) and (2, 2) in all three modes, and a
  batch the data axis does not split is refused by name.
"""
import concurrent.futures
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.transform import pair_params as jax_pair_params
from repro.core.transform import tp_shard_plan as jax_tp_shard_plan
from repro.models import lm as JM
from repro.parallel import rules as jax_rules
from repro.parallel import sharding as jsh
from repro.serving.engine import ServeEngine as JaxEngine
from repro.train import optimizer as j_opt
from repro_torch import analysis
from repro_torch.benchmarks import mesh_decode as md
from repro_torch.benchmarks.mesh_train import (
    PARITY_EPS,
    PARITY_LR,
    knobs_for,
    smoke_batches,
    train_many,
    violation,
)
from repro_torch.configs import ALL_ARCHS, cut_layers, get_config, get_smoke_config
from repro_torch.core.transform import pair_params, tp_shard_plan
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as TM
from repro_torch.models.param import cache_axes_and_shapes, param_axes_and_shapes
from repro_torch.parallel.rules import arch_rules, rules_for
from repro_torch.parallel.sharding import Mesh, shardings_for
from repro_torch.parallel.tp import layout_for, train_layout_for
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.optimizer import adamw
from test_torch_lm_train import _assert_grads, _jax, _port_grad_tree, _values

ARCH = "mistral-large-123b"
MESHES = [(2, 1), (2, 2)]
SERVE_MESH = (2, 2)
B, S = 4, 16
LR, EPS = PARITY_LR, PARITY_EPS
CLIP = 1e-3
KNOBS = knobs_for(0.0)
JAX_KNOBS = JM.PerfKnobs(q_chunk=16, k_chunk=16)
MAX_SEQ, STEPS, SLOTS = 24, 5, 4
PROMPTS = {i: np.random.default_rng(3).integers(1, 256, size=n).astype(np.int32)
           for i, n in enumerate((7, 12))}
MODES = ("train", "prefill", "decode")


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _shape(shape):
    return dict(zip(("data", "model"), shape, strict=True))


def _mesh(shape):
    return Mesh(_shape(shape))


def _rules(shape, mode="train"):
    """The published config's rules: ``embed`` over ``data``."""
    return rules_for(get_config(ARCH), mode, _mesh(shape))


def _cfgs():
    return (dataclasses.replace(jax_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32"))


@functools.cache
def _vals(scale=1.0):
    return _values(ARCH, scale, cfg=_cfgs()[0])[1]


def _one_layer_bf16():
    return cut_layers(get_smoke_config(ARCH), 1)


@functools.cache
def _batches():
    return smoke_batches(_cfgs()[1], B, S, 1)


def _jobs(shape):
    cfg = _cfgs()[1]
    kw = {"lr": LR, "eps": EPS, "rules": _rules(shape)}
    jobs = {"step": ("train_job", (cfg, _vals(), KNOBS, _batches()), {"gather": True, **kw}),
            "clip": ("train_job", (cfg, _vals(), KNOBS, _batches()),
                     {"gather": True, "grad_clip": CLIP, **kw})}
    if shape == SERVE_MESH:
        # one layer in bf16, the configuration the card trains: a stack of one
        # layer still moves its norms in fp32
        jobs["bf16_one_layer"] = ("train_job", (_one_layer_bf16(), 0, knobs_for(0.05),
                                                smoke_batches(_one_layer_bf16(), B, S, 2)), kw)
        for name, knobs in (("r05", knobs_for(0.05)), ("r05_blocked", knobs_for(
                0.05, pair_block_n=16))):
            jobs[name] = ("train_job", (cfg, _vals(0.3), knobs, _batches()),
                          {"fold_oracle": True, **kw})
        serve = {"max_seq": MAX_SEQ, "batch_size": SLOTS, "rules": _rules(shape, "decode")}
        jobs["serve"] = ("serve_rank", (cfg, _vals(), md.knobs_for(0.0), PROMPTS, STEPS),
                         {"cycle": True, **serve})
        jobs["serve_r05"] = ("serve_rank", (cfg, _vals(0.3), md.knobs_for(0.05), PROMPTS, STEPS),
                             {"fold": True, **serve})
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
        _jax_ref()
        _jax_served()
        return {shape: run.result() for shape, run in runs.items()}


@functools.cache
def _jax_ref():
    """``jax.grad`` of the JAX ``lm_loss`` and the JAX AdamW update of it."""
    jcfg, vals = _cfgs()[0], _vals()
    tok, lab = _batches()[0]
    loss, metrics, grads = _jax(jcfg, vals, JAX_KNOBS, tok, lab)
    opt = j_opt.adamw(LR, eps=EPS)
    params = jax.tree.map(jnp.asarray, vals)
    new, _ = jax.jit(opt.update)(grads, opt.init(params), params, jnp.int32(0))
    return {"loss": loss, **metrics}, grads, jax.tree.map(np.asarray, new)


@functools.cache
def _jax_served():
    """The JAX single-host engine through the ranks' sequence: generate, one
    more step, a prefill into a free slot and its release, then slot 0
    released, refilled with half its prompt, and one step."""
    eng = JaxEngine(_cfgs()[0], _vals(), max_seq=MAX_SEQ, batch_size=SLOTS,
                    knobs=JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none"))
    out = eng.generate(dict(PROMPTS), STEPS)
    logits = eng.last_logits
    eng.step()
    eng.add_request(2, PROMPTS[0])
    eng.release_slot(2)
    eng.release_slot(0)
    cycle = [eng.add_request(0, PROMPTS[0][:len(PROMPTS[0]) // 2]), eng.step().tolist()]
    return out, logits, cycle


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# -- specs, shard plans, pairing ledgers against the JAX package ----------------


def _smoke_trees():
    jcfg, cfg = _cfgs()
    axes, shapes = param_axes_and_shapes(cfg)
    c_axes, c_shapes = cache_axes_and_shapes(cfg, SLOTS, MAX_SEQ)
    return jcfg, cfg, axes, shapes, c_axes, c_shapes


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", MESHES)
def test_specs_and_shard_plan_equal_jax(shape, mode):
    """Every weight's and cache entry's spec at the smoke shapes under the
    published rules (``embed`` over ``data``: norms, embedding, head, every
    matrix's d_model dim), and the shard plan (``data`` the rows of wq, wk,
    wv, w_gate, w_up; the columns of wo, w_down), equal the JAX package's;
    the layout gathers exactly the leaves whose spec holds ``data``."""
    jcfg, cfg, axes, shapes, c_axes, c_shapes = _smoke_trees()
    jm, pm = _FakeMesh(_shape(shape)), _mesh(shape)
    jr = jax_rules.rules_for(jax_config(ARCH), mode, jm)
    pr = _rules(shape, mode)
    assert dict(pr.table) == dict(jr.table) and pr.mesh_axes("embed") == "data"
    entries = lambda s: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)
    for a_tree, s_tree in ((axes, shapes), (c_axes, c_shapes)):
        want = jax.tree.map(lambda a, s: entries(jsh.spec_for_axes(
            a, mesh=jm, rules=jr, dim_sizes=s.shape)), a_tree, s_tree,
            is_leaf=lambda a: isinstance(a, tuple))
        got = jax.tree.map(tuple, shardings_for(a_tree, pm, pr, s_tree),
                           is_leaf=lambda a: isinstance(a, tuple))
        assert got == want
    plan = tp_shard_plan(axes, shapes, pm, pr, leaves=cfg.paired_leaves)
    vals = _vals()
    assert plan == jax_tp_shard_plan(axes, vals, jm, jr, leaves=jcfg.paired_leaves)
    assert plan[("attn", "wq")][0] == 2 and plan[("mlp", "w_down")][1] == 2
    specs = shardings_for(axes, pm, pr, shapes)
    tp = (train_layout_for(cfg, pm, pr, B, S) if mode == "train"
          else layout_for(cfg, pm, pr, SLOTS, MAX_SEQ))
    want = {f"{blk}.{name}": [d - 1 for d, e in enumerate(spec) if e == "data"][0]
            for blk, leaves in specs["segments"][0].items() for name, spec in leaves.items()
            if "data" in spec}
    assert dict(tp.layer(0).gathers) == want and tp.fsdp_axes == ("data",)
    assert {n for n, _ in tp.top_gathers} == {"embed", "lm_head", "final_norm.scale"}


@pytest.mark.parametrize("mode,bn", [("structured", 0), ("per_column", 0),
                                     ("column_blocked", 16)])
@pytest.mark.parametrize("shape", MESHES)
def test_pairing_ledgers_equal_jax(shape, mode, bn):
    """``pair_params(shards=…)`` at the FSDP plan: each leaf's pairs, its
    row and column shards and its per-shard ledger equal the JAX package's."""
    jcfg, cfg, axes, shapes, *_ = _smoke_trees()
    jm = _FakeMesh(_shape(shape))
    vals = {k: v for k, v in _vals(0.3).items()}
    plan = jax_tp_shard_plan(axes, vals, jm, jax_rules.rules_for(jax_config(ARCH), "train", jm),
                             leaves=jcfg.paired_leaves)
    _, want = jax_pair_params(vals, 0.05, mode=mode, block_n=bn, leaves=jcfg.paired_leaves,
                              shards=plan)
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    _, got = pair_params(model, 0.05, mode=mode, block_n=bn, leaves=cfg.paired_leaves,
                         shards=plan)
    row = lambda rep: [(lr.path, lr.n_pairs, lr.row_shards, lr.col_shards, lr.shard_pairs)
                       for lr in rep.leaves]
    assert row(got) == row(want)
    assert got.total_pairs > 0


# -- training ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_step_equals_jax(ranks, shape):
    """Loss, xent and aux, every gradient gathered whole, and every weight
    after the update, on every rank, against the JAX step."""
    want_m, want_g, want_p = _jax_ref()
    cfg = _cfgs()[1]
    for r in ranks[shape]:
        rec = r["step"]
        assert rec["fsdp_axes"] == ("data",)
        for k in ("loss", "xent", "aux"):
            assert violation(rec["metrics"][0][k], want_m[k]) <= 0, (shape, k)
        tree = _port_grad_tree(cfg, rec["grads"])
        assert _assert_grads(tree, want_g, f"{shape}") == len(jax.tree_util.tree_leaves(tree))
        _assert_grads(_port_grad_tree(cfg, rec["params"]), want_p, f"{shape} params")


@functools.cache
def _single_clip():
    cfg = _cfgs()[1]
    model = TM.lm_params_from_numpy(_vals(), cfg, device="cpu")
    step = build_train_step(cfg, adamw(LR, eps=EPS, grad_clip=CLIP), KNOBS)
    opt = step.init(model)
    tok, lab = _batches()[0]
    step(model, opt, 0, {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)})
    return float(opt.last_norm), {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("shape", MESHES)
def test_clipping_uses_the_whole_models_norm(ranks, shape):
    """Each tensor's squares summed over the axes that split it (data,
    model, both): the clip norm and the clipped update are the single
    device's."""
    norm, want_p = _single_clip()
    assert norm > 10 * CLIP
    for r in ranks[shape]:
        rec = r["clip"]
        assert rec["clip_norm"] == pytest.approx(norm, rel=1e-5)
        assert max(violation(rec["params"][n], want_p[n]) for n in want_p) <= 0


@pytest.mark.parametrize("job", ["r05", "r05_blocked"])
def test_r05_step_equals_its_fold_oracle(ranks, job):
    for r in ranks[SERVE_MESH]:
        rec = r[job]
        assert rec["pair_report"]["total_pairs"] > 0
        assert rec["oracle_loss_violation"] <= 0 and rec["oracle_grad_violation"] <= 0


@pytest.mark.parametrize("shape", MESHES)
def test_layout_follows_the_train_specs(ranks, shape):
    """Each rank's weights, gradients and moments are its (data × model)
    blocks of the whole shapes under its resolved spec."""
    mesh = _mesh(shape)
    whole = {n: tuple(p.shape) for n, p in
             TM.init_lm(_cfgs()[1], 0, device="cpu").named_parameters()}
    for r in ranks[shape]:
        rec = r["step"]
        assert rec["tp"]["batch_split"]
        for n, s in rec["shapes"].items():
            assert "data" in s["spec"], n  # every mistral weight has a d_model dim
            want = tuple(d // (mesh.axis_size(e) if e else 1)
                         for d, e in zip(whole[n], s["spec"], strict=True))
            assert s["param"] == s["grad"] == want, (shape, n)
            assert s["moments"] == [want, want], (shape, n)


@pytest.mark.parametrize("shape", MESHES)
def test_train_collectives_equal_the_analysis(ranks, shape):
    """A layer's gather forward and again in its recompute, its
    reduce-scatter backward; the embedding's and the head's; the sums after
    the backward and the clip's, calls and bytes."""
    cfg = _cfgs()[1]
    want = analysis.mesh_train_collectives(cfg, KNOBS, _mesh(shape), B, S,
                                           rules=_rules(shape))
    for r in ranks[shape]:
        rec = r["step"]
        assert rec["collectives"][0] == want == rec["want_collectives"], shape
        assert rec["k1"] == [analysis.train_launches(cfg, KNOBS)]
    plain = analysis.mesh_train_collectives(cfg, KNOBS, _mesh(shape), B, S)
    # per layer: 2 gathers (forward, recompute) and 1 reduce-scatter; embed, head: 1 and 1
    assert want["all_gather"]["calls"] - plain["all_gather"]["calls"] == 2 * cfg.n_layers + 2
    assert want["reduce_scatter"]["calls"] - plain["reduce_scatter"]["calls"] == cfg.n_layers + 2


def test_one_layer_bf16_steps_and_collectives(ranks):
    """mistral at 1 layer in bf16 (fp32 masters, r = 0.05) on (2, 2): finite
    losses the same on every rank, two steps, and the collectives of each
    (the layer's matrices gathered in bf16, its norms in fp32)."""
    cfg = _one_layer_bf16()
    assert cfg.dtype == "bfloat16" and cfg.n_layers == 1
    want = analysis.mesh_train_collectives(cfg, knobs_for(0.05), _mesh(SERVE_MESH), B, S,
                                           rules=_rules(SERVE_MESH))
    losses = [[m["loss"] for m in r["bf16_one_layer"]["metrics"]] for r in ranks[SERVE_MESH]]
    assert all(np.isfinite(x).all() and x == losses[0] for x in losses)
    for r in ranks[SERVE_MESH]:
        assert r["bf16_one_layer"]["collectives"] == [want, want]


# -- serving ----------------------------------------------------------------------


@functools.cache
def _single_served():
    cfg = _cfgs()[1]
    eng = ServeEngine(cfg, TM.lm_params_from_numpy(_vals(), cfg, device="cpu"),
                      max_seq=MAX_SEQ, batch_size=SLOTS, knobs=md.knobs_for(0.0))
    return md.generate(eng, PROMPTS, STEPS), eng.last_logits


def test_served_tokens_equal_jax_and_the_single_rank(ranks):
    out, logits, cycle = _jax_served()
    single, single_logits = _single_served()
    assert single == out
    for r in ranks[SERVE_MESH]:
        rec = r["serve"]
        assert rec["tokens"] == out == single, rec["rank"]
        assert _rel(rec["logits"], logits) <= md.PARITY_TOL
        assert _rel(rec["logits"], single_logits) <= md.PARITY_TOL
        assert rec["cycle"] == cycle
        assert rec["fsdp_axes"] == ("data",) and rec["tp"]["batch_split"]


def test_served_collectives_equal_the_analysis(ranks):
    cfg, mesh = _cfgs()[1], _mesh(SERVE_MESH)
    kw = {"batch_size": SLOTS, "max_seq": MAX_SEQ}
    dec = analysis.mesh_decode_collectives(cfg, md.knobs_for(0.0), mesh,
                                           rules=_rules(SERVE_MESH, "decode"), **kw)
    pre = analysis.mesh_prefill_collectives(cfg, md.knobs_for(0.0), mesh,
                                            rules=_rules(SERVE_MESH, "prefill"), **kw)
    calls = lambda c: {k: v["calls"] for k, v in c.items()}
    for r in ranks[SERVE_MESH]:
        rec = r["serve"]
        assert calls(rec["step_collectives"]) == dec
        assert calls(rec["prefill_collectives"]) == pre
    plain = analysis.mesh_decode_collectives(cfg, md.knobs_for(0.0), mesh, **kw)
    assert dec["all_gather"] - plain["all_gather"] == cfg.n_layers + 2


def test_served_r05_equals_the_folded_dense_oracle(ranks):
    """At r = 0.05 each layer runs on its data-gathered metadata; the
    oracle folds each rank's block through its own."""
    cfg = _cfgs()[1]
    model = TM.lm_params_from_numpy(_vals(0.3), cfg, device="cpu")
    oracle = md.assemble_folded(cfg, model, [r["serve_r05"]["folded"] for r in
                                             ranks[SERVE_MESH]])
    eng = ServeEngine(cfg, oracle, max_seq=MAX_SEQ, batch_size=SLOTS,
                      knobs=TM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none"))
    out = md.generate(eng, PROMPTS, STEPS)
    for r in ranks[SERVE_MESH]:
        rec = r["serve_r05"]
        assert rec["tokens"] == out
        assert _rel(rec["logits"], eng.last_logits) <= md.PARITY_TOL
        assert sum(lr["n_pairs"] for lr in rec["pair_report"]) > 0


# -- the CLI, the full config, the refusals ---------------------------------------


def test_cli_resumes_from_2x2_on_2x1(tmp_path):
    """A run on 2 × 2 (FSDP: the CLI shards the smoke config by the published
    config's rules) checkpointing every 2 steps
    (whole arrays, gathered over both axes), its newest checkpoint removed,
    resumed on 2 × 1 (FSDP again, another model split): steps 3–4 give the
    straight run's losses."""
    ckpt = tmp_path / "ckpt"
    kw = dict(arch=ARCH, smoke=True, steps=4, batch=2, seq=16, lr=3e-3, gemm="pallas_paired",
              device="cpu", dtype="float32", log_every=0, ckpt_dir=str(ckpt), ckpt_every=2)
    straight = t_train.train(mesh="2x2", **kw)
    assert straight["collectives"][0]["reduce_scatter"]["calls"] > 0
    shutil.rmtree(ckpt / "step_0000000004")
    resumed = t_train.train(mesh="2x1", **kw)
    assert resumed["start"] == 2
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               [h["loss"] for h in straight["history"][2:]], rtol=1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_rules_are_the_published_configs(arch, mode):
    """What the CLIs shard a cut config by: its published config's rules,
    which differ from the smoke config's own only in mistral-large-123b's
    ``embed`` over ``data``."""
    mesh = _mesh((2, 2))
    got = arch_rules(arch, mode, mesh).table
    assert got == rules_for(get_config(arch), mode, mesh).table
    own = dict(rules_for(get_smoke_config(arch), mode, mesh).table)
    assert {k: v for k, v in got.items() if got.get(k) != own.get(k)} == (
        {"embed": "data"} if arch == ARCH else {})


@pytest.mark.parametrize("shape", MESHES)
def test_full_config_builds_in_every_mode(shape):
    """mistral-large-123b itself: the training step builds and every mode's
    layout gathers each of its 88 layers over ``data``."""
    cfg, mesh = get_config(ARCH), _mesh(shape)
    step = build_train_step(cfg, adamw(LR), KNOBS, mesh)
    tp = step.layout(8, 128)
    assert tp.fsdp_axes == ("data",) and tp.batch_split and tp.train
    assert all(tp.layer(i).gathers for i in range(cfg.n_layers))
    for mode in ("prefill", "decode"):
        assert layout_for(cfg, mesh, rules_for(cfg, mode, mesh), 8, 256).fsdp_axes == ("data",)


def test_refuses_a_batch_the_data_axis_does_not_split():
    """FSDP weights over ``data`` with a batch that does not split over it
    (the gather's reduce-scatter would count each data rank's copy of the
    batch) raise ``NotImplementedError`` naming the split (the leaves the
    forward does not gather: ``test_torch_fsdp_families.py``)."""
    with pytest.raises(NotImplementedError, match="batch of 3 rows"):
        train_layout_for(_cfgs()[1], _mesh((2, 2)), _rules((2, 2)), 3, S)
