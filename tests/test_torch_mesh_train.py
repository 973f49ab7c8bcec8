"""The port's training mesh against the JAX package's training step.

Gloo ranks on the CPU (``launch.mesh.spawn``: one process a rank), spawned
once per mesh shape, (1, 2), (2, 1), (2, 2) and (1, 4), for the whole
module; every job of a shape runs inside its ranks
(``benchmarks.mesh_train.train_many``) and comes back through the spawn.

* qwen2 and olmoe smoke, fp32, r = 0, ``gemm="pallas_paired"`` (K1's plain
  version), one AdamW step on a global batch of 4 × 16 tokens: every rank's
  loss, xent and aux, its gradients gathered whole, and its weights after
  the update against the JAX ``build_train_step`` on a one-device mesh
  (``jax.grad`` of ``lm_loss`` for the gradients; the JAX step under
  ``gemm="xla"``, which at r = 0 computes what the paired kernel does),
  rtol 1e-4 / atol 1e-5.  The step is AdamW at lr 1e-4 and eps 1e-6 (in
  both packages): its first step moves a weight by lr·g/(|g| + eps), which
  magnifies a gradient's summation-order noise by up to lr/(4·eps) where
  |g| is near eps; at the default eps 1e-8 and lr 1e-3 that is 2.5e4, and
  1e-9 of noise moved olmoe's expert weights by 2.5e-5; here it is 25.
  qwen2's 2 KV heads stay whole on (1, 4) (their gradients summed over
  ``model``); olmoe's aux on (2, 1) and (2, 2) is the global batch's.
* the same at a sequence that does not divide ``model`` (15 on (1, 2)):
  the residual stream stays whole, against the single-device step; and on
  (1, 3), which divides 15 positions and none of the weights: every weight
  whole, the stream split, the head whole.
* r = 0.05 on the meshes with a model axis to pair shards over
  (structured, per-shard pairing, the matrices scaled by 0.3 so pairs
  form): the step's loss and gradients equal the same mesh step's
  under ``gemm="xla"`` on the rank's folded weights, gradients carried back
  through the fold.
* clipping at 1e-3 on the meshes with a model axis: the optimizer's norm
  equals the single-device norm, the clipped update the single-device one.
* each rank's weight, gradient and moment shapes against its resolved
  spec, ``seq`` split exactly where ``spec_for_axes`` splits it.
* the collectives a step (calls and bytes by kind) and K1 calls a step
  against ``analysis.mesh_train_collectives`` and ``train_launches``.
* a bf16 row-parallel partial sum under autograd is stored in fp32: on
  (1, 2) its closed output is the serving path's, bit for bit; and
  ``dense(…, out_dtype=float32)`` on the live weights returns K1's fp32
  store.
* the CLI: ``--mesh 1x2`` gives the losses of the run without it (bf16
  smoke config: within 2e-3); a run checkpointed at step 2 on 1 × 2 and
  resumed on 2 × 1 gives the straight run's losses (fp32, rtol 1e-5).
* the fused attention is refused; FSDP builds (the other five families
  train on the mesh: ``test_torch_mesh_train_families.py``; FSDP's parity:
  ``test_torch_fsdp.py``).
"""
import concurrent.futures
import dataclasses
import functools
import math
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import build_train_step as j_build_train_step
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
from repro_torch.core.transform import pair_lm_params
from repro_torch.kernels import ops
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh, spec_for_axes
from repro_torch.train.optimizer import adamw
from test_torch_lm_train import _assert_grads, _jax, _port_grad_tree, _values

ARCHS = {"qwen2": "qwen2-1.5b", "olmoe": "olmoe-1b-7b"}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
B, S = 4, 16
ODD_S = 15  # does not divide 2 or 4 ranks: the residual stream stays whole
ODD_MESHES = [(1, 2)]
# 3 model ranks divide none of the smoke configs' heads, hidden columns,
# experts or vocab, and do divide 15 positions: every weight whole, the
# residual stream split
WHOLE_MESH = (1, 3)
R05_MESHES = [(1, 2), (2, 2), (1, 4)]  # a model axis to pair shards over
CLIP_MESHES = R05_MESHES  # a model axis to sum the split weights' squares over
LR, EPS = PARITY_LR, PARITY_EPS
CLIP = 1e-3  # small enough that clipping acts
KNOBS = knobs_for(0.0)
JAX_KNOBS = JM.PerfKnobs(q_chunk=16, k_chunk=16)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


@functools.cache
def _batches(arch, seq=S):
    return smoke_batches(_cfg(arch), B, seq, 1)


def _mesh(shape):
    return Mesh(dict(zip(("data", "model"), shape, strict=True)))


def _jobs(shape):
    if shape == WHOLE_MESH:
        return {key + "_whole": ("train_job", (_cfg(arch), _values(arch)[1], KNOBS,
                                               _batches(arch, ODD_S)),
                                 {"gather": True, "lr": LR, "eps": EPS})
                for key, arch in ARCHS.items()}
    jobs = {}
    for key, arch in ARCHS.items():
        cfg, vals = _cfg(arch), _values(arch)[1]
        jobs[key] = ("train_job", (cfg, vals, KNOBS, _batches(arch)),
                     {"gather": True, "lr": LR, "eps": EPS})
        if shape in R05_MESHES:
            jobs[key + "_r05"] = ("train_job", (cfg, _values(arch, scale=0.3)[1],
                                                knobs_for(0.05), _batches(arch)),
                                  {"fold_oracle": True, "lr": LR, "eps": EPS})
        if shape in ODD_MESHES:  # a sequence the model axis does not divide
            jobs[key + "_odd"] = ("train_job", (cfg, vals, KNOBS, _batches(arch, ODD_S)),
                                  {"gather": True, "lr": LR, "eps": EPS})
    if shape in CLIP_MESHES:
        jobs["qwen2_clip"] = ("train_job", (_cfg("qwen2-1.5b"), _values("qwen2-1.5b")[1], KNOBS,
                                            _batches("qwen2-1.5b")),
                              {"gather": True, "lr": LR, "eps": EPS, "grad_clip": CLIP})
    if shape == (1, 2):
        jobs["bf16"] = ("partial_sum_check", (_cfg("qwen2-1.5b", "bfloat16"), 0, B, S), {})
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, per mesh shape: one spawn a shape, one after
    the other in a thread of their own, while this one computes the JAX
    references."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        runs = {shape: pool.submit(spawn, train_many, shape, backend="gloo", device="cpu",
                                   args=(_jobs(shape),), timeout=300)
                for shape in [*MESHES, WHOLE_MESH]}
        for arch in ARCHS.values():
            _jax_ref(arch)
        return {shape: run.result() for shape, run in runs.items()}


@functools.cache
def _jax_ref(arch):
    """The JAX package's loss, metrics and gradients (``jax.grad`` of
    ``lm_loss``), and its weights after one ``build_train_step`` on a
    one-device mesh."""
    jcfg, vals = _values(arch)
    tok, lab = _batches(arch)[0]
    loss, metrics, grads = _jax(jcfg, vals, JAX_KNOBS, tok, lab)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    opt = j_opt.adamw(LR, eps=EPS)
    step = jax.jit(j_build_train_step(jcfg, opt, JAX_KNOBS, mesh, j_rules_for(jcfg, "train",
                                                                               mesh)))
    params = jax.tree.map(jnp.asarray, vals)
    with set_mesh_compat(mesh):
        new, _, m = step(params, opt.init(params), jnp.int32(0),
                         {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-6)
    return {"loss": loss, **metrics}, grads, jax.tree.map(np.asarray, new)


@functools.cache
def _single(arch, seq=S, clip=1.0):
    """The port's single-device step: metrics, its clip norm, the weights
    after it (by name)."""
    cfg = _cfg(arch)
    model = TM.lm_params_from_numpy(_values(arch)[1], cfg, device="cpu")
    step = build_train_step(cfg, adamw(LR, eps=EPS, grad_clip=clip), KNOBS)
    opt = step.init(model)
    tok, lab = _batches(arch, seq)[0]
    m = step(model, opt, 0, {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)})
    return ({k: float(v) for k, v in m.items()}, float(opt.last_norm),
            {n: p.detach().numpy().copy() for n, p in model.named_parameters()})


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", MESHES)
def test_step_equals_jax(ranks, shape, arch):
    """Loss, xent and aux, every gradient gathered whole, and every weight
    after the update, on every rank, against the JAX step."""
    want_m, want_g, want_p = _jax_ref(ARCHS[arch])
    cfg = _cfg(ARCHS[arch])
    for r in ranks[shape]:
        rec = r[arch]
        for k in ("loss", "xent", "aux"):
            assert violation(rec["metrics"][0][k], want_m[k]) <= 0, (shape, arch, k)
        assert _assert_grads(_port_grad_tree(cfg, rec["grads"]), want_g, f"{shape} {arch}") > 0
        _assert_grads(_port_grad_tree(cfg, rec["params"]), want_p, f"{shape} {arch} params")


def test_whole_kv_heads_summed_over_model(ranks):
    """qwen2's 2 KV heads on 4 model ranks: wk, wv and their biases stay
    whole, each rank's gradient is its query heads' part, and their sum
    over ``model`` is the JAX gradient."""
    _, want_g, _ = _jax_ref("qwen2-1.5b")
    for r in ranks[(1, 4)]:
        rec = r["qwen2"]
        assert rec["tp"]["q_split"] and not rec["tp"]["kv_split"]
        for name in ("wk", "wv", "bk", "bv"):
            assert all(e is None for e in rec["shapes"][f"layers.0.attn.{name}"]["spec"])
            got = np.stack([rec["grads"][f"layers.{i}.attn.{name}"] for i in range(2)])
            want = np.asarray(want_g["segments"][0]["attn"][name])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_moe_aux_under_a_data_split(ranks, shape):
    """olmoe's router loss over the global batch: the data rows' gates and
    choices summed before the product (a rank's own would give a different
    mean and a dp-times share)."""
    want_m, _, _ = _jax_ref("olmoe-1b-7b")
    for r in ranks[shape]:
        rec = r["olmoe"]
        assert rec["tp"]["batch_split"] and rec["tp"]["experts_split"]
        assert rec["metrics"][0]["aux"] == pytest.approx(want_m["aux"], rel=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", ODD_MESHES)
def test_undivided_sequence_keeps_the_stream_whole(ranks, shape, arch):
    """At 15 positions on 2 or 4 model ranks ``seq`` stays whole: the
    blocks' partial sums are all-reduced, and the step equals the single
    device's (losses and weights after it)."""
    want_m, _, want_p = _single(ARCHS[arch], ODD_S)
    for r in ranks[shape]:
        rec = r[arch + "_odd"]
        assert not rec["tp"]["seq_split"]
        for k in ("loss", "xent", "aux"):
            assert violation(rec["metrics"][0][k], want_m[k]) <= 0
        assert max(violation(rec["params"][n], want_p[n]) for n in want_p) <= 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_whole_weights_under_sequence_parallelism(ranks, arch):
    """On 3 model ranks every weight stays whole while the residual stream
    splits: each block runs on every rank alike and keeps the rank's
    positions, the head is whole (each rank's positions' loss, summed), and
    the step equals the single device's, the collectives ``analysis``'s."""
    want_m, _, want_p = _single(ARCHS[arch], ODD_S)
    cfg, mesh = _cfg(ARCHS[arch]), _mesh(WHOLE_MESH)
    want_coll = analysis.mesh_train_collectives(cfg, KNOBS, mesh, B, ODD_S)
    for r in ranks[WHOLE_MESH]:
        rec = r[arch + "_whole"]
        assert rec["tp"]["seq_split"] and not any(
            v for k, v in rec["tp"].items() if k != "seq_split"), rec["tp"]
        for k in ("loss", "xent", "aux"):
            assert violation(rec["metrics"][0][k], want_m[k]) <= 0
        assert max(violation(rec["params"][n], want_p[n]) for n in want_p) <= 0
        assert rec["collectives"][0] == want_coll
        assert rec["k1"] == [analysis.train_launches(cfg, KNOBS)]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", R05_MESHES)
def test_r05_step_equals_its_fold_oracle(ranks, shape, arch):
    for r in ranks[shape]:
        rec = r[arch + "_r05"]
        assert rec["pair_report"]["total_pairs"] > 0
        assert rec["oracle_loss_violation"] <= 0 and rec["oracle_grad_violation"] <= 0


@pytest.mark.parametrize("shape", CLIP_MESHES)
def test_clipping_uses_the_whole_models_norm(ranks, shape):
    want_m, norm, want_p = _single("qwen2-1.5b", S, CLIP)
    assert norm > 10 * CLIP  # the clip acts
    for r in ranks[shape]:
        rec = r["qwen2_clip"]
        assert rec["clip_norm"] == pytest.approx(norm, rel=1e-5)
        assert max(violation(rec["params"][n], want_p[n]) for n in want_p) <= 0


@pytest.mark.parametrize("shape", MESHES)
def test_layout_follows_the_train_specs(ranks, shape):
    """Each rank's weights, gradients and moments are its blocks of the
    whole shapes under its resolved spec; ``seq`` splits exactly where
    ``spec_for_axes`` splits it."""
    mesh = _mesh(shape)
    for arch in ARCHS.values():
        cfg = _cfg(arch)
        key = next(k for k, v in ARCHS.items() if v == arch)
        whole = {n: tuple(p.shape) for n, p in TM.init_lm(cfg, 0, device="cpu").named_parameters()}
        rules = rules_for(cfg, "train", mesh)
        for seq, job in ((S, key), (ODD_S, key + "_odd")):
            spec = spec_for_axes(("batch", "seq", "embed"), mesh=mesh, rules=rules,
                                 dim_sizes=(B, seq, cfg.d_model))
            for r in ranks[shape]:
                if job not in r:
                    continue
                rec = r[job]
                assert rec["tp"]["seq_split"] == (spec[1] is not None)
                assert rec["tp"]["batch_split"] == (shape[0] > 1)
                for n, s in rec["shapes"].items():
                    want = tuple(d // (mesh.axis_size(e) if e else 1)
                                 for d, e in zip(whole[n], s["spec"], strict=True))
                    assert s["param"] == s["grad"] == want, (shape, n)
                    assert s["moments"] == [want, want], (shape, n)


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_and_k1_calls_equal_the_analysis(ranks, shape):
    mesh = _mesh(shape)
    for key, arch in ARCHS.items():
        cfg = _cfg(arch)
        for job, seq in ((key, S), (key + "_odd", ODD_S)):
            want = analysis.mesh_train_collectives(cfg, KNOBS, mesh, B, seq)
            for r in ranks[shape]:
                if job not in r:
                    continue
                rec = r[job]
                assert rec["collectives"][0] == want == rec["want_collectives"], (shape, job)
                assert rec["k1"] == [analysis.train_launches(cfg, KNOBS)], (shape, job)
    if shape == (1, 2):  # sequence parallel: a gather in and a reduce-scatter out a block
        want = analysis.mesh_train_collectives(_cfg("qwen2-1.5b"), KNOBS, mesh, B, S)
        assert want["reduce_scatter"]["calls"] > 0 and want["all_gather"]["calls"] > 0


def test_bf16_partial_sum_is_stored_fp32_under_autograd(ranks):
    """wo's partial sum on a bf16 rank, through the differentiable paired
    GEMM, reduce-scattered: the same bits as the serving path's fp32 store
    all-reduced, so its error to the fp32 oracle is the serving path's
    (a bf16 store rounds each partial before the sum)."""
    for r in ranks[(1, 2)]:
        rec = r["bf16"]
        assert rec["requires_grad"] and rec["seq_split"]
        assert rec["same_bits"] and rec["train_err"] == rec["serve_err"]


def test_dense_out_dtype_fp32_under_autograd():
    """``layers.dense(…, out_dtype=float32)`` on a bf16 row slab under
    autograd returns K1's fp32 store (the frozen segments' bits), not a
    bf16 result cast up."""
    cfg = _cfg("qwen2-1.5b", "bfloat16")
    meta = pair_lm_params(TM.init_lm(cfg, 0, device="cpu"), 0.0)[0].layers[0].attn.pairing["wo"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, generator=gen).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(64, 64, generator=gen).to(torch.bfloat16).requires_grad_(True)
    y = TL.dense(x, w, pairing=meta, knobs=KNOBS, out_dtype=torch.float32)
    seg = ops.lm_paired_segments(w.detach(), meta)
    want = ops.paired_dense(x.detach(), seg, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.requires_grad
    assert torch.equal(y.detach(), want)
    assert not torch.equal(y.detach(), y.detach().to(torch.bfloat16).float())
    y.sum().backward()
    assert x.grad is not None and w.grad is not None
    yd = TL.dense(x, w, knobs=dataclasses.replace(KNOBS, gemm="pallas"), out_dtype=torch.float32)
    assert yd.dtype == torch.float32
    assert not torch.equal(yd.detach(), yd.detach().to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

LOG_STEP = re.compile(r"^\[train\] step (\d+) loss (\d+\.\d{4}) xent (\d+\.\d{4}) ")


def _cli_losses(capsys, *args) -> list[float]:
    t_train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
                  "--seq", "16", "--log-every", "1", "--steps", "2", *args])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[train] done: 2 steps")
    return [float(m.group(2)) for m in map(LOG_STEP.match, lines) if m]


def test_cli_mesh_gives_the_single_device_losses(capsys):
    """``--mesh 1x2`` prints rank 0's log lines; its losses are the run
    without ``--mesh``'s (the smoke config computes in bf16, and the ranks
    sum their partial products in another order: within 2e-3)."""
    base = _cli_losses(capsys, "--gemm", "pallas_paired")
    got = _cli_losses(capsys, "--gemm", "pallas_paired", "--mesh", "1x2")
    assert len(got) == len(base) == 2
    np.testing.assert_allclose(got, base, rtol=2e-3)


def test_cli_resumes_across_mesh_shapes(tmp_path):
    """A run on 1 × 2 checkpointing every 2 steps (whole arrays, rank 0
    writes), its newest checkpoint removed, resumed on 2 × 1 (each rank
    slicing the whole arrays): steps 3–4 give the straight run's losses."""
    ckpt = tmp_path / "ckpt"
    kw = dict(arch="qwen2-1.5b", smoke=True, steps=4, batch=2, seq=16, lr=3e-3,
              gemm="pallas_paired", device="cpu", dtype="float32", log_every=0,
              ckpt_dir=str(ckpt), ckpt_every=2)
    straight = t_train.train(mesh="1x2", **kw)
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_0000000002", "step_0000000004"]
    shutil.rmtree(ckpt / "step_0000000004")
    resumed = t_train.train(mesh="2x1", **kw)
    assert resumed["start"] == 2 and [r["start"] for r in resumed["ranks"]] == [2, 2]
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               [h["loss"] for h in straight["history"][2:]], rtol=1e-5)


def test_refusals():
    """The fused attention raises ``NotImplementedError`` before any rank is
    wired; FSDP (mistral-large-123b's rules put ``embed`` over ``data``)
    builds, every layer gathered over ``data`` (its parity:
    ``test_torch_fsdp.py``)."""
    mesh = _mesh((2, 2))
    opt = adamw(LR)
    step = build_train_step(get_config("mistral-large-123b"), opt, KNOBS, mesh)
    assert step.layout(8, 128).fsdp_axes == ("data",)
    with pytest.raises(NotImplementedError, match="no backward"):
        build_train_step(_cfg("qwen2-1.5b"), opt, dataclasses.replace(KNOBS, attn="pallas_fused"),
                         mesh)
    assert math.isfinite(analysis.mesh_train_collectives(
        _cfg("olmoe-1b-7b"), KNOBS, mesh, B, S)["all_reduce"]["bytes"])
