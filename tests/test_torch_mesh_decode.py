"""The port's tensor-parallel paired decode against the JAX package.

Gloo ranks on the CPU (``launch.mesh.spawn``: one process a rank), spawned
once per mesh shape for the whole module; every check of that shape runs
inside the ranks (``benchmarks.mesh_decode.serve_many``) and comes back
through the spawn's results.

* qwen2 smoke, fp32, r = 0, per column, on meshes (1, 2), (1, 4) and
  (2, 2): every rank's tokens equal the JAX single-host engine's, its last
  logits within 1e-5 of them relative to their largest (at r = 0 the paired
  kernel is exact: a divergence is a sharding fault).  (1, 2) splits the KV
  heads and the cache's heads; (1, 4) cannot (2 KV heads), so wk/wv are
  whole and the cache is sequence-sharded (the partial-softmax merge); (2,
  2) splits the slots over the data rows.
* the same at r = 0.05 against the folded-dense oracle: each rank's paired
  weights folded through its own metadata (``fold_lm_weight``), assembled,
  and served by the single-device plain engine; logits within 1e-5.
* the add/release cycle of ``tests/test_mesh_decode.py`` on the mesh cache.
* olmoe smoke at (1, 2) and (1, 4): an 8-token prompt whose prefill runs
  the dense expert branch, a 12-token one the expert-parallel route
  (T·K = 24 > 2E = 16), decode on the dense branch; tokens and logits held
  to the JAX engine's; layer 0's expert block held to the JAX ``moe_block``
  under a one-device mesh, which takes ``_moe_shard_map``, within 1e-5.
* collectives a decode step and a prefill make, equal to
  ``analysis.mesh_decode_collectives`` / ``mesh_prefill_collectives``; K1
  calls a decode step equal to ``analysis.decode_launches`` over the layers.
* ``attn="pallas_fused"`` on a mesh raises; the other five families wire.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models.param import unzip
from repro.parallel.rules import rules_for as jax_rules_for
from repro.parallel.sharding import activate as jax_activate
from repro.parallel.sharding import make_mesh_compat
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch.benchmarks.mesh_decode import assemble_folded, knobs_for, serve_many
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm as M
from repro_torch.models.param import param_axes_and_shapes
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh, shardings_for
from repro_torch.serving.engine import ServeEngine

TOL = 1e-5  # logits, relative to the largest, fp32
STEPS = 5
MAX_SEQ = 24  # 24 positions: 4 ranks hold 6 each of a sequence-sharded cache
MESHES = [(1, 2), (1, 4), (2, 2)]


def _cfg(arch):
    return (dataclasses.replace(jax_smoke_config(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


@functools.cache
def _values(arch):
    jcfg, _ = _cfg(arch)
    return jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(1, vocab, size=n).astype(np.int32) for i, n in enumerate(lens)}


QWEN_PROMPTS = _prompts(256, (7, 12))
MOE_PROMPTS = _prompts(256, (8, 12), seed=1)
MOE_X = np.random.default_rng(2).normal(size=(1, 12, 64)).astype(np.float32)


def _jax_run(arch, prompts, batch):
    """The JAX single-host engine through the ranks' sequence: generate, one
    more step, a prefill into a free slot and its release, then slot 0
    released, refilled with half its prompt, and one step."""
    jcfg, _ = _cfg(arch)
    eng = JaxEngine(jcfg, _values(arch), max_seq=MAX_SEQ, batch_size=batch,
                    knobs=JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none"))
    out = eng.generate(dict(prompts), STEPS)
    logits = eng.last_logits
    eng.step()
    free = [s for s in range(batch) if s not in prompts]
    if free:
        eng.add_request(free[0], prompts[0])
        eng.release_slot(free[0])
    eng.release_slot(0)
    cycle = [eng.add_request(0, prompts[0][: max(1, len(prompts[0]) // 2)]), eng.step().tolist()]
    return out, logits, cycle


@pytest.fixture(scope="module")
def want():
    return {"qwen2": _jax_run("qwen2-1.5b", QWEN_PROMPTS, 3),
            "qwen2_b4": _jax_run("qwen2-1.5b", QWEN_PROMPTS, 4),
            "olmoe": _jax_run("olmoe-1b-7b", MOE_PROMPTS, 3)}


def _jobs(shape):
    _, cfg = _cfg("qwen2-1.5b")
    q = _values("qwen2-1.5b")
    batch = 4 if shape[0] > 1 else 3
    jobs = {
        "qwen2_r0": ((cfg, q, knobs_for(0.0), QWEN_PROMPTS, STEPS),
                     {"max_seq": MAX_SEQ, "batch_size": batch, "cycle": True}),
        "qwen2_r05": ((cfg, q, knobs_for(0.05), QWEN_PROMPTS, STEPS),
                      {"max_seq": MAX_SEQ, "batch_size": batch, "fold": True}),
    }
    if shape[0] == 1:  # the other GEMM routes on a mesh: torch.matmul, K1's dense form
        gemm = "xla" if shape[1] == 4 else "pallas"
        jobs["qwen2_" + gemm] = ((cfg, q, dataclasses.replace(knobs_for(0.0), gemm=gemm),
                                  QWEN_PROMPTS, STEPS), {"max_seq": MAX_SEQ, "batch_size": batch})
        _, mcfg = _cfg("olmoe-1b-7b")
        jobs["olmoe_r0"] = ((mcfg, _values("olmoe-1b-7b"), knobs_for(0.0), MOE_PROMPTS, STEPS),
                            {"max_seq": MAX_SEQ, "batch_size": 3, "cycle": True, "moe_x": MOE_X})
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, per mesh shape: one spawn a shape."""
    return {shape: spawn(serve_many, shape, backend="gloo", device="cpu",
                         args=(_jobs(shape),), timeout=300)
            for shape in MESHES}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("shape", MESHES)
def test_qwen2_r0_tokens_and_logits_equal_jax(ranks, want, shape):
    out, logits, cycle = want["qwen2_b4" if shape[0] > 1 else "qwen2"]
    for rec in ranks[shape]:
        got = rec["qwen2_r0"]
        assert got["tokens"] == out, (shape, rec["qwen2_r0"]["rank"])
        assert got["logits"].shape == logits.shape
        assert _rel(got["logits"], logits) <= TOL
        assert got["moe_shard_map_calls"] == 0


@pytest.mark.parametrize("shape,gemm", [((1, 2), "pallas"), ((1, 4), "xla")])
def test_other_gemm_routes_on_the_mesh_equal_jax(ranks, want, shape, gemm):
    """Unpaired weights: wo's and w_down's partial sums from K1's dense form
    (1, 2) or torch.matmul (1, 4), all-reduced before the cast."""
    out, logits, _ = want["qwen2"]
    for rec in ranks[shape]:
        got = rec["qwen2_" + gemm]
        assert got["tokens"] == out
        assert _rel(got["logits"], logits) <= TOL
        assert got["pair_report"] is None


@pytest.mark.parametrize("shape", MESHES)
def test_add_release_cycle_on_the_mesh_cache(ranks, want, shape):
    """tests/test_mesh_decode.py:73 on the port: release, refill and step on
    the sharded cache give the JAX engine's tokens."""
    _, _, cycle = want["qwen2_b4" if shape[0] > 1 else "qwen2"]
    for rec in ranks[shape]:
        assert rec["qwen2_r0"]["cycle"] == cycle


@pytest.mark.parametrize("shape", MESHES)
def test_layouts_split_what_the_rules_say(ranks, shape):
    tp = ranks[shape][0]["qwen2_r0"]["tp"]
    assert tp["q_split"] and tp["vocab_split"] and tp["ff_split"]
    assert tp["kv_split"] == (shape[1] == 2)  # 2 KV heads divide 2 ranks, not 4
    assert tp["cache_seq"] == (shape[1] == 4)
    assert tp["batch_split"] == (shape[0] > 1)  # a data axis of one rank splits nothing


@pytest.mark.parametrize("shape", MESHES)
def test_qwen2_r005_equals_the_folded_dense_oracle(ranks, shape):
    jcfg, cfg = _cfg("qwen2-1.5b")
    model = M.lm_params_from_numpy(_values("qwen2-1.5b"), cfg, device="cpu")
    oracle = assemble_folded(cfg, model, [rec["qwen2_r05"]["folded"] for rec in ranks[shape]])
    batch = 4 if shape[0] > 1 else 3
    eng = ServeEngine(cfg, oracle, max_seq=MAX_SEQ, batch_size=batch,
                      knobs=M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none"))
    out = eng.generate(dict(QWEN_PROMPTS), STEPS)
    for rec in ranks[shape]:
        got = rec["qwen2_r05"]
        assert _rel(got["logits"], eng.last_logits) <= TOL
        assert got["tokens"] == out
    # the row-parallel leaves lost pairs to their slabs: the fold is not the unsharded one
    assert any(lr["row_shards"] > 1 for lr in ranks[shape][0]["qwen2_r05"]["pair_report"])


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_olmoe_tokens_logits_and_expert_route_equal_jax(ranks, want, shape):
    out, logits, cycle = want["olmoe"]
    for rec in ranks[shape]:
        got = rec["olmoe_r0"]
        assert got["tokens"] == out
        assert _rel(got["logits"], logits) <= TOL
        assert got["cycle"] == cycle
        assert got["tp"]["experts_split"] and got["tp"]["kv_split"]
        # the 12-token prefill (and the refill's, 4 tokens: dense) routed once
        assert got["moe_shard_map_calls"] == 1 * 2  # one routed prefill, two layers
        assert got["moe_routes"] == 1


@pytest.fixture(scope="module")
def jax_moe_shard_map():
    """The JAX moe_block of layer 0 under a one-device mesh: _moe_shard_map."""
    jcfg, _ = _cfg("olmoe-1b-7b")
    p = jax.tree.map(lambda a: a[0], _values("olmoe-1b-7b")["segments"][0]["moe"])
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    calls = []
    orig = JL._moe_shard_map

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    JL._moe_shard_map = spy
    try:
        with mesh, jax_activate(mesh, jax_rules_for(jcfg, "decode", mesh)):
            y, _ = JL.moe_block(jcfg, p, jax.numpy.asarray(MOE_X))
    finally:
        JL._moe_shard_map = orig
    assert calls, "the JAX moe_block did not take _moe_shard_map"
    return np.asarray(y)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_expert_parallel_route_equals_jax_moe_shard_map(ranks, jax_moe_shard_map, shape):
    for rec in ranks[shape]:
        assert _rel(rec["olmoe_r0"]["moe_y"], jax_moe_shard_map) <= TOL


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_and_k1_calls_equal_the_analysis(ranks, shape):
    names = ("data", "model")
    for arch, job, batch in (("qwen2-1.5b", "qwen2_r0", 4 if shape[0] > 1 else 3),
                             ("olmoe-1b-7b", "olmoe_r0", 3)):
        if job not in ranks[shape][0]:
            continue
        _, cfg = _cfg(arch)
        mesh = Mesh(dict(zip(names, shape, strict=True)))
        knobs = knobs_for(0.0)
        step = analysis.mesh_decode_collectives(cfg, knobs, mesh, batch_size=batch,
                                                max_seq=MAX_SEQ)
        pre = analysis.mesh_prefill_collectives(cfg, knobs, mesh, batch_size=batch,
                                                max_seq=MAX_SEQ)
        k1 = sum(analysis.decode_launches(cfg, cfg.layer_kind(i), knobs)["paired_matmul"]
                 for i in range(cfg.n_layers))
        for rec in ranks[shape]:
            got = rec[job]
            assert {k: v["calls"] for k, v in got["step_collectives"].items()} == step
            assert {k: v["calls"] for k, v in got["prefill_collectives"].items()} == pre
            assert got["step_k1"] == k1 and got["prefill_k1"] == k1
        if arch == "qwen2-1.5b" and shape == (1, 4):  # the partial-softmax merge's gathers
            assert step["all_gather"] == 2 * cfg.n_layers + 1


def test_mesh_refuses_fused_attention_and_other_families():
    """The fused decode attention stays refused on a mesh; the other five
    families (MLA with shared experts, SSM, hybrid, encoder-decoder, vision
    prefix) wire on a shape-only mesh (no process: wiring sends nothing),
    and the analysis gives their collectives."""
    mesh = Mesh({"data": 1, "model": 2})
    _, cfg = _cfg("qwen2-1.5b")
    model = M.init_lm(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="single-host only"):
        ServeEngine(cfg, model, max_seq=16, batch_size=2, mesh=mesh,
                    knobs=M.PerfKnobs(gemm="pallas_paired", attn="pallas_fused"))
    for arch in ("deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b", "whisper-base",
                 "internvl2-2b"):
        other = get_smoke_config(arch)
        eng = ServeEngine(other, M.init_lm(other, 0, device="cpu"), max_seq=16, batch_size=2,
                          mesh=mesh, knobs=knobs_for(0.0))
        assert eng.tp.vocab_split and eng.pair_report is not None
        step = analysis.mesh_decode_collectives(other, knobs_for(0.0), mesh, batch_size=2,
                                                max_seq=16)
        assert step["all_reduce"] > 1 and step["all_gather"] >= 1  # the embedding's, the head's


def test_mesh_embedding_refuses_a_token_no_rank_holds():
    """The vocab-parallel lookup raises on an id outside the table, as the
    single-device lookup does, before any collective (so a shape-only mesh
    of no processes serves here): a masked lookup would turn it into a zero
    row."""
    _, cfg = _cfg("qwen2-1.5b")
    model = M.init_lm(cfg, 0, device="cpu")
    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none")
    single = ServeEngine(cfg, model, max_seq=16, batch_size=2, knobs=knobs)
    bad = np.array([3, model.embed.shape[0]])
    with pytest.raises(IndexError):
        single.add_request(0, bad)
    for rank in range(2):
        eng = ServeEngine(cfg, model, max_seq=16, batch_size=2, knobs=knobs,
                          mesh=Mesh({"data": 1, "model": 2}, rank=rank))
        assert eng.tp.vocab_split
        for prompt in (bad, np.array([-1, 3])):
            with pytest.raises(IndexError, match="outside the embedding"):
                eng.add_request(0, prompt)


def test_shard_model_slices_by_the_resolved_specs():
    _, cfg = _cfg("qwen2-1.5b")
    from repro_torch.launch.steps import shard_model

    model = M.init_lm(cfg, 0, device="cpu")
    axes, shapes = param_axes_and_shapes(cfg)
    for rank in range(4):
        mesh = Mesh({"data": 1, "model": 4}, rank=rank)
        local = shard_model(model, shardings_for(axes, mesh, rules_for(cfg, "decode", mesh),
                                                 shapes), mesh)
        a, b = local.layers[1].attn, model.layers[1].attn
        assert torch.equal(a.wq, b.wq[:, rank:rank + 1])  # 4 q heads: one a rank
        assert torch.equal(a.wk, b.wk) and torch.equal(a.bv, b.bv)  # 2 KV heads: whole
        assert torch.equal(a.wo, b.wo[rank:rank + 1])
        assert torch.equal(local.layers[0].mlp.w_down, model.layers[0].mlp.w_down[rank * 32:
                                                                                 (rank + 1) * 32])
        assert torch.equal(local.embed, model.embed[rank * 64:(rank + 1) * 64])
