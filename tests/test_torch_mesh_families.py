"""The tensor-parallel ServeEngine of the other five families against the
JAX package: deepseek's MLA and shared experts, mamba2's SSM, hymba's
hybrid layers, whisper's encoder-decoder and internvl2's vision prefix.

Gloo ranks on the CPU (``launch.mesh.spawn``), one spawn a mesh shape
serving every config (``benchmarks.mesh_decode.serve_many``); each slot's
frames or patches are row ``i`` of ``launch.inputs.make_batch``'s stubs.

* r = 0, fp32, per column, on (1, 2) and (1, 4) (and internvl2 and deepseek
  on (2, 2), the slots over the data rows): every rank's tokens equal the
  JAX single-host engine's, and its last logits are within 1e-5 of the
  port's single-rank engine's, relative to their largest; the add/release
  cycle on each new cache (latent, SSM state and conv tails, cross K/V)
  gives the JAX engine's tokens.
* r = 0.05: each rank's paired weights folded by its own metadata,
  assembled, served by the single-device plain engine; logits within 1e-5.
* layouts: every weight and cache entry a rank holds has the shape its
  resolved spec gives; the splits of each segment as the rules resolve them.
* collectives and K1 calls a decode step and a prefill equal
  ``analysis.mesh_decode_collectives``/``mesh_prefill_collectives`` and
  ``decode_launches``/``prefill_launches``.
* hymba with SSM heads that do not divide ``model`` while its channels do
  (``ssm.expand`` 5, ``head_dim`` 32: 10 heads over 320 channels): on (1,
  4) the channels split and the heads stay whole (the conv'd channels
  all-gathered, every rank steps all ten heads), as hymba-1.5b's 50 heads
  over 3200 channels resolve on four ranks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch.benchmarks.mesh_decode import (
    assemble_folded,
    generate,
    knobs_for,
    refill_len,
    serve_many,
    shard_shapes,
    slot_extras,
)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm as M
from repro_torch.parallel.sharding import Mesh
from repro_torch.serving.engine import ServeEngine

TOL = 1e-5  # logits, relative to the largest, fp32
STEPS = 4
MAX_SEQ = 24  # hymba's 8 meta tokens make 32 positions: 8 a rank on (1, 4)
ARCHS = {"deepseek": "deepseek-v2-lite-16b", "mamba2": "mamba2-2.7b", "hymba": "hymba-1.5b",
         "hymba_heads_whole": "hymba-1.5b", "whisper": "whisper-base",
         "internvl2": "internvl2-2b"}
#: the (2, 2) runs: a vision prefix and MLA with shared experts over two data rows
DATA_ROWS = ("internvl2", "deepseek")
MESHES = [(1, 2), (1, 4), (2, 2)]
PLAIN = M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none")
#: slots on every mesh (two data rows take two each): one JAX reference a
#: config, and free slots for the counted prefill
BATCH = 4
#: hymba's 8 meta tokens make 33 positions, which 4 ranks do not divide: its
#: K/V cache stays whole (as do its 2 KV heads), the query heads split
WHOLE_CACHE_SEQ = 25


def _variant(cfg):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, expand=5, head_dim=32))


def _cfg(name):
    jcfg = dataclasses.replace(jax_smoke_config(ARCHS[name]), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCHS[name]), dtype="float32")
    return (_variant(jcfg), _variant(cfg)) if name == "hymba_heads_whole" else (jcfg, cfg)


@functools.cache
def _values(name):
    jcfg, _ = _cfg(name)
    return jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])


def _prompts(name):
    _, cfg = _cfg(name)
    rng = np.random.default_rng(len(name))
    # longer than internvl2's 8 patch positions; deepseek's 11-token prompt
    # routes its experts (T·K = 22 > 2E), the 6-token one runs them all;
    # hymba's 11 + 8 meta positions pass its 16-position window; the 6-token
    # prompt's refill of 3 fills an SSM's conv tail (the JAX prefill's tail
    # is short for fewer tokens, ROADMAP §3)
    lens = (12, 16) if cfg.vision_prefix else (6, 11)
    return {i: rng.integers(1, cfg.vocab, size=n).astype(np.int32) for i, n in enumerate(lens)}


@functools.cache
def _extras(name):
    _, cfg = _cfg(name)
    b = make_batch(cfg, BATCH, 4, "prefill", seed=1, device="cpu")
    return {k: b[k].numpy() for k in ("frames", "patches") if k in b} or None


def _jax_run(name):
    """The JAX single-host engine through the ranks' sequence: generate, one
    more step, a prefill into a free slot and its release, then slot 0
    released, refilled and one step."""
    jcfg, cfg = _cfg(name)
    prompts, extras = _prompts(name), _extras(name)
    jx = lambda slot: None if extras is None else {
        k: jnp.asarray(v) for k, v in slot_extras(extras, slot).items()}
    eng = JaxEngine(jcfg, _values(name), max_seq=MAX_SEQ, batch_size=BATCH,
                    knobs=JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none"))
    out = {s: [eng.add_request(s, p, jx(s))] for s, p in prompts.items()}
    for _ in range(STEPS - 1):
        nxt = eng.step()
        for s in prompts:
            out[s].append(int(nxt[s]))
    eng.step()
    free = [s for s in range(BATCH) if s not in prompts][0]
    eng.add_request(free, prompts[0], jx(free))
    eng.release_slot(free)
    eng.release_slot(0)
    cycle = [eng.add_request(0, prompts[0][:refill_len(cfg, len(prompts[0]))], jx(0)),
             eng.step().tolist()]
    return out, cycle


def _port_single(name, model=None, max_seq=MAX_SEQ):
    """The port's single-rank engine (r = 0, per column), its tokens and last
    logits; or the plain engine over ``model`` (the folded-dense oracle)."""
    _, cfg = _cfg(name)
    if model is None:
        model = M.lm_params_from_numpy(_values(name), cfg, device="cpu")
        eng = ServeEngine(cfg, model, max_seq=max_seq, batch_size=BATCH, knobs=knobs_for(0.0))
    else:
        eng = ServeEngine(cfg, model, max_seq=max_seq, batch_size=BATCH, knobs=PLAIN)
    out = generate(eng, _prompts(name), STEPS, _extras(name))
    return out, eng.last_logits


def _names(shape):
    return list(ARCHS) if shape[0] == 1 else list(DATA_ROWS)


@pytest.fixture(scope="module")
def want():
    return {name: (*_jax_run(name), _port_single(name)[1]) for name in ARCHS}


def _jobs(shape):
    jobs = {}
    for name in _names(shape):
        _, cfg = _cfg(name)
        kw = {"max_seq": MAX_SEQ, "batch_size": BATCH, "extras": _extras(name)}
        jobs[name] = ((cfg, _values(name), knobs_for(0.0), _prompts(name), STEPS),
                      {**kw, "cycle": True})
        jobs[name + "_r05"] = ((cfg, _values(name), knobs_for(0.05), _prompts(name), STEPS),
                               {**kw, "fold": True})
    if shape == (1, 4):
        _, cfg = _cfg("hymba")
        jobs["hymba_whole_cache"] = ((cfg, _values("hymba"), knobs_for(0.0), _prompts("hymba"),
                                      STEPS), {"max_seq": WHOLE_CACHE_SEQ, "batch_size": BATCH})
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, per mesh shape: one spawn a shape."""
    return {shape: spawn(serve_many, shape, backend="gloo", device="cpu",
                         args=(_jobs(shape),), timeout=400)
            for shape in MESHES}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _cases():
    return [(shape, name) for shape in MESHES for name in _names(shape)]


@pytest.mark.parametrize("shape,name", _cases())
def test_r0_tokens_equal_jax_and_logits_the_single_rank_engine(ranks, want, shape, name):
    out, cycle, logits = want[name]
    for rec in ranks[shape]:
        got = rec[name]
        assert got["tokens"] == out, (name, shape, got["rank"])
        assert got["logits"].shape == logits.shape
        assert _rel(got["logits"], logits) <= TOL
        assert got["cycle"] == cycle  # the add/release cycle on the mesh's caches


@pytest.mark.parametrize("shape,name", _cases())
def test_r005_equals_the_folded_dense_oracle(ranks, shape, name):
    _, cfg = _cfg(name)
    model = M.lm_params_from_numpy(_values(name), cfg, device="cpu")
    oracle = assemble_folded(cfg, model, [rec[name + "_r05"]["folded"] for rec in ranks[shape]])
    out, logits = _port_single(name, oracle)
    for rec in ranks[shape]:
        got = rec[name + "_r05"]
        assert _rel(got["logits"], logits) <= TOL
        assert got["tokens"] == out
    report = ranks[shape][0][name + "_r05"]["pair_report"]
    assert sum(lr["n_pairs"] for lr in report) > 0  # r = 0.05 paired something to fold
    assert any(lr["row_shards"] > 1 for lr in report)  # and the slabs constrained it


#: the splits the rules give each config's segments at (1, 2) / (1, 4)
SPLITS = {
    "deepseek": lambda n: [{"q_split", "ff_split"},
                           {"q_split", "experts_split", "router_split", "shared_split"}],
    "mamba2": lambda n: [{"ssm_in_split", "ssm_heads_split"}],
    "hymba": lambda n: [{"q_split", "ff_split", "ssm_in_split", "ssm_heads_split"}
                        | ({"kv_split"} if n == 2 else set())] * 3,
    "hymba_heads_whole": lambda n: [{"q_split", "ff_split", "ssm_in_split"}
                                    | ({"kv_split", "ssm_heads_split"} if n == 2 else set())] * 3,
    "whisper": lambda n: [{"q_split", "kv_split", "xq_split", "xkv_split", "ff_split"}],
    "internvl2": lambda n: [{"q_split", "ff_split"} | ({"kv_split"} if n == 2 else set())],
}


@pytest.mark.parametrize("shape,name", _cases())
def test_layouts_split_what_the_rules_say(ranks, shape, name):
    _, cfg = _cfg(name)
    for rec in ranks[shape]:
        got = rec[name]
        mesh = Mesh(dict(zip(("data", "model"), shape, strict=True)), rank=got["rank"])
        weights, cache = shard_shapes(cfg, mesh, BATCH, MAX_SEQ)
        assert got["shapes"] == weights
        assert got["cache_shapes"] == cache
    got = ranks[shape][0][name]
    want = SPLITS[name](shape[1])
    assert [{k for k, v in seg.items() if v} for seg in got["tp_segments"]] == want
    # 2 KV heads divide 2 ranks, not 4; hymba's 32 positions divide both
    seq = name == "deepseek" or (name.startswith("hymba") or name == "internvl2") and (
        shape[1] == 4)
    assert got["tp"]["cache_seq"] == seq and got["tp"]["vocab_split"]
    assert got["tp"]["batch_split"] == (shape[0] > 1)
    if name == "whisper":
        assert {k for k, v in got["tp_encoder"].items() if v} == {"q_split", "kv_split",
                                                                  "ff_split"}


@pytest.mark.parametrize("shape,name", _cases())
def test_collectives_and_k1_calls_equal_the_analysis(ranks, shape, name):
    _, cfg = _cfg(name)
    mesh = Mesh(dict(zip(("data", "model"), shape, strict=True)))
    knobs = knobs_for(0.0)
    step = analysis.mesh_decode_collectives(cfg, knobs, mesh, batch_size=BATCH, max_seq=MAX_SEQ)
    pre = analysis.mesh_prefill_collectives(cfg, knobs, mesh, batch_size=BATCH, max_seq=MAX_SEQ)
    k1 = sum(analysis.decode_launches(cfg, cfg.layer_kind(i), knobs)["paired_matmul"]
             for i in range(cfg.n_layers))
    k1_pre = analysis.prefill_launches(cfg, knobs)["paired_matmul"]
    for rec in ranks[shape]:
        got = rec[name]
        assert {k: v["calls"] for k, v in got["step_collectives"].items()} == step
        assert {k: v["calls"] for k, v in got["prefill_collectives"].items()} == pre
        assert got["step_k1"] == k1 and got["prefill_k1"] == k1_pre
    n_ssm = sum(cfg.layer_kind(i) != "dense" for i in range(cfg.n_layers))
    if name == "hymba_heads_whole" and shape == (1, 4):  # the conv'd channels' gathers
        assert step["all_gather"] == 2 * cfg.n_layers + n_ssm + 1
    if name == "deepseek":  # the latent's queries and partials, the router's logits
        assert step["all_gather"] == 2 * cfg.n_layers + (cfg.n_layers - 1) + 1 + (shape[0] > 1)
    if name == "whisper":  # the encoder's wo and w_down in a prefill
        assert pre["all_reduce"] - step["all_reduce"] == 2 * cfg.encoder.n_layers


def test_deepseek_routed_prefill_takes_the_expert_parallel_route(ranks):
    for rec in ranks[(1, 2)]:
        # the 11-token prompt routes in both MoE layers; its refill (5) does not
        assert rec["deepseek"]["moe_shard_map_calls"] == 2


def test_hymba_cache_the_ranks_cannot_split_stays_whole(ranks):
    """(1, 4) at 33 positions: the rules' guard replicates the cache, so each
    rank's query heads read the whole K/V (window and sinks at the
    meta-shifted positions) with no gathers; tokens and logits as the
    single-rank engine's, collectives as ``analysis`` says."""
    _, cfg = _cfg("hymba")
    out, logits = _port_single("hymba", max_seq=WHOLE_CACHE_SEQ)
    mesh = Mesh({"data": 1, "model": 4})
    step = analysis.mesh_decode_collectives(cfg, knobs_for(0.0), mesh, batch_size=BATCH,
                                            max_seq=WHOLE_CACHE_SEQ)
    for rec in ranks[(1, 4)]:
        got = rec["hymba_whole_cache"]
        assert not got["tp"]["cache_seq"] and not got["tp"]["kv_split"] and got["tp"]["q_split"]
        assert got["cache_shapes"]["k"] == (cfg.n_layers, BATCH, WHOLE_CACHE_SEQ + 8,
                                            cfg.n_kv_heads, cfg.head_dim)
        assert got["tokens"] == out and _rel(got["logits"], logits) <= TOL
        assert {k: v["calls"] for k, v in got["step_collectives"].items()} == step
    assert step["all_gather"] == 1  # the head's alone: no partial softmaxes
