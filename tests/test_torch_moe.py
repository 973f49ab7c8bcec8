"""The port's MoE (olmoe-1b-7b's family) against the JAX package's, in fp32.

Both packages compute from the same numpy inputs: the JAX package's seeded
olmoe smoke init (2 layers, d=64, 8 experts top-2, expert d_ff 96), handed
to the port through ``lm_params_from_numpy``, and random activations.  The
smoke config's capacity factor (4.0) drops nothing; each routed check also
runs at ``capacity_factor=1.0``, where tokens past an expert's capacity are
dropped.

* routing (``_moe_route``) and the combine (``_moe_combine``) index for
  index, ties of the gates included (top-k to the lower expert index);
* ``moe_block`` on the dense branch (``T·K ≤ 2E``) and the routed one, its
  output and load-balance loss within 1e-5, unpaired and paired at r=0;
* the expert-grid GEMM (``expert_dense``: shared and per-expert activations;
  structured and column-blocked at bn ∈ {1, 3}) against the JAX package's
  ``fused_paired_expert_dense`` (Pallas in interpret mode) and against the
  fold (``fold_lm_expert_weight``) of both packages, within 1e-5;
* the expert pairing metadata and ``LeafReport``s equal to the JAX
  package's ``pair_params`` at r ∈ {0, 0.05} (matrices scaled by 0.3 so
  r=0.05 pairs lanes in every mode);
* the forward (prefill and two decode steps) at r=0, and the serving
  engine's tokens at r=0 and r=0.05, equal to the JAX package's.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import transform as j_transform
from repro.kernels import ops as j_ops
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch import configs as t_configs
from repro_torch.core.transform import pair_params
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rel_err
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.serving.engine import ServeEngine

RTOL = 1e-5
ARCH = "olmoe-1b-7b"
CAPACITY = [4.0, 1.0]  # the smoke config's (no drops), and one that drops
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]


def _cfgs(capacity: float = 4.0):
    """(JAX, port) olmoe smoke configs in fp32 at ``capacity``."""
    def fix(cfg):
        return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return fix(j_configs.get_smoke_config(ARCH)), fix(t_configs.get_smoke_config(ARCH))


@functools.cache
def _values(scale: float = 1.0):
    """The JAX smoke init as numpy, its decoder matrices times ``scale``,
    with random norm scales."""
    cfg, _ = _cfgs()
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    seg = vals["segments"][0]
    for sub in ("attn", "moe"):
        for name in [n for n in seg[sub] if n.startswith("w")]:
            seg[sub][name] = seg[sub][name] * np.float32(scale)
    for norm in (seg["ln1"], seg["ln2"], vals["final_norm"]):
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return vals


def _moe_values(layer: int = 0, scale: float = 1.0) -> dict:
    return {k: v[layer] for k, v in _values(scale)["segments"][0]["moe"].items()}


def _port_moe(p: dict) -> TL.MoE:
    """The port's MoE block over numpy values (and ``<name>_pairing``)."""
    t = lambda a: torch.as_tensor(np.array(a)).long() if np.asarray(a).dtype.kind == "i" \
        else torch.as_tensor(np.array(a))
    pairing = {k[:-len("_pairing")]: {mk: t(mv) for mk, mv in v.items()}
               for k, v in p.items() if k.endswith("_pairing")}
    return TL.MoE(pairing=pairing, **{k: t(v) for k, v in p.items()
                                     if not k.endswith("_pairing")})


def _x(B, S, d, seed=3):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "moe":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert port.head_dim == ref.head_dim and port.segments() == ref.segments()
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    assert [port.layer_kind(i) for i in range(port.n_layers)] == ["moe"] * port.n_layers


def test_config_refuses_unported_moe():
    """Shared experts and dense leading layers are ported (deepseek-v2-lite,
    ``tests/test_torch_mla.py``); an MoE config without its family raises;
    the SSM and hybrid families (``tests/test_torch_ssm.py``,
    ``tests/test_torch_hybrid.py``) refuse a config without their SSM
    geometry, the encoder-decoder and vision families
    (``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``) one
    without their encoder or patch prefix; layernorm is ported."""
    from repro_torch.configs.base import ModelConfig, MoeConfig

    base = dataclasses.asdict(t_configs.get_smoke_config(ARCH))
    base.pop("moe")
    cfg = ModelConfig(**base, moe=MoeConfig(n_experts=8, top_k=2, n_shared=1,
                                            first_k_dense=1, d_ff_dense=96))
    assert cfg.moe.n_shared == 1
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == ["dense", "moe"]
    for family in ("ssm", "hybrid", "encdec", "vlm"):
        with pytest.raises(ValueError, match=family):
            ModelConfig(**{**base, "family": family})
    assert ModelConfig(**{**base, "norm": "layernorm"}, moe=MoeConfig()).norm == "layernorm"
    with pytest.raises(ValueError, match="norm"):
        ModelConfig(**{**base, "norm": "batchnorm"}, moe=MoeConfig())
    with pytest.raises(ValueError, match="family"):
        ModelConfig(**{**base, "family": "dense"}, moe=MoeConfig())


# ---------------------------------------------------------------------------
# routing and combine, index for index
# ---------------------------------------------------------------------------


def _gates(B, S, E, seed, ties: bool):
    """Router probabilities; with ``ties`` rounded to a few levels, so that
    many gates of a row are equal."""
    g = np.random.default_rng(seed).random((B * S, E)).astype(np.float32)
    if ties:
        g = np.round(g * 3) / 3 + 0.01
    return g / g.sum(-1, keepdims=True)


@pytest.mark.parametrize("ties", [False, True])
def test_top_k_breaks_ties_to_the_lower_expert(ties):
    g = _gates(2, 24, 8, 5, ties)
    wv, wi = jax.lax.top_k(jnp.asarray(g), 2)
    gv, gi = TL._top_k(torch.as_tensor(g), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if ties:
        assert (g[:, :, None] == g[:, None, :]).sum() > g.size  # ties are there


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("capacity", CAPACITY)
def test_route_and_combine_match_jax(capacity, ties):
    jcfg, tcfg = _cfgs(capacity)
    B, S, d, E, K = 2, 24, jcfg.d_model, jcfg.moe.n_experts, jcfg.moe.top_k
    x = _x(B, S, d)
    topw, topi = jax.lax.top_k(jnp.asarray(_gates(B, S, E, 7, ties)), K)
    topw = np.array(topw / topw.sum(-1, keepdims=True))
    topi = np.array(topi)
    want = JL._moe_route(jcfg, jnp.asarray(x), jnp.asarray(topi), jnp.asarray(topw))
    got = TL._moe_route(tcfg, torch.as_tensor(x), torch.as_tensor(topi).long(),
                        torch.as_tensor(topw))
    for name, g, w in zip(("xb", "inv_tok", "inv_w", "counts"), got[:4], want[:4], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[4] == want[4]
    C = got[4]
    dropped = int((got[3] - C).clamp_min(0).sum())
    assert (dropped > 0) == (capacity == 1.0)

    yb = np.random.default_rng(9).normal(size=(B, E, C, d)).astype(np.float32)
    want_y = JL._moe_combine(B, S, d, jnp.asarray(yb), want[1], want[2], jnp.float32)
    got_y = TL._moe_combine(B, S, d, torch.as_tensor(yb), got[1], got[2], torch.float32, K)
    assert rel_err(got_y, want_y) <= RTOL
    # a dropped choice adds nothing: rows of tokens with no kept slot are zero
    kept = np.zeros((B, S + 1), bool)
    kept[np.arange(B)[:, None], np.asarray(want[1])] = True
    assert not got_y.numpy()[~kept[:, :S]].any()


# ---------------------------------------------------------------------------
# moe_block, both branches
# ---------------------------------------------------------------------------


def _paired_moe(p: dict, rounding: float, mode: str, block_n: int) -> dict:
    """One layer's MoE values with the JAX package's expert pairing."""
    fake = {"segments": [{"moe": {k: v[None] for k, v in p.items()}}]}
    out, _ = j_transform.pair_params(fake, rounding, mode=mode, block_n=block_n,
                                     leaves=(("moe", "w_gate"), ("moe", "w_up"),
                                             ("moe", "w_down")))
    return {k: (v[0] if not isinstance(v, dict) else {mk: mv[0] for mk, mv in v.items()})
            for k, v in out["segments"][0]["moe"].items()}


@pytest.mark.parametrize("gemm", ["xla", "pallas_paired"])
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("S", [1, 4, 24])  # T·K = 4 and 16 (dense: ≤ 2E = 16), 96
def test_moe_block_matches_jax(S, capacity, gemm):
    jcfg, tcfg = _cfgs(capacity)
    B = 2
    p = _moe_values()
    if gemm == "pallas_paired":
        p = _paired_moe(p, 0.0, "structured", 0)
    x = _x(B, S, jcfg.d_model)
    jp = jax.tree.map(jnp.asarray, p)
    with j_ops.pallas_paired_gemm(interpret=True) if gemm == "pallas_paired" else \
            contextlib.nullcontext():
        want_y, want_aux = JL.moe_block(jcfg, jp, jnp.asarray(x))
    got_y, got_aux = TL.moe_block(tcfg, _port_moe(p), torch.as_tensor(x),
                                  TM.PerfKnobs(gemm=gemm))
    assert got_y.shape == (B, S, jcfg.d_model) and got_y.dtype == torch.float32
    assert rel_err(got_y, want_y) <= RTOL
    dense = B * S * jcfg.moe.top_k <= 2 * jcfg.moe.n_experts
    if dense:
        assert float(got_aux) == float(want_aux) == 0.0
    else:
        assert abs(float(got_aux) - float(want_aux)) <= RTOL * abs(float(want_aux))
        assert float(got_aux) > 0


def test_moe_block_paired_r0_equals_unpaired():
    """At r=0 the paired expert path computes x @ W: the same values as the
    unpaired one (to fp32 rounding), on both branches."""
    _, tcfg = _cfgs()
    p = _paired_moe(_moe_values(), 0.0, "column_blocked", 3)
    blk = _port_moe(p)
    for S in (1, 24):
        x = torch.as_tensor(_x(2, S, tcfg.d_model, seed=S))
        plain, _ = TL.moe_block(tcfg, blk, x, TM.PerfKnobs())
        paired, _ = TL.moe_block(tcfg, blk, x, TM.PerfKnobs(gemm="pallas_paired",
                                                              pair_block_n=3))
        assert rel_err(paired, plain) <= RTOL


# ---------------------------------------------------------------------------
# the expert-grid GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_expert_dense_matches_jax_and_fold(mode, block_n, per_expert):
    p = _paired_moe(_moe_values(scale=0.3), 0.05, mode, block_n)
    name = "w_down" if per_expert else "w_gate"
    w, meta = p[name], p[name + "_pairing"]
    assert meta["pair_mask"].sum() > 0
    E, K, n_ff = w.shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=(E, 5, K) if per_expert else (5, K)).astype(np.float32)
    want = j_ops.fused_paired_expert_dense(
        jnp.asarray(x), jnp.asarray(w), jax.tree.map(jnp.asarray, meta), activation="silu",
        x_per_expert=per_expert, pair_block_n=block_n, interpret=True)
    tmeta = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in meta.items()}
    tw = torch.as_tensor(w)
    seg = ops.lm_expert_segments(tw, tmeta, block_n)
    assert seg.n_experts == E and seg.n_cols == E * n_ff
    got = ops.expert_dense(torch.as_tensor(x), seg, activation="silu", x_per_expert=per_expert)
    assert got.shape == (5, E, n_ff)
    assert rel_err(got, want) <= RTOL
    # the fold: both packages' equal, and the einsum on it
    folded = ops.fold_lm_expert_weight(tw, tmeta, block_n)
    j_folded = j_ops.fold_lm_expert_weight(jnp.asarray(w), jax.tree.map(jnp.asarray, meta),
                                           block_n)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(j_folded))
    eq = "etk,ekf->tef" if per_expert else "tk,ekf->tef"
    oracle = torch.nn.functional.silu(torch.einsum(eq, torch.as_tensor(x), folded))
    assert rel_err(got, oracle) <= RTOL


def test_expert_segments_check_block_n():
    p = _paired_moe(_moe_values(), 0.0, "column_blocked", 3)
    meta = {k: torch.as_tensor(v) for k, v in p["w_up_pairing"].items()}
    with pytest.raises(ValueError, match="pair_block_n"):
        ops.lm_expert_segments(torch.as_tensor(p["w_up"]), meta, 4)


# ---------------------------------------------------------------------------
# pairing metadata and reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_pair_params_equal(mode, block_n, rounding):
    values = _values(0.3)
    _, tcfg = _cfgs()
    ref, ref_report = j_transform.pair_params(values, rounding, mode=mode, block_n=block_n,
                                              leaves=tcfg.paired_leaves)
    model = TM.lm_params_from_numpy(values, tcfg, device="cpu")
    paired, report = pair_params(model, rounding, mode=mode, block_n=block_n,
                                 leaves=tcfg.paired_leaves)
    seg = ref["segments"][0]
    for sub, name in tcfg.paired_leaves:
        want = seg[sub][name + "_pairing"]
        for l, layer in enumerate(paired.layers):
            got = getattr(layer, sub).pairing[name]
            assert sorted(got) == sorted(want)
            for key, arr in want.items():
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                              err_msg=f"{sub}.{name}[{l}].{key}")
    assert len(report.leaves) == len(ref_report.leaves) == 7
    for a, b in zip(report.leaves, ref_report.leaves, strict=True):
        assert (a.path, a.shape, a.n_weights, a.n_pairs) == (b.path, b.shape, b.n_weights,
                                                            b.n_pairs)
        assert a.pair_fraction == b.pair_fraction
    assert report.savings() == ref_report.savings()
    experts = [leaf for leaf in report.leaves if ".moe." in leaf.path]
    assert [leaf.shape for leaf in experts][0] == (2, 8, 64, 96)
    if rounding:
        assert all(leaf.n_pairs > 0 for leaf in experts)
    # the default leaves (no list) find the same weights
    _, default = pair_params(model, rounding, mode=mode, block_n=block_n)
    assert [leaf.path for leaf in default.leaves] == [leaf.path for leaf in report.leaves]


# ---------------------------------------------------------------------------
# forward and engine
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ, CHUNK = 11, 24, 4
POS = [(PROMPT, 6), (PROMPT + 1, 7)]
STEP_TOKENS = [(3, 200), (17, 42)]


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(2, PROMPT)).astype(np.int32)


def _jax_run(jcfg, vals, knobs):
    params = jax.tree.map(jnp.asarray, vals)
    with j_ops.perf_context(knobs):
        logits, pre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, knobs=knobs))(
            params, jnp.asarray(_tokens(jcfg.vocab)))
        decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
        cache = unzip(JM.init_cache(jcfg, 2, MAX_SEQ))[0]
        seg = {k: v.at[:, :, :PROMPT].set(pre["segments"][0][k])
               for k, v in cache["segments"][0].items()}
        cache = {"segments": [seg]}
        out = [np.asarray(logits)]
        for pos, tok in zip(POS, STEP_TOKENS, strict=True):
            logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                                   jnp.asarray(pos, jnp.int32))
            out.append(np.asarray(logits))
    return out


def _port_run(tcfg, model, knobs):
    logits, pre = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                             knobs=knobs)
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    for name in ("k", "v"):
        cache[name][:, :, :PROMPT] = pre[name]
    out = [logits]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        out.append(logits)
    return out


@pytest.mark.parametrize("capacity", CAPACITY)
def test_forward_r0_matches_jax(capacity):
    """Prefill of 2 × 11 tokens (the routed branch) and two decode steps
    (the dense one) at r=0: the port's plain and paired paths (with fused
    decode attention) against the JAX package's plain path."""
    jcfg, tcfg = _cfgs(capacity)
    vals = _values()
    want = _jax_run(jcfg, vals, JM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, remat="none"))
    model = TM.lm_params_from_numpy(vals, tcfg, device="cpu")
    assert model.lm_head is not None and not tcfg.tie_embeddings
    paired, _ = pair_params(model, 0.0)
    for m, gemm, attn in ((model, "xla", "xla"), (paired, "pallas_paired", "pallas_fused")):
        knobs = TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, gemm=gemm, attn=attn)
        got = _port_run(tcfg, m, knobs)
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert rel_err(g, w) <= RTOL


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(5,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(11,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(rounding: float, capacity: float):
    jcfg, _ = _cfgs(capacity)
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(0.3 if rounding else 1.0), max_seq=32, batch_size=2,
                    knobs=JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm=gemm,
                                       pair_rounding=rounding))
    return eng.generate(_prompts(jcfg.vocab), 6), eng.last_logits


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("rounding,attn", [(0.0, "xla"), (0.0, "pallas_fused"),
                                           (0.05, "pallas_fused")])
def test_engine_tokens_match_jax_engine(rounding, attn, capacity):
    """Prompts of 5 tokens (dense branch) and 11 (routed), 6 tokens each;
    the JAX engine plain at r=0 and paired at r=0.05 (structured)."""
    want, want_logits = _jax_engine_tokens(rounding, capacity)
    _, tcfg = _cfgs(capacity)
    model = TM.lm_params_from_numpy(_values(0.3 if rounding else 1.0), tcfg, device="cpu")
    knobs = TM.PerfKnobs(q_chunk=16, k_chunk=16, gemm="pallas_paired", attn=attn,
                         pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=32, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


def test_routed_prefills_are_counted():
    """``analysis.counting`` counts the routed dispatches of a prefill: one
    a layer for a prompt past ``2E / K`` tokens, none below it."""
    from repro_torch.analysis import counting

    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    for n, routed in ((8, 0), (9, tcfg.n_layers)):
        with counting(moe_routes=(TL._moe_route,)) as counts:
            TM.prefill(tcfg, model, torch.zeros((1, n), dtype=torch.int64))
        assert counts["moe_routes"] == routed
        assert counts["k1_calls"] == 0  # the unpaired path calls no K1 wrapper


def test_decode_launch_counts():
    """The launches one decode layer makes, by kind and schedule: an MoE
    layer's three QKV projections, one fused attention, three expert
    projections, whatever the expert count."""
    _, tcfg = _cfgs()
    q = t_configs.get_smoke_config("qwen2-1.5b")
    k = lambda **kw: TM.PerfKnobs(**kw)
    paired_fused = k(gemm="pallas_paired", attn="pallas_fused")
    assert analysis.decode_launches(tcfg, "moe", paired_fused) == {
        "paired_matmul": 6, "decode_attention": 1, "flash_attention": 0}
    assert analysis.decode_launches(q, "dense", paired_fused) == {
        "paired_matmul": 6, "decode_attention": 1, "flash_attention": 0}
    # column-blocked metadata whose blocks tile q, k and v: one QKV launch
    assert analysis.decode_launches(q, "dense", k(gemm="pallas_paired", attn="pallas_fused",
                                                  pair_block_n=16))["paired_matmul"] == 4
    assert analysis.decode_launches(q, "dense", k(gemm="pallas_paired", attn="pallas_fused",
                                                  pair_block_n=48))["paired_matmul"] == 6
    assert analysis.decode_launches(tcfg, "moe", k(gemm="pallas_paired")) == {
        "paired_matmul": 7, "decode_attention": 0, "flash_attention": 0}
    assert analysis.decode_launches(tcfg, "moe", k(attn="pallas_fused")) == {
        "paired_matmul": 0, "decode_attention": 1, "flash_attention": 0}
