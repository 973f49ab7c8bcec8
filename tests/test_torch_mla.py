"""The port's deepseek-v2-lite-16b family (MLA, shared experts, a dense first
layer) against the JAX package's, in fp32.

Both packages compute from the same numpy inputs: the JAX package's seeded
deepseek smoke init (3 layers: one dense, two MoE; d=64, 4 heads, kv_lora 32,
8 experts top-2 beside 1 shared), handed to the port through
``lm_params_from_numpy``, with random norm scales (``kv_norm`` too), and
random activations.  The JAX package's Pallas GEMMs run in interpret mode.

* the config: fields, segments, layer kinds and parameter counts at full and
  smoke size;
* ``mla_block`` (prefill), ``mla_decode_block`` (the absorbed-matrix decode,
  the cache written at a different position in each slot) and
  ``_mla_with_cache``, unpaired and paired at r=0, within 1e-5 (the cache
  within 1e-6);
* ``moe_block`` with shared experts on the dense and the routed branch,
  unpaired and paired at r=0, within 1e-5;
* the pairing metadata and ``LeafReport``s equal to the JAX package's for
  every leaf (MLA's down-projections, the dense layer's MLP, the experts,
  the nested shared experts) at r ∈ {0, 0.05}, structured and
  column-blocked at bn ∈ {1, 3} (matrices scaled by 0.3 so that r=0.05
  pairs lanes);
* prefill and two decode steps at r=0, and the serving engine's tokens at
  r=0 and r=0.05, equal to the JAX package's;
* the decode launches a layer makes, the latent cache's release and scrub,
  holding the paired weights in the compute dtype, and the CLI.
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
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import poison_slot_cache

RTOL = 1e-5
ARCH = "deepseek-v2-lite-16b"
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]
GEMMS = ["xla", "pallas_paired"]
ATTN_LEAVES = (("attn", "wq"), ("attn", "w_dkv"), ("attn", "w_kr"), ("attn", "wo"))
MOE_LEAVES = tuple(("moe", n) for n in ("w_gate", "w_up", "w_down")) + tuple(
    ("moe.shared", n) for n in ("w_gate", "w_up", "w_down"))


def _cfgs(dtype: str = "float32"):
    """(JAX, port) deepseek smoke configs in ``dtype``."""
    return (dataclasses.replace(j_configs.get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(t_configs.get_smoke_config(ARCH), dtype=dtype))


def _scale_weights(tree: dict, scale: float) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            _scale_weights(v, scale)
        elif name.startswith("w"):
            tree[name] = v * np.float32(scale)


@functools.cache
def _values(scale: float = 1.0):
    """The JAX smoke init as numpy, its decoder matrices times ``scale``,
    with random norm scales."""
    cfg, _ = _cfgs()
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    norms = [vals["final_norm"]]
    for seg in vals["segments"]:
        _scale_weights(seg, scale)
        norms += [seg["ln1"], seg["ln2"]]
        seg["attn"]["kv_norm"] = (1 + 0.1 * rng.normal(size=seg["attn"]["kv_norm"].shape)
                                  ).astype(np.float32)
    for norm in norms:
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return vals


def _layer(seg: int, sub: str, layer: int = 0, scale: float = 1.0) -> dict:
    return jax.tree.map(lambda a: a[layer], _values(scale)["segments"][seg][sub])


def _paired(sub: str, p: dict, leaves, rounding: float = 0.0, mode="structured",
            block_n: int = 0) -> dict:
    """One layer's values of block ``sub`` with the JAX package's pairing."""
    fake = {"segments": [{sub: jax.tree.map(lambda a: a[None], p)}]}
    out, _ = j_transform.pair_params(fake, rounding, mode=mode, block_n=block_n, leaves=leaves)
    return jax.tree.map(lambda a: a[0], out["segments"][0][sub])


def _port_block(cls, p: dict):
    """The port's block over numpy values (``<name>_pairing`` siblings as its
    metadata, a nested ``shared`` dict as its shared experts)."""
    t = lambda a: torch.as_tensor(np.array(a)).long() if np.asarray(a).dtype.kind == "i" \
        else torch.as_tensor(np.array(a))
    pairing = {k[:-len("_pairing")]: {mk: t(mv) for mk, mv in v.items()}
               for k, v in p.items() if k.endswith("_pairing")}
    kids = {"shared": _port_block(TL.MLP, p["shared"])} if "shared" in p else {}
    return cls(pairing=pairing, **kids, **{k: t(v) for k, v in p.items()
                                         if not k.endswith("_pairing") and k != "shared"})


def _x(*shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_policy(gemm: str):
    return j_ops.pallas_paired_gemm(interpret=True) if gemm == "pallas_paired" else \
        contextlib.nullcontext()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in ("mla", "moe"):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert port.head_dim == ref.head_dim and port.segments() == ref.segments()
    assert [port.layer_kind(i) for i in range(port.n_layers)] == [
        ref.layer_kind(i) for i in range(ref.n_layers)]
    assert port.layer_kind(0) == "dense" and port.layer_kind(1) == "moe"
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    if get == "get_config":
        assert port.segments() == (("dense", 1), ("moe", 26))
        assert port.param_count() == 15_706_357_760 and not port.tie_embeddings
    assert TM.padded_vocab(port) == JM.padded_vocab(ref)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_values(gemm: str) -> dict:
    p = _layer(1, "attn")
    return _paired("attn", p, ATTN_LEAVES) if gemm == "pallas_paired" else p


@pytest.mark.parametrize("gemm", GEMMS)
@pytest.mark.parametrize("S", [1, 9])
def test_mla_block_matches_jax(S, gemm):
    jcfg, tcfg = _cfgs()
    p = _mla_values(gemm)
    B = 2
    x = _x(B, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    with _jax_policy(gemm):
        want = JL.mla_block(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jnp.asarray(pos), q_chunk=4, k_chunk=4)
    knobs = TM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm)
    got, c_kv, k_rope = TL.mla_block(tcfg, _port_block(TL.MLA, p), torch.as_tensor(x),
                                     torch.as_tensor(pos).long(), knobs)
    assert got.shape == (B, S, jcfg.d_model) and got.dtype == torch.float32
    assert rel_err(got, want) <= RTOL
    m = tcfg.mla
    assert c_kv.shape == (B, S, m.kv_lora_rank) and k_rope.shape == (B, S, m.qk_rope_dim)


@pytest.mark.parametrize("gemm", GEMMS)
def test_mla_with_cache_matches_jax(gemm):
    jcfg, tcfg = _cfgs()
    p = _mla_values(gemm)
    x = _x(2, 11, jcfg.d_model, seed=5)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    with _jax_policy(gemm):
        want_y, want_c = JM._mla_with_cache(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                            jnp.asarray(pos),
                                            JM.PerfKnobs(q_chunk=4, k_chunk=4, remat="none"))
    got_y, got_c = TM._mla_with_cache(tcfg, _port_block(TL.MLA, p), torch.as_tensor(x),
                                      torch.as_tensor(pos).long(),
                                      TM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm))
    assert rel_err(got_y, want_y) <= RTOL
    assert sorted(got_c) == sorted(want_c) == ["c_kv", "k_rope"]
    for name in got_c:
        assert got_c[name].shape == want_c[name].shape
        assert rel_err(got_c[name], want_c[name]) <= 1e-6, name


@pytest.mark.parametrize("gemm", GEMMS)
def test_mla_decode_block_matches_jax(gemm):
    """Three slots at positions 0, 5 and 11 of a 12-row cache whose rows hold
    random latents: the new row written at each slot's own position, the
    rows past it masked."""
    jcfg, tcfg = _cfgs()
    p = _mla_values(gemm)
    m, B, S = tcfg.mla, 3, 12
    x = _x(B, 1, jcfg.d_model, seed=7)
    cache = {"c_kv": _x(B, S, m.kv_lora_rank, seed=8), "k_rope": _x(B, S, m.qk_rope_dim, seed=9)}
    pos = np.array([0, 5, 11], np.int32)
    with _jax_policy(gemm):
        want_y, want_c = JL.mla_decode_block(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                             jax.tree.map(jnp.asarray, cache), jnp.asarray(pos))
    tcache = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    got_y, got_c = TL.mla_decode_block(tcfg, _port_block(TL.MLA, p), torch.as_tensor(x), tcache,
                                       torch.as_tensor(pos).long(), TM.PerfKnobs(gemm=gemm))
    assert got_c is tcache  # written in place
    assert got_y.shape == (B, 1, jcfg.d_model)
    assert rel_err(got_y, want_y) <= RTOL
    for name, t in got_c.items():
        assert rel_err(t, want_c[name]) <= 1e-6, name
        changed = (t.numpy() != cache[name]).any(-1)
        assert (np.flatnonzero(changed.ravel()) == np.arange(B) * S + pos).all(), name


# ---------------------------------------------------------------------------
# moe_block with shared experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gemm", GEMMS)
@pytest.mark.parametrize("S", [1, 4, 24])  # T·K = 4 and 16 (dense: ≤ 2E = 16), 96
def test_moe_block_with_shared_experts_matches_jax(S, gemm):
    jcfg, tcfg = _cfgs()
    p = _layer(1, "moe", layer=1)
    if gemm == "pallas_paired":
        p = _paired("moe", p, MOE_LEAVES)
    x = _x(2, S, jcfg.d_model)
    with _jax_policy(gemm):
        want_y, want_aux = JL.moe_block(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    blk = _port_block(TL.MoE, p)
    assert isinstance(blk.shared, TL.MLP)
    if gemm == "pallas_paired":
        assert sorted(blk.shared.pairing) == ["w_down", "w_gate", "w_up"]
    got_y, got_aux = TL.moe_block(tcfg, blk, torch.as_tensor(x), TM.PerfKnobs(gemm=gemm))
    assert got_y.shape == (2, S, jcfg.d_model) and got_y.dtype == torch.float32
    assert rel_err(got_y, want_y) <= RTOL
    assert abs(float(got_aux) - float(want_aux)) <= RTOL * max(abs(float(want_aux)), 1e-30)
    # the shared experts are part of the output
    no_shared = _port_block(TL.MoE, {k: v for k, v in p.items() if k != "shared"})
    routed, _ = TL.moe_block(tcfg, no_shared, torch.as_tensor(x), TM.PerfKnobs(gemm=gemm))
    assert rel_err(routed, want_y) > 1e-2


# ---------------------------------------------------------------------------
# pairing metadata and reports
# ---------------------------------------------------------------------------


def _block_at(layer, sub_path: str):
    for part in sub_path.split("."):
        layer = getattr(layer, part)
    return layer


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_pair_params_equal(mode, block_n, rounding):
    values = _values(0.3)
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(values, tcfg, device="cpu")
    for leaves in (tcfg.paired_leaves, None):
        ref, ref_report = j_transform.pair_params(values, rounding, mode=mode, block_n=block_n,
                                                  leaves=leaves)
        paired, report = pair_params(model, rounding, mode=mode, block_n=block_n,
                                     leaves=leaves)
        start, n_checked = 0, 0
        for (_, count), seg in zip(tcfg.segments(), ref["segments"], strict=True):
            for sub, name in tcfg.paired_leaves:
                want = j_transform._resolve_sub(seg, sub)
                if want is None:
                    continue
                want = want[name + "_pairing"]
                for l in range(count):
                    got = _block_at(paired.layers[start + l], sub).pairing[name]
                    assert sorted(got) == sorted(want)
                    for key, arr in want.items():
                        np.testing.assert_array_equal(
                            got[key].numpy(), np.asarray(arr)[l],
                            err_msg=f"{sub}.{name}[{start + l}].{key}")
                    n_checked += 1
            start += count
        assert n_checked == 7 + 10 * 2  # the dense layer's 7 leaves, each MoE layer's 10
        assert len(report.leaves) == len(ref_report.leaves) == 17
        for a, b in zip(report.leaves, ref_report.leaves, strict=True):
            assert (a.path, a.shape, a.n_weights, a.n_pairs) == (
                b.path, b.shape, b.n_weights, b.n_pairs)
            assert a.pair_fraction == b.pair_fraction
        assert report.savings() == ref_report.savings()
    paths = [leaf.path for leaf in report.leaves]
    for path in ("segments[0].attn.w_dkv", "segments[0].attn.w_kr", "segments[0].mlp.w_down",
                 "segments[1].moe.shared.w_gate", "segments[1].moe.w_down"):
        assert path in paths
    if rounding:
        assert all(leaf.n_pairs > 0 for leaf in report.leaves if ".moe." in leaf.path)


def test_copies_keep_the_shared_experts_pairing():
    """A frozen copy of a paired model (what the engine serves) shares the
    nested shared experts' weights and keeps their metadata."""
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    paired, _ = pair_params(model, 0.0, leaves=tcfg.paired_leaves)
    frozen = paired.copy(frozen=True)
    for l in (1, 2):
        sh, src = frozen.layers[l].moe.shared, paired.layers[l].moe.shared
        assert sh.frozen and frozen.layers[l].moe.frozen
        assert sh.w_up is src.w_up is model.layers[l].moe.shared.w_up
        assert sorted(sh.pairing) == ["w_down", "w_gate", "w_up"]
        assert sh.pairing["w_gate"] is src.pairing["w_gate"]
        assert not model.layers[l].moe.shared.pairing  # the source is left unpaired


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
        cache = {"segments": [{k: v.at[:, :, :PROMPT].set(pseg[k]) for k, v in seg.items()}
                              for seg, pseg in zip(cache["segments"], pre["segments"],
                                                   strict=True)]}
        out = [np.asarray(logits)]
        for pos, tok in zip(POS, STEP_TOKENS, strict=True):
            logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                                   jnp.asarray(pos, jnp.int32))
            out.append(np.asarray(logits))
    return out, cache


def _port_run(tcfg, model, knobs):
    logits, pre = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                             knobs=knobs)
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert sorted(cache) == sorted(pre) == ["c_kv", "k_rope"]
    for name in cache:
        cache[name][:, :, :PROMPT] = pre[name]
    out = [logits]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        out.append(logits)
    return out, cache


@functools.cache
def _jax_forward():
    jcfg, _ = _cfgs()
    return _jax_run(jcfg, _values(), JM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, remat="none"))


@pytest.mark.parametrize("gemm", GEMMS)
def test_forward_r0_matches_jax(gemm):
    """Prefill of 2 × 11 tokens (the routed expert branch) and two decode
    steps (the dense one) at r=0, the latent cache included: the port's
    plain and paired paths against the JAX package's plain path."""
    _, tcfg = _cfgs()
    want, want_cache = _jax_forward()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, gemm=gemm, attn="pallas_fused")
    got, cache = _port_run(tcfg, model, knobs)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert rel_err(g, w) <= RTOL
    for name, t in cache.items():
        w = np.concatenate([np.asarray(seg[name]) for seg in want_cache["segments"]])
        assert rel_err(t, w) <= 1e-6, name


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(5,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(11,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(rounding: float):
    jcfg, _ = _cfgs()
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(0.3 if rounding else 1.0), max_seq=32, batch_size=2,
                    knobs=JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm=gemm,
                                       pair_rounding=rounding))
    return eng.generate(_prompts(jcfg.vocab), 6), eng.last_logits


@pytest.mark.parametrize("rounding,gemm", [(0.0, "xla"), (0.0, "pallas_paired"),
                                           (0.05, "pallas_paired")])
def test_engine_tokens_match_jax_engine(rounding, gemm):
    """Prompts of 5 tokens (dense expert branch) and 11 (routed), 6 tokens
    each; the JAX engine plain at r=0 and paired at r=0.05 (structured)."""
    want, want_logits = _jax_engine_tokens(rounding)
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(0.3 if rounding else 1.0), tcfg, device="cpu")
    knobs = TM.PerfKnobs(q_chunk=16, k_chunk=16, gemm=gemm, attn="pallas_fused",
                         pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=32, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


def test_decode_launch_counts():
    """K1 calls of one decode step, counted by ``analysis.counting`` on the
    CPU: 7 for the dense layer (wq, w_dkv, w_kr, wo and the MLP's three), 10
    for each MoE layer (the same four, three expert-grid projections and the
    shared experts' three), as ``decode_launches`` says; MLA launches no K2
    under any ``attn``, and nothing unpaired."""
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    paired, _ = pair_params(model, 0.0)
    for attn in ("xla", "pallas_fused"):
        knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn)
        dense = analysis.decode_launches(tcfg, "dense", knobs)
        moe = analysis.decode_launches(tcfg, "moe", knobs)
        assert dense == {"paired_matmul": 7, "decode_attention": 0, "flash_attention": 0}
        assert moe == {"paired_matmul": 10, "decode_attention": 0, "flash_attention": 0}
        cache = TM.init_cache(tcfg, 2, 8, device="cpu")
        with analysis.counting() as counts:
            TM.decode_step(tcfg, paired, cache, torch.tensor([[3], [5]]),
                           torch.tensor([0, 2], dtype=torch.int32), knobs=knobs)
        want = sum(analysis.decode_launches(tcfg, tcfg.layer_kind(i), knobs)["paired_matmul"]
                   for i in range(tcfg.n_layers))
        assert counts["k1_calls"] == want == 7 + 2 * 10
    plain = TM.PerfKnobs(attn="pallas_fused")
    assert analysis.decode_launches(tcfg, "moe", plain) == {
        "paired_matmul": 0, "decode_attention": 0, "flash_attention": 0}
    with analysis.counting() as counts:
        TM.decode_step(tcfg, model, TM.init_cache(tcfg, 2, 8, device="cpu"),
                       torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                       knobs=plain)
    assert counts["k1_calls"] == 0


def test_release_and_poison_cover_the_latent_cache():
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    eng = ServeEngine(tcfg, model, max_seq=16, batch_size=2,
                      knobs=TM.PerfKnobs(q_chunk=8, k_chunk=8))
    prompts = _prompts(tcfg.vocab)
    for slot, p in prompts.items():
        eng.add_request(slot, p)
    eng.step()
    assert sorted(eng.cache) == ["c_kv", "k_rope"]
    for t in eng.cache.values():
        assert t[:, 0, : len(prompts[0]) + 1].abs().sum() > 0
    poison_slot_cache(eng, 1)
    for t in eng.cache.values():
        assert torch.isnan(t[:, 1, : int(eng.pos[1])]).all()
        assert not torch.isnan(t[:, 0]).any()
    eng.release_slot(1)
    eng.release_slot(0)
    for t in eng.cache.values():
        assert not t.any()


def test_hold_paired_in_compute_dtype_keeps_the_tokens():
    """A bf16 engine whose paired weights are held in bf16 gives the tokens
    and logits of one reading the fp32 masters, bit for bit; the router,
    norms and MLA's up-projections stay fp32."""
    _, tcfg = _cfgs("bfloat16")
    knobs = TM.PerfKnobs(q_chunk=16, k_chunk=16, gemm="pallas_paired", pair_rounding=0.05)
    runs = []
    for hold in (False, True):
        model = TM.lm_params_from_numpy(_values(0.3), tcfg, device="cpu")
        eng = ServeEngine(tcfg, model, max_seq=32, batch_size=2, knobs=knobs)
        if hold:
            TM.hold_paired_in_compute_dtype(tcfg, eng.model)
            held = {getattr(b, n).dtype for b in eng.model.modules()
                    for n in getattr(b, "pairing", {})}
            assert held == {torch.bfloat16}
            moe = model.layers[1].moe  # the source model shares the weights
            assert moe.w_gate.dtype == moe.shared.w_down.dtype == torch.bfloat16
            assert moe.router.dtype == model.layers[1].attn.w_uk.dtype == torch.float32
            assert model.layers[0].attn.wq.dtype == model.layers[0].mlp.w_down.dtype \
                == torch.bfloat16
        runs.append((eng.generate(_prompts(tcfg.vocab), 5), eng.last_logits))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_cli_serves_deepseek_smoke(capsys):
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--attn", "pallas_fused", "--pair-rounding", "0.05", "--steps", "4",
                  "--prompt-lens", "5,11"])
    out = capsys.readouterr().out
    assert "paired-kernel LM path (structured" in out and "across 17 decoder weights" in out
    assert "slot 1: prompt 11 toks" in out and "8 tokens in" in out
