"""The port's hybrid family (hymba-1.5b: attention beside SSM heads in every
layer, meta tokens as the sinks of a sliding window) against the JAX
package's, in fp32.

Both packages compute from the same numpy inputs: the JAX package's seeded
hymba smoke init (3 layers: full, sliding-window, full; d=64, 4 heads over
2 KV heads, window 16, 8 meta tokens, SSM chunk 16), handed to the port
through ``lm_params_from_numpy`` with random norm scales (the hybrid
layers' two output norms too).  The prompts are long enough that the window
drops keys and the meta tokens stay attended as sinks, in the prefill and in
the decode.  The JAX package's Pallas GEMMs run in interpret mode.

* the config: fields, the five segments of hymba-1.5b, layer kinds,
  windows, parameter counts and paired leaves;
* ``lm_forward`` (logits without the meta positions) and the prefill's
  cache (K/V over meta + prompt positions, the SSM state and conv tails)
  within 1e-5, and that the window and the sinks change them;
* two decode steps past the window, every attention and GEMM schedule,
  within 1e-5, the cache too;
* the pairing metadata of all 13 leaves a layer over the three smoke
  segments, index for index, and the ``LeafReport``s;
* the serving engine's tokens against the JAX package's at r=0 and r=0.05;
* the decode launches of each layer kind, counted, and the engine's splice,
  release and scrub of both kinds of cache entry; the CLI.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import transform as j_transform
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.core.transform import pair_params
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as TM
from repro_torch.serving.engine import ServeEngine

RTOL = 1e-5
ARCH = "hymba-1.5b"
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]
LEAVES = 13  # 4 attention, 3 MLP and 6 SSM projections a layer


def _cfgs():
    """(JAX, port) hymba smoke configs in fp32."""
    return (dataclasses.replace(j_configs.get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(t_configs.get_smoke_config(ARCH), dtype="float32"))


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
        norms += [seg[n] for n in ("ln1", "ln2", "ln_attn_out", "ln_ssm_out")]
    for norm in norms:
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return vals


def _model(scale: float = 1.0):
    _, tcfg = _cfgs()
    return tcfg, TM.lm_params_from_numpy(_values(scale), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "ssm":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert port.segments() == ref.segments()
    kinds = [port.layer_kind(i) for i in range(port.n_layers)]
    assert kinds == [ref.layer_kind(i) for i in range(ref.n_layers)]
    assert [TM._window_for(port, k) for k in kinds] == [JM._window_for(ref, k) for k in kinds]
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    if get == "get_config":
        assert port.segments() == (("hybrid_full", 1), ("hybrid_swa", 14), ("hybrid_full", 1),
                                   ("hybrid_swa", 15), ("hybrid_full", 1))
        assert port.param_count() == 1_588_942_400
        assert (port.head_dim, port.meta_tokens, port.sliding_window) == (64, 128, 1024)
    else:
        assert port.segments() == (("hybrid_full", 1), ("hybrid_swa", 1), ("hybrid_full", 1))
    assert t_base.default_paired_leaves(ssm=True) == j_configs.base.default_paired_leaves(ssm=True)


def test_window_for_every_kind():
    """The sliding window on hybrid_swa layers (and dense/MoE ones of a
    windowed config), none on hybrid_full and SSM layers."""
    _, tcfg = _cfgs()
    want = {"hybrid_swa": 16, "hybrid_full": 0, "ssm": 0, "dense": 16, "moe": 16}
    assert {k: TM._window_for(tcfg, k) for k in want} == want


# ---------------------------------------------------------------------------
# forward and prefill
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ = 30, 40  # 8 meta + 30 tokens: the window of 16 drops keys 8…21
POS = [(PROMPT, PROMPT - 7), (PROMPT + 1, PROMPT - 6)]
STEP_TOKENS = [(3, 200), (17, 42)]


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(2, PROMPT)).astype(np.int32)


@functools.cache
def _jax_forward():
    """The JAX package's forward logits, prefill logits, two decode steps'
    logits and the prefill's and final caches (layers concatenated)."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _values())
    knobs = JM.PerfKnobs(q_chunk=8, k_chunk=8, remat="none")
    tokens = jnp.asarray(_tokens(jcfg.vocab))
    full, _, _ = jax.jit(lambda p, t: JM.lm_forward(jcfg, p, {"tokens": t}, knobs=knobs))(
        params, tokens)
    logits, pre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, knobs=knobs))(
        params, tokens)
    cat = lambda c: {k: np.concatenate([np.asarray(s[k]) for s in c["segments"]])
                     for k in c["segments"][0]}
    pre_cat = cat(pre)
    cache = unzip(JM.init_cache(jcfg, 2, MAX_SEQ))[0]
    S = jcfg.meta_tokens + PROMPT
    cache = {"segments": [{k: v.at[:, :, :S].set(p[k]) if k in ("k", "v") else p[k]
                           for k, v in seg.items()}
                          for seg, p in zip(cache["segments"], pre["segments"], strict=True)]}
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
    out = [np.asarray(logits)]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    return np.asarray(full), pre_cat, out, cat(cache)


@pytest.mark.parametrize("gemm", ["xla", "pallas_paired"])
def test_lm_forward_and_prefill_cache_match_jax(gemm):
    want, want_cache, _, _ = _jax_forward()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(q_chunk=8, k_chunk=8, gemm=gemm)
    got, cache = TM.lm_forward(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                               knobs=knobs, collect_cache=True)
    assert got.shape == want.shape == (2, PROMPT, TM.padded_vocab(tcfg))
    assert rel_err(got, want) <= RTOL
    assert sorted(cache) == sorted(want_cache) == ["conv_B", "conv_C", "conv_x", "h", "k", "v"]
    assert cache["k"].shape == (3, 2, tcfg.meta_tokens + PROMPT, 2, 16)
    for name, t in cache.items():
        assert t.shape == want_cache[name].shape, name
        assert rel_err(t, want_cache[name]) <= RTOL, name


@pytest.mark.parametrize("drop", ["window", "n_sink"])
def test_window_and_sinks_mask_keys(drop, monkeypatch):
    """With the window or its sinks dropped from the attention (prefill and
    decode), the prefill's logits and a decode step's move: the prompt is
    long enough that both decide which keys are attended."""
    _, _, want, _ = _jax_forward()
    tcfg, model = _model()
    for name in ("attention_block", "attention_decode_block"):
        real = getattr(TM, name)

        def dropped(*args, _real=real, **kw):
            return _real(*args, **{**kw, drop: 0})

        monkeypatch.setattr(TM, name, dropped)
    knobs = TM.PerfKnobs(q_chunk=8, k_chunk=8)
    logits, cache = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                               knobs=knobs)
    assert rel_err(logits, want[0]) > 1e-3
    full = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    for name, t in full.items():
        if name in TM.SSM_ENTRIES:
            t.copy_(cache[name])
        else:
            t[:, :, : cache[name].shape[2]] = cache[name]
    step, _ = TM.decode_step(tcfg, model, full, torch.tensor(STEP_TOKENS[0])[:, None],
                             torch.tensor(POS[0], dtype=torch.int32), knobs=knobs)
    assert rel_err(step, want[1]) > 1e-3


@pytest.mark.parametrize("gemm,attn,block_n", [
    ("xla", "xla", 0), ("xla", "pallas_fused", 0), ("pallas_paired", "xla", 0),
    ("pallas_paired", "pallas_fused", 0), ("pallas_paired", "pallas_fused", 16)])
def test_decode_matches_jax(gemm, attn, block_n):
    """Prefill of 2 × 30 tokens, two decode steps at positions 30/31 (slot
    0: its window drops keys 8…22) and 23/24 (slot 1): logits and every
    cache entry at r=0, through the plain and the fused decode attention."""
    _, _, want, want_cache = _jax_forward()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                               block_n=block_n)
    knobs = TM.PerfKnobs(q_chunk=8, k_chunk=8, gemm=gemm, attn=attn, pair_block_n=block_n)
    logits, pre = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                             knobs=knobs)
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert cache["k"].shape[2] == MAX_SEQ + tcfg.meta_tokens
    for name, t in cache.items():
        if name in TM.SSM_ENTRIES:
            t.copy_(pre[name])
        else:
            t[:, :, : pre[name].shape[2]] = pre[name]
    got = [logits]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        assert rel_err(g, w) <= RTOL
    for name, t in cache.items():
        assert rel_err(t, want_cache[name]) <= RTOL, name


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
    """All 13 leaves of each of the three one-layer segments, each segment
    padded to its own (Pmax, Rmax)."""
    values = _values(0.3)
    tcfg, model = _model(0.3)
    assert len(tcfg.paired_leaves) == LEAVES
    for leaves in (tcfg.paired_leaves, None):
        ref, ref_report = j_transform.pair_params(values, rounding, mode=mode, block_n=block_n,
                                                  leaves=leaves)
        paired, report = pair_params(model, rounding, mode=mode, block_n=block_n,
                                     leaves=leaves)
        n_checked = 0
        for l, seg in enumerate(ref["segments"]):  # one layer a segment
            for sub, name in tcfg.paired_leaves:
                want = j_transform._resolve_sub(seg, sub)[name + "_pairing"]
                got = _block_at(paired.layers[l], sub).pairing[name]
                assert sorted(got) == sorted(want)
                for key, arr in want.items():
                    np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[0],
                                                  err_msg=f"{sub}.{name}[{l}].{key}")
                n_checked += 1
        assert n_checked == 3 * LEAVES
        assert len(report.leaves) == len(ref_report.leaves) == 3 * LEAVES
        for a, b in zip(report.leaves, ref_report.leaves, strict=True):
            assert (a.path, a.shape, a.n_weights, a.n_pairs) == (
                b.path, b.shape, b.n_weights, b.n_pairs)
            assert a.pair_fraction == b.pair_fraction
        assert report.savings() == ref_report.savings()
    if rounding:
        assert all(leaf.n_pairs > 0 for leaf in report.leaves if ".mamba." in leaf.path)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(5,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(PROMPT,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(rounding: float):
    jcfg, _ = _cfgs()
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(0.3 if rounding else 1.0), max_seq=MAX_SEQ, batch_size=2,
                    knobs=JM.PerfKnobs(q_chunk=8, k_chunk=8, remat="none", gemm=gemm,
                                       pair_rounding=rounding))
    return eng.generate(_prompts(jcfg.vocab), 6), eng.last_logits


@pytest.mark.parametrize("rounding,gemm,attn", [
    (0.0, "xla", "xla"), (0.0, "pallas_paired", "pallas_fused"),
    (0.05, "pallas_paired", "xla"), (0.05, "pallas_paired", "pallas_fused")])
def test_engine_tokens_match_jax_engine(rounding, gemm, attn):
    """Prompts of 5 tokens and 30 (the window drops keys from its prefill
    on), 6 tokens each; the JAX engine plain at r=0 and paired at r=0.05
    (structured), both with its plain decode attention."""
    want, want_logits = _jax_engine_tokens(rounding)
    tcfg, model = _model(0.3 if rounding else 1.0)
    knobs = TM.PerfKnobs(q_chunk=8, k_chunk=8, gemm=gemm, attn=attn, pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


@pytest.mark.parametrize("attn,block_n,want_k1,want_k2", [
    ("xla", 0, 13, 0), ("pallas_fused", 0, 12, 1), ("pallas_fused", 16, 10, 1)])
def test_decode_launch_counts(attn, block_n, want_k1, want_k2):
    """K1 and K2 calls of one decode step, counted on the CPU, against
    ``decode_launches`` for both hybrid kinds: the three QKV projections
    (one under the fused attention with column blocks tiling q, k and v),
    the out-projection unless K2 fuses it, the MLP's three and the SSM
    block's six."""
    tcfg, model = _model()
    mode = "column_blocked" if block_n else "structured"
    paired, _ = pair_params(model, 0.0, mode=mode, block_n=block_n)
    knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn, pair_block_n=block_n)
    for kind in ("hybrid_full", "hybrid_swa"):
        assert analysis.decode_launches(tcfg, kind, knobs) == {
            "paired_matmul": want_k1, "decode_attention": want_k2, "flash_attention": 0}
    with analysis.counting(k2_calls=(da.fused_decode_attention_cuda,)) as counts:
        TM.decode_step(tcfg, paired, TM.init_cache(tcfg, 2, 8, device="cpu"),
                       torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                       knobs=knobs)
    assert counts["k1_calls"] == want_k1 * tcfg.n_layers
    assert counts["k2_calls"] == want_k2 * tcfg.n_layers
    unpaired = analysis.decode_launches(tcfg, "hybrid_swa", TM.PerfKnobs(attn=attn))
    assert unpaired == {"paired_matmul": 0, "decode_attention": want_k2, "flash_attention": 0}


def test_engine_splices_releases_and_scrubs_both_caches():
    """A prefill's K/V land over meta + prompt positions of its slot, its
    SSM state whole; release zeroes the slot's rows of every entry."""
    tcfg, model = _model()
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2,
                      knobs=TM.PerfKnobs(q_chunk=8, k_chunk=8))
    prompt = _prompts(tcfg.vocab)[0]
    eng.add_request(1, prompt)
    _, want = TM.prefill(tcfg, eng.model, torch.as_tensor(prompt)[None].long(),
                         knobs=eng.knobs)
    S = tcfg.meta_tokens + len(prompt)
    for name, t in eng.cache.items():
        if name in TM.SSM_ENTRIES:
            assert torch.equal(t[:, 1], want[name][:, 0]), name
        else:
            assert torch.equal(t[:, 1, :S], want[name][:, 0]) and not t[:, 1, S:].any(), name
        assert not t[:, 0].any(), name
    eng.step()
    assert eng.cache["k"][:, 1, S].any()  # the decode wrote meta + plen
    eng.release_slot(1)
    assert not any(t[:, 1].any() for t in eng.cache.values())


def test_init_lm_builds_hybrid_layers():
    tcfg, _ = _model()
    model = TM.init_lm(tcfg, 0, device="cpu")
    assert tuple(model.meta.shape) == (tcfg.meta_tokens, tcfg.d_model)
    for layer in model.layers:
        assert sorted(n for n, _ in layer.named_children()) == sorted(
            ["ln1", "attn", "mamba", "ln_attn_out", "ln_ssm_out", "ln2", "mlp"])
        assert layer.ffn == "mlp"
    want = _values()
    assert tuple(model.meta.shape) == want["meta"].shape
    frozen = model.copy(frozen=True)
    assert frozen.meta is model.meta and frozen.layers[1].mamba.w_z is model.layers[1].mamba.w_z


def test_cli_serves_hymba_smoke(capsys):
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--attn", "pallas_fused", "--pair-rounding", "0.05", "--steps", "4",
                  "--max-seq", "64", "--prompt-lens", "5,30"])
    out = capsys.readouterr().out
    assert "paired-kernel LM path (structured" in out
    assert f"across {3 * LEAVES} decoder weights" in out
    assert "slot 1: prompt 30 toks" in out and "8 tokens in" in out
