"""The port's three remaining dense configs, qwen3-4b (per-head qk-norm),
granite-3-2b and mistral-large-123b (an ``lm_head`` of its own), against
the JAX package's, in fp32.

Both packages compute from the same numpy inputs: each JAX smoke init
with random norm scales (qwen3's qk-norm scales too), handed to the port
through ``lm_params_from_numpy``.  The JAX package's Pallas GEMMs run in
interpret mode.

* the configs, field for field, at both sizes;
* ``lm_forward`` and two decode steps within 1e-5 under every GEMM and
  attention schedule, the cache too;
* the engine's tokens against the JAX engine's at r=0 and r=0.05;
* the pairing metadata at r=0.05, index for index;
* the decode launches of a layer, counted; the CLI.
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
from repro_torch.core.transform import pair_params
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as TM
from repro_torch.serving.engine import ServeEngine

RTOL = 1e-5
ARCHS = ["qwen3-4b", "granite-3-2b", "mistral-large-123b"]
PROMPT, MAX_SEQ = 11, 20
KNOBS = dict(q_chunk=8, k_chunk=8)
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 4)]
# published widths: (layers, d_model, heads, kv heads, head dim, d_ff, vocab, tied)
PUBLISHED = {
    "qwen3-4b": (36, 2560, 32, 8, 128, 9728, 151936, True),
    "granite-3-2b": (40, 2048, 32, 8, 64, 8192, 49155, True),
    "mistral-large-123b": (88, 12288, 96, 8, 128, 28672, 32768, False),
}


def _cfgs(arch):
    return (dataclasses.replace(j_configs.get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(t_configs.get_smoke_config(arch), dtype="float32"))


@functools.cache
def _values(arch, scale: float = 1.0):
    """The JAX smoke init as numpy, random norm (and qk-norm) scales, the
    layer matrices times ``scale``."""
    cfg, _ = _cfgs(arch)
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    noisy = lambda a: (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    vals["final_norm"]["scale"] = noisy(vals["final_norm"]["scale"])
    for seg in vals["segments"]:
        for norm in ("ln1", "ln2"):
            seg[norm]["scale"] = noisy(seg[norm]["scale"])
        for sub in ("attn", "mlp"):
            for name, a in seg[sub].items():
                seg[sub][name] = (a * np.float32(scale)).astype(np.float32) if name.startswith(
                    "w") else noisy(a)
    return vals


def _model(arch, scale: float = 1.0):
    _, tcfg = _cfgs(arch)
    return tcfg, TM.lm_params_from_numpy(_values(arch, scale), tcfg, device="cpu")


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(2, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch, get):
    port, ref = getattr(t_configs, get)(arch), getattr(j_configs, get)(arch)
    assert {f.name for f in dataclasses.fields(ref)} == {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.head_dim == ref.head_dim and port.segments() == ref.segments()
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    assert TM.padded_vocab(port) == JM.padded_vocab(ref)
    if get == "get_config":
        got = (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads, port.head_dim,
               port.d_ff, port.vocab, port.tie_embeddings)
        assert got == PUBLISHED[arch]


@functools.cache
def _jax_forward(arch):
    """Forward logits, prefill logits, two decode steps' logits and the
    cache after them."""
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _values(arch))
    knobs = JM.PerfKnobs(**KNOBS, remat="none")
    batch = {"tokens": jnp.asarray(_tokens(jcfg.vocab))}
    full, _, _ = jax.jit(lambda p, b: JM.lm_forward(jcfg, p, b, knobs=knobs))(params, batch)
    logits, pre = jax.jit(lambda p, b: JM.prefill(jcfg, p, b, knobs=knobs))(params, batch)
    cache = unzip(JM.init_cache(jcfg, 2, MAX_SEQ))[0]
    cache = {"segments": [{k: v.at[:, :, :PROMPT].set(pre["segments"][0][k])
                           for k, v in cache["segments"][0].items()}]}
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
    out = [np.asarray(logits)]
    for pos, tok in (((PROMPT, PROMPT - 4), (3, 200)), ((PROMPT + 1, PROMPT - 3), (17, 42))):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    return np.asarray(full), out, {k: np.asarray(v) for k, v in cache["segments"][0].items()}


@pytest.mark.parametrize("gemm,attn,block_n", [
    ("xla", "xla", 0), ("pallas_paired", "xla", 0), ("pallas_paired", "pallas_fused", 0),
    ("pallas_paired", "pallas_fused", 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_jax(arch, gemm, attn, block_n):
    """r=0: ``lm_forward``'s logits, the prefill's and two decode steps'
    (slots at different positions), and every cache entry after them."""
    want_full, want, want_cache = _jax_forward(arch)
    tcfg, model = _model(arch)
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                               block_n=block_n)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_block_n=block_n)
    tokens = torch.as_tensor(_tokens(tcfg.vocab)).long()
    full, _ = TM.lm_forward(tcfg, model, tokens, knobs=knobs)
    assert full.shape == want_full.shape == (2, PROMPT, TM.padded_vocab(tcfg))
    assert rel_err(full, want_full) <= RTOL
    logits, pre = TM.prefill(tcfg, model, tokens, knobs=knobs)
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    for name, t in cache.items():
        t[:, :, :PROMPT] = pre[name]
    got = [logits]
    for pos, tok in (((PROMPT, PROMPT - 4), (3, 200)), ((PROMPT + 1, PROMPT - 3), (17, 42))):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        assert rel_err(g, w) <= RTOL
    for name, t in cache.items():
        assert rel_err(t, want_cache[name]) <= RTOL, name


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(5,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(PROMPT,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(arch, rounding: float):
    jcfg, _ = _cfgs(arch)
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(arch, 0.3 if rounding else 1.0), max_seq=MAX_SEQ,
                    batch_size=2,
                    knobs=JM.PerfKnobs(**KNOBS, remat="none", gemm=gemm, pair_rounding=rounding))
    return eng.generate(_prompts(jcfg.vocab), 6), eng.last_logits


@pytest.mark.parametrize("rounding,gemm,attn", [
    (0.0, "xla", "xla"), (0.0, "pallas_paired", "pallas_fused"),
    (0.05, "pallas_paired", "pallas_fused")])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine(arch, rounding, gemm, attn):
    """Prompts of 5 and 11 tokens, 6 tokens each; the JAX engine plain at
    r=0 and paired at r=0.05 (structured, its plain decode attention)."""
    want, want_logits = _jax_engine_tokens(arch, rounding)
    tcfg, model = _model(arch, 0.3 if rounding else 1.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


@pytest.mark.parametrize("mode,block_n", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_pair_params_equal(arch, mode, block_n):
    """r=0.05: the 7 leaves of each layer, index for index, and the reports."""
    values = _values(arch, 0.3)
    tcfg, model = _model(arch, 0.3)
    ref, ref_report = j_transform.pair_params(values, 0.05, mode=mode, block_n=block_n,
                                              leaves=tcfg.paired_leaves)
    paired, report = pair_params(model, 0.05, mode=mode, block_n=block_n,
                                 leaves=tcfg.paired_leaves)
    for sub, name in tcfg.paired_leaves:
        want = ref["segments"][0][sub][name + "_pairing"]
        for l, layer in enumerate(paired.layers):
            got = getattr(layer, sub).pairing[name]
            assert sorted(got) == sorted(want)
            for key, arr in want.items():
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                              err_msg=f"{sub}.{name}[{l}].{key}")
    assert len(report.leaves) == len(ref_report.leaves) == 7
    for a, b in zip(report.leaves, ref_report.leaves, strict=True):
        assert (a.path, a.shape, a.n_weights, a.n_pairs, a.pair_fraction) == (
            b.path, b.shape, b.n_weights, b.n_pairs, b.pair_fraction)
        assert a.n_pairs > 0
    assert report.savings() == ref_report.savings()


@pytest.mark.parametrize("attn,block_n,want_k1,want_k2", [
    ("xla", 0, 7, 0), ("pallas_fused", 0, 6, 1), ("pallas_fused", 16, 4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_launch_counts(arch, attn, block_n, want_k1, want_k2):
    """K1 and K2 calls of one decode step, counted on the CPU, against
    ``decode_launches``."""
    from repro_torch.kernels import decode_attention as da

    tcfg, model = _model(arch)
    paired, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                            block_n=block_n)
    knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn, pair_block_n=block_n)
    assert analysis.decode_launches(tcfg, "dense", knobs) == {
        "paired_matmul": want_k1, "decode_attention": want_k2, "flash_attention": 0}
    with analysis.counting(k2_calls=(da.fused_decode_attention_cuda,)) as counts:
        TM.decode_step(tcfg, paired, TM.init_cache(tcfg, 2, 8, device="cpu"),
                       torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                       knobs=knobs)
    assert counts["k1_calls"] == want_k1 * tcfg.n_layers
    assert counts["k2_calls"] == want_k2 * tcfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_smoke(arch, capsys):
    t_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--attn", "pallas_fused", "--pair-rounding", "0.05", "--steps", "3",
                  "--max-seq", "24", "--layers", "1"])
    out = capsys.readouterr().out
    assert "across 7 decoder weights" in out
    assert "slot 1: prompt 12 toks" in out and "6 tokens in" in out
