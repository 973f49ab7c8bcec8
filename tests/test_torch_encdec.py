"""The port's encoder-decoder family (whisper-base: an audio encoder over
precomputed frame embeddings, cross-attention in every decoder layer,
LayerNorm, GELU, sinusoidal positions) against the JAX package's, in fp32.

Both packages compute from the same numpy inputs: the JAX package's seeded
whisper smoke init (2 + 2 layers, d=64, 4 heads, 30 frames) with random
LayerNorm scales and biases, handed to the port through
``lm_params_from_numpy``, and the stub frames of ``launch.inputs.make_batch``
(the port's, equal to the JAX package's bit for bit).  The JAX package's
Pallas GEMMs run in interpret mode; the port's kernels run their plain
versions (K3's ``flash_attention_plain`` under ``attn="pallas_fused"``).

* the config; LayerNorm, ``_sinusoid`` and ``encoder_fwd`` within 1e-5;
* the cross-attention and the prefill's ``xk``/``xv``; ``lm_forward``;
* two decode steps under every GEMM and attention schedule, the cache too;
* the engine with ``extras`` token for token against the JAX engine with
  the same ``extras``, at r=0 and r=0.05;
* the pairing metadata of the decoder's and the encoder's segments, the
  cross ``wq``/``wo`` included, index for index;
* the weight round trip through the JAX value tree, exact;
* ``lm_loss`` and every gradient under ``gemm="xla"`` and ``"pallas"``
  against ``jax.grad``; K1 calls of a training step;
* decode and prefill launch counts; the CLI.
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
from repro.kernels.ops import perf_context
from repro.launch import inputs as j_inputs
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.core.transform import pair_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.serving.engine import CapacityError, ServeEngine

RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # the JAX package's test_lm_loss_grad_r0_parity
ARCH = "whisper-base"
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]
DEC_LEAVES, ENC_LEAVES = 9, 7  # 4 self-attention, 2 cross, 3 MLP; 4 attention, 3 MLP
PROMPT, MAX_SEQ = 12, 20
KNOBS = dict(q_chunk=8, k_chunk=8)


def _cfgs():
    """(JAX, port) whisper smoke configs in fp32."""
    return (dataclasses.replace(j_configs.get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(t_configs.get_smoke_config(ARCH), dtype="float32"))


def _perturb(tree, rng, scale: float) -> None:
    """Random LayerNorm scales and biases; matrices times ``scale``."""
    for name, v in tree.items():
        if isinstance(v, dict) and "bias" in v and "scale" in v:
            v["scale"] = (1 + 0.1 * rng.normal(size=v["scale"].shape)).astype(np.float32)
            v["bias"] = (0.1 * rng.normal(size=v["bias"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            _perturb(v, rng, scale)
        elif isinstance(v, list):
            for seg in v:
                _perturb(seg, rng, scale)
        elif name.startswith("w"):
            tree[name] = (v * np.float32(scale)).astype(np.float32)


@functools.cache
def _values(scale: float = 1.0):
    """The JAX smoke init as numpy with random norms, the layer matrices
    (the encoder's too) times ``scale``."""
    cfg, _ = _cfgs()
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    _perturb(vals, np.random.default_rng(0), scale)
    return vals


def _model(scale: float = 1.0):
    _, tcfg = _cfgs()
    return tcfg, TM.lm_params_from_numpy(_values(scale), tcfg, device="cpu")


def _frames(batch: int = 2):
    _, tcfg = _cfgs()
    return t_inputs.make_batch(tcfg, batch, 1, "prefill", seed=1, device="cpu")["frames"]


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(2, PROMPT)).astype(np.int32)


# ---------------------------------------------------------------------------
# config and inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    assert {f.name for f in dataclasses.fields(ref)} == {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "encoder":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert port.segments() == tuple(JM.segment_kinds(ref)) == (("encdec", port.n_layers),)
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    if get == "get_config":
        assert (port.encoder.n_layers, port.encoder.frames, port.head_dim) == (6, 1500, 64)
    assert t_base.default_paired_leaves(xattn=True) == j_configs.base.default_paired_leaves(
        xattn=True)


def test_cut_layers_cuts_the_encoder_too():
    cfg = t_configs.cut_layers(t_configs.get_config(ARCH), 2)
    assert (cfg.n_layers, cfg.encoder.n_layers, cfg.encoder.frames) == (2, 2, 1500)
    assert cfg.d_model == 512 and t_configs.cut_layers(cfg, 1).encoder.n_layers == 1


def test_config_needs_its_encoder():
    base = dataclasses.asdict(t_configs.get_smoke_config(ARCH))
    base.pop("encoder")
    with pytest.raises(ValueError, match="encdec"):
        t_base.ModelConfig(**base)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_equals_jax(kind, dtype):
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs())
    want = j_inputs.make_batch(jcfg, 2, 5, kind, seed=3)
    got = t_inputs.make_batch(tcfg, 2, 5, kind, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(jnp.asarray(want[name], jnp.float32) if name == "frames" else want[name])
        np.testing.assert_array_equal(t.float().numpy() if name == "frames" else t.numpy(), w,
                                      err_msg=name)
    if kind != "decode":
        assert got["frames"].shape == (2, tcfg.encoder.frames, tcfg.d_model)


# ---------------------------------------------------------------------------
# LayerNorm, the sinusoid, the encoder, cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (3 + 2 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = JL.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x, jdt))
    norm = TL.Norm(scale=torch.as_tensor(scale), bias=torch.as_tensor(bias))
    got = norm(torch.as_tensor(x).to(dtype))
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert rel_err(got, np.asarray(want)) <= RTOL
    else:  # the same fp32 statistics, one rounding to bf16
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert diff.max() <= 2 ** -8 * np.abs(np.asarray(want, np.float32)).max()
    # without a bias, RMSNorm, as before
    rms = TL.Norm(scale=torch.as_tensor(scale))(torch.as_tensor(x))
    want_rms = JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert rel_err(rms, np.asarray(want_rms)) <= RTOL


@pytest.mark.parametrize("d", [64, 512, 6, 2])
def test_sinusoid_matches_jax(d):
    """Within 1e-5 over the smoke config's positions (its 30 frames and the
    decoder's first 64).  Over whisper-base's 1500 frames the two differ by
    up to 2e-4: the fp32 ``exp`` of XLA and of torch differ by one ulp at
    some frequencies (5 of 32 at d = 64, from the same fp32 exponents), and
    at position 1499 one ulp of a frequency moves the angle by about 1e-4."""
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    want = np.asarray(JM._sinusoid(jnp.asarray(pos), d))
    got = TM._sinusoid(torch.as_tensor(pos), d)
    assert got.shape == want.shape == (2, 1500, 2 * (d // 2)) and got.dtype == torch.float32
    assert rel_err(got[0, :64], want[0, :64]) <= RTOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)



@functools.cache
def _jax_encoder_out():
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _values())
    knobs = JM.PerfKnobs(**KNOBS, remat="none")
    return np.array(jax.jit(lambda p, f: JM.encoder_fwd(jcfg, p["encoder"], f, knobs))(
        params, jnp.asarray(_frames().numpy())))


@pytest.mark.parametrize("gemm,attn", [("xla", "xla"), ("xla", "pallas_fused"),
                                       ("pallas_paired", "pallas_fused")])
def test_encoder_fwd_matches_jax(gemm, attn):
    """Over the 30 frames: the sinusoid, two layers of non-causal attention
    (on K3's plain version under attn="pallas_fused") and the MLP, the
    final LayerNorm."""
    want = _jax_encoder_out()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn)
    with analysis.counting(k3_calls=(fa.flash_attention_fwd,)) as counts:
        got = TM.encoder_fwd(tcfg, model.encoder, _frames(), knobs)
    assert got.shape == want.shape == (2, tcfg.encoder.frames, tcfg.d_model)
    assert rel_err(got, want) <= RTOL
    assert counts["k3_calls"] == (tcfg.encoder.n_layers if attn == "pallas_fused" else 0)
    assert counts["k1_calls"] == (7 * tcfg.encoder.n_layers if gemm == "pallas_paired" else 0)


@pytest.mark.parametrize("attn", ["xla", "pallas_fused"])
def test_cross_attention_matches_jax(attn):
    """Layer 0's cross-attention of a (2, 12, d) query against the encoder
    output, the skip connection fused: its output, and its keys and
    values (the cache's ``xk``/``xv``)."""
    jcfg, tcfg = _cfgs()
    enc = _jax_encoder_out()
    rng = np.random.default_rng(4)
    xq = rng.normal(size=(2, PROMPT, tcfg.d_model)).astype(np.float32)
    res = rng.normal(size=(2, PROMPT, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), _values()["segments"][0]["xattn"])
    want = JM._cross_attention(jcfg, jp, jnp.asarray(xq), jnp.asarray(enc),
                               JM.PerfKnobs(**KNOBS), residual=jnp.asarray(res))
    _, model = _model()
    p = model.layers[0].xattn
    got, xk, xv = TM._cross_attention(p, torch.as_tensor(xq), torch.as_tensor(enc),
                                      TM.PerfKnobs(**KNOBS, attn=attn),
                                      residual=torch.as_tensor(res))
    assert rel_err(got, np.asarray(want)) <= RTOL
    want_k = np.einsum("bsd,dhk->bshk", enc, np.asarray(jp["wk"]))
    assert xk.shape == (2, tcfg.encoder.frames, tcfg.n_kv_heads, tcfg.head_dim)
    assert rel_err(xk, want_k) <= RTOL
    assert rel_err(xv, np.einsum("bsd,dhk->bshk", enc, np.asarray(jp["wv"]))) <= RTOL


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------

POS = [(PROMPT, PROMPT - 4), (PROMPT + 1, PROMPT - 3)]
STEP_TOKENS = [(3, 200), (17, 42)]


@functools.cache
def _jax_forward():
    """The JAX package's forward logits, prefill logits and cache, two
    decode steps' logits and the cache after them."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _values())
    knobs = JM.PerfKnobs(**KNOBS, remat="none")
    batch = {"tokens": jnp.asarray(_tokens(jcfg.vocab)),
             "frames": jnp.asarray(_frames().numpy())}
    full, _, _ = jax.jit(lambda p, b: JM.lm_forward(jcfg, p, b, knobs=knobs))(params, batch)
    logits, pre = jax.jit(lambda p, b: JM.prefill(jcfg, p, b, knobs=knobs))(params, batch)
    cache = unzip(JM.init_cache(jcfg, 2, MAX_SEQ))[0]
    seg = {k: v.at[:, :, :PROMPT].set(pre["segments"][0][k]) if k in ("k", "v")
           else pre["segments"][0][k] for k, v in cache["segments"][0].items()}
    cache = {"segments": [seg]}
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
    out = [np.asarray(logits)]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    as_np = lambda c: {k: np.asarray(v) for k, v in c["segments"][0].items()}
    return np.asarray(full), as_np(pre), out, as_np(cache)


@pytest.mark.parametrize("gemm,attn", [("xla", "xla"), ("pallas_paired", "pallas_fused")])
def test_lm_forward_and_prefill_cache_match_jax(gemm, attn):
    want, want_cache, _, _ = _jax_forward()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn)
    tokens = torch.as_tensor(_tokens(tcfg.vocab)).long()
    got, cache = TM.lm_forward(tcfg, model, tokens, knobs=knobs, collect_cache=True,
                               extras={"frames": _frames()})
    assert got.shape == want.shape == (2, PROMPT, TM.padded_vocab(tcfg))
    assert rel_err(got, want) <= RTOL
    assert sorted(cache) == sorted(want_cache) == ["k", "v", "xk", "xv"]
    assert cache["xk"].shape == (2, 2, tcfg.encoder.frames, 4, 16)
    for name, t in cache.items():
        assert t.shape == want_cache[name].shape, name
        assert rel_err(t, want_cache[name]) <= RTOL, name


def test_forward_needs_frames():
    tcfg, model = _model()
    with pytest.raises(ValueError, match="frames"):
        TM.lm_forward(tcfg, model, torch.zeros((1, 3), dtype=torch.int64))


def test_frames_and_positions_change_the_logits():
    """Other frames change the prefill's logits; the decoder's sinusoid
    makes a token's logits depend on its position."""
    _, _, want, _ = _jax_forward()
    tcfg, model = _model()
    tokens = torch.as_tensor(_tokens(tcfg.vocab)).long()
    other = TM.prefill(tcfg, model, tokens, knobs=TM.PerfKnobs(**KNOBS),
                       extras={"frames": _frames() * 2})[0]
    assert rel_err(other, want[0]) > 1e-3
    step = lambda pos: TM.decode_step(tcfg, model, TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                                      torch.tensor([[3], [3]]), torch.tensor(pos))[0]
    a = step([0, 5])
    assert rel_err(a[0], a[1]) > 1e-3  # same token, same (empty) keys, other position


@pytest.mark.parametrize("gemm,attn,block_n", [
    ("xla", "xla", 0), ("xla", "pallas_fused", 0), ("pallas_paired", "xla", 0),
    ("pallas_paired", "pallas_fused", 0), ("pallas_paired", "pallas_fused", 16)])
def test_decode_matches_jax(gemm, attn, block_n):
    """Prefill of 2 × 12 tokens over the frames, two decode steps (cross
    attention against all 30 frames): logits and every cache entry at r=0,
    through the plain and the fused decode attention."""
    _, _, want, want_cache = _jax_forward()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                               block_n=block_n)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_block_n=block_n)
    logits, pre = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                             knobs=knobs, extras={"frames": _frames()})
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert cache["xk"].shape == (2, 2, tcfg.encoder.frames, 4, 16)
    for name, t in cache.items():
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
# pairing metadata, weights
# ---------------------------------------------------------------------------


def _block_at(layer, sub_path: str):
    for part in sub_path.split("."):
        layer = getattr(layer, part)
    return layer


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_pair_params_equal(mode, block_n, rounding):
    """The decoder's 9 leaves a layer (the cross wq/wo among them) and the
    encoder's 7, each stack padded to its own (Pmax, Rmax), index for index;
    the reports leaf for leaf, the encoder's after the decoder's."""
    values = _values(0.3)
    tcfg, model = _model(0.3)
    assert len(tcfg.paired_leaves) == DEC_LEAVES
    ref, ref_report = j_transform.pair_params(values, rounding, mode=mode, block_n=block_n)
    paired, report = pair_params(model, rounding, mode=mode, block_n=block_n)
    stacks = [(ref["segments"][0], paired.layers, tcfg.paired_leaves),
              (ref["encoder"]["segments"][0], paired.encoder.layers,
               tuple(s for s in tcfg.paired_leaves if s[0] != "xattn"))]
    n_checked = 0
    for seg, layers, specs in stacks:
        for sub, name in specs:
            want = j_transform._resolve_sub(seg, sub)[name + "_pairing"]
            for l, layer in enumerate(layers):
                got = _block_at(layer, sub).pairing[name]
                assert sorted(got) == sorted(want)
                for key, arr in want.items():
                    np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                                  err_msg=f"{sub}.{name}[{l}].{key}")
                n_checked += 1
    assert n_checked == 2 * (DEC_LEAVES + ENC_LEAVES)
    assert len(report.leaves) == len(ref_report.leaves) == DEC_LEAVES + ENC_LEAVES
    for a, b in zip(report.leaves, ref_report.leaves, strict=True):
        assert (a.path, a.shape, a.n_weights, a.n_pairs) == (b.path, b.shape, b.n_weights,
                                                              b.n_pairs)
        assert a.pair_fraction == b.pair_fraction
    assert report.leaves[-1].path == "encoder.segments[0].mlp.w_down"
    assert report.savings() == ref_report.savings()
    if rounding:
        assert all(leaf.n_pairs > 0 for leaf in report.leaves)


def test_weight_round_trip_is_exact():
    """JAX value tree → the port's model → ``lm_value_tree``: every leaf
    (the encoder's segments and final norm, every LayerNorm bias, the cross
    attention) bit for bit, the same paths; ``load_lm_values`` of it into a
    fresh model gives the same weights."""
    values = _values()
    tcfg, model = _model()
    tree = jax.tree.map(lambda t: t.numpy(), TM.lm_value_tree(model))
    want = jax.tree_util.tree_leaves_with_path(values)
    got = jax.tree_util.tree_leaves_with_path(tree)
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    fresh = TM.init_lm(tcfg, 3, device="cpu")
    TM.load_lm_values(fresh, TM.lm_value_tree(model))
    want_params = dict(model.named_parameters())
    assert sorted(dict(fresh.named_parameters())) == sorted(want_params)
    for n, a in fresh.named_parameters():
        assert torch.equal(a, want_params[n]), n


def test_init_lm_builds_encoder_and_cross_attention():
    tcfg, _ = _model()
    model = TM.init_lm(tcfg, 0, device="cpu")
    assert len(model.encoder.layers) == tcfg.encoder.n_layers
    assert model.encoder.final_norm.bias.shape == (tcfg.d_model,)
    for layer in model.layers:
        assert sorted(n for n, _ in layer.named_children()) == sorted(
            ["ln1", "attn", "lnx", "xattn", "ln2", "mlp"])
        assert not layer.lnx.bias.any() and layer.xattn.wq.shape == (64, 4, 16)
    for layer in model.encoder.layers:
        assert sorted(n for n, _ in layer.named_children()) == ["attn", "ln1", "ln2", "mlp"]
    shapes = jax.tree.map(np.shape, _values())
    assert jax.tree.map(lambda t: tuple(t.shape), TM.lm_value_tree(model)) == shapes
    frozen = model.copy(frozen=True)
    assert frozen.encoder.layers[0].attn.wq is model.encoder.layers[0].attn.wq


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
                    knobs=JM.PerfKnobs(**KNOBS, remat="none", gemm=gemm, pair_rounding=rounding))
    extras = {"frames": jnp.asarray(_frames(1).numpy())}
    return eng.generate(_prompts(jcfg.vocab), 6, extras), eng.last_logits


@pytest.mark.parametrize("rounding,gemm,attn", [
    (0.0, "xla", "xla"), (0.0, "pallas_paired", "pallas_fused"),
    (0.05, "pallas_paired", "xla"), (0.05, "pallas_paired", "pallas_fused")])
def test_engine_tokens_match_jax_engine(rounding, gemm, attn):
    """Prompts of 5 and 12 tokens over the same stub frames, 6 tokens each;
    the JAX engine plain at r=0 and paired at r=0.05 (structured)."""
    want, want_logits = _jax_engine_tokens(rounding)
    tcfg, model = _model(0.3 if rounding else 1.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
        assert any(leaf.path.startswith("encoder.") and leaf.n_pairs
                   for leaf in eng.pair_report.leaves)
    assert eng.generate(_prompts(tcfg.vocab), 6, {"frames": _frames(1).numpy()}) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


def test_engine_splices_cross_cache_and_scrubs_it():
    """A prefill's cross keys and values land over all frames of its slot;
    release zeroes them."""
    tcfg, model = _model()
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2, knobs=TM.PerfKnobs(**KNOBS))
    prompt = _prompts(tcfg.vocab)[0]
    eng.add_request(1, prompt, {"frames": _frames(1)})
    _, want = TM.prefill(tcfg, eng.model, torch.as_tensor(prompt)[None].long(),
                         knobs=eng.knobs, extras={"frames": _frames(1)})
    for name in ("xk", "xv"):
        assert torch.equal(eng.cache[name][:, 1], want[name][:, 0])
        assert not eng.cache[name][:, 0].any()
    eng.step()
    eng.release_slot(1)
    assert not any(t[:, 1].any() for t in eng.cache.values())
    with pytest.raises(ValueError, match="frames"):
        eng.add_request(0, prompt)
    with pytest.raises(CapacityError):
        eng.add_request(0, np.zeros(MAX_SEQ, np.int32), {"frames": _frames(1)})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gemm", ["xla", "pallas"])
def test_lm_loss_and_grads_match_jax_grad(gemm):
    """``lm_loss`` (masked labels) and the gradient of every weight, the
    encoder's, the cross-attention's and every LayerNorm bias among them,
    under ``gemm="xla"`` and ``"pallas"`` (K1's dense form, the JAX
    package's Pallas GEMM in interpret mode), against ``jax.grad`` of the
    JAX ``lm_loss``."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, -1] = -1
    frames = _frames().numpy()
    knobs = JM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm)

    def f(p, batch):
        with perf_context(knobs):
            return JM.lm_loss(jcfg, p, batch, knobs=knobs)

    (want, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, _values()),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
         "frames": jnp.asarray(frames)})
    _, model = _model()
    model.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(tokens).long(), "labels": torch.as_tensor(labels).long(),
             "frames": torch.as_tensor(frames)}
    loss, got_metrics = TM.lm_loss(tcfg, model, batch,
                                   knobs=TM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(got_metrics["xent"].detach()) - float(metrics["xent"])) <= 1e-5 * float(want)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    got = jax.tree.map(lambda t: t.numpy(), TM.lm_value_tree(model))
    flat = jax.tree_util.tree_leaves_with_path(grads)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, g in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(g), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(np.asarray(grads["encoder"]["segments"][0]["attn"]["wq"])).max() > 1e-4


def test_k3_refuses_autograd():
    tcfg, model = _model()
    model.requires_grad_(True)
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int64),
             "labels": torch.zeros((1, 3), dtype=torch.int64), "frames": _frames(1)}
    with pytest.raises(NotImplementedError, match="forward only"):
        TM.lm_loss(tcfg, model, batch, knobs=TM.PerfKnobs(attn="pallas_fused"))


@pytest.mark.parametrize("gemm,remat", [("pallas", "full"), ("pallas_paired", "none")])
def test_train_launches_count_encoder_and_cross_gemms(gemm, remat):
    """K1 calls of a training step: 7 an encoder layer, 9 a decoder layer
    (the cross wq and wo), twice under remat="full"."""
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    model.requires_grad_(True)
    knobs = TM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm, remat=remat)
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.int64),
             "labels": torch.ones((1, 5), dtype=torch.int64), "frames": _frames(1)}
    with analysis.counting() as counts:
        TM.lm_loss(tcfg, model, batch, knobs=knobs)[0].backward()
    want = analysis.train_launches(tcfg, knobs)
    assert want == (7 * 2 + 9 * 2) * (2 if remat == "full" else 1)
    assert counts["k1_calls"] == want


# ---------------------------------------------------------------------------
# launch counts, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn,block_n,want_k1,want_k2", [
    ("xla", 0, 9, 0), ("pallas_fused", 0, 8, 1), ("pallas_fused", 16, 6, 1)])
def test_decode_launch_counts(attn, block_n, want_k1, want_k2):
    """K1 and K2 calls of one decode step against ``decode_launches``: the
    dense layer's (QKV, the out-projection unless K2 fuses it, the MLP) and
    the cross wq and wo; the cross-attention itself is plain."""
    tcfg, model = _model()
    mode = "column_blocked" if block_n else "structured"
    paired, _ = pair_params(model, 0.0, mode=mode, block_n=block_n)
    knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn, pair_block_n=block_n)
    assert analysis.decode_launches(tcfg, "encdec", knobs) == {
        "paired_matmul": want_k1, "decode_attention": want_k2, "flash_attention": 0}
    from repro_torch.kernels import decode_attention as da

    with analysis.counting(k2_calls=(da.fused_decode_attention_cuda,),
                           k3_calls=(fa.flash_attention_fwd,)) as counts:
        TM.decode_step(tcfg, paired, TM.init_cache(tcfg, 2, 8, device="cpu"),
                       torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                       knobs=knobs)
    assert counts["k1_calls"] == want_k1 * tcfg.n_layers
    assert counts["k2_calls"] == want_k2 * tcfg.n_layers and counts["k3_calls"] == 0


@pytest.mark.parametrize("attn", ["xla", "pallas_fused"])
def test_prefill_launch_counts(attn):
    """One request's prefill: 7 K1 calls an encoder layer, 9 a decoder
    layer; under attn="pallas_fused" one K3 call an encoder layer and one a
    decoder layer's cross-attention (``analysis.prefill_launches``)."""
    tcfg, model = _model()
    paired, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm="pallas_paired", attn=attn)
    want = analysis.prefill_launches(tcfg, knobs)
    k3 = 4 if attn == "pallas_fused" else 0
    assert want == {"paired_matmul": 7 * 2 + 9 * 2, "decode_attention": 0, "flash_attention": k3}
    with analysis.counting(k3_calls=(fa.flash_attention_fwd,)) as counts:
        TM.prefill(tcfg, paired, torch.zeros((1, 4), dtype=torch.int64), knobs=knobs,
                   extras={"frames": _frames(1)})
    assert counts["k1_calls"] == want["paired_matmul"] and counts["k3_calls"] == k3


def test_cli_serves_whisper_smoke(capsys):
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--attn", "pallas_fused", "--pair-rounding", "0.05", "--steps", "3",
                  "--max-seq", "24", "--prompt-lens", "5,12"])
    out = capsys.readouterr().out
    assert "paired-kernel LM path (structured" in out
    assert f"across {DEC_LEAVES + ENC_LEAVES} decoder weights" in out
    assert "slot 1: prompt 12 toks" in out and "6 tokens in" in out
    with pytest.raises(ValueError, match="frames or patches"):
        t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--frontend"])
