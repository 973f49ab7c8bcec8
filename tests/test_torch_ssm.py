"""The port's SSM family (mamba2-2.7b: Mamba-2 SSD blocks, no attention)
against the JAX package's.

Both packages compute from the same numpy inputs: the JAX package's seeded
mamba2 smoke init (2 layers, d=64, d_state 16, head_dim 16, chunk 32),
handed to the port through ``lm_params_from_numpy`` with random norm
scales, and random activations.  The JAX package's Pallas GEMMs run in
interpret mode.

* the config: fields, segments, layer kinds, parameter counts and paired
  leaves at full and smoke size;
* ``_causal_conv``, ``_segsum_decay`` and ``ssd_scan`` (S below, at and
  past a chunk, not a multiple of it, with ``h0``, with 2 groups) within
  1e-5 relative in fp32 and within :data:`BF16_ULPS` (the conv
  :data:`CONV_BF16_ULPS`) output ulps in bf16;
* ``ssm_block``, ``ssm_decode_block`` and ``_ssm_with_cache``, unpaired and
  paired at r=0, within 1e-5 in fp32 (the state and conv tails too), and
  in bf16 within :data:`BLOCK_BF16_ULPS` ulps of the largest output;
* the smoke ``lm_forward``, prefill and two decode steps, the pairing
  metadata index for index, and the serving engine's tokens against the
  JAX package's on prompts of 3 tokens or more;
* prompts shorter than the conv tail (1 and 2 tokens), where the JAX
  engine fails: the port's prefill + decode against its own teacher-forced
  forward;
* the decode launches of an SSM layer, the cache's splice, release and
  scrub, and the CLI.
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
from repro_torch.configs import base as t_base
from repro_torch.core.transform import pair_params
from repro_torch.kernels.ref import bf16_ulps, rel_err
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM
from repro_torch.serving.engine import ServeEngine

RTOL = 1e-5
# ssd_scan ends in one rounding to bf16 of fp32 values both packages compute
# to a few fp32 ulps of each other: at most one bf16 ulp apart
BF16_ULPS = 1.0
# the conv: XLA on the CPU keeps the bf16 products and their sum in fp32 and
# rounds once, eager PyTorch rounds each product and sum to bf16 (the
# compute dtype's rounding points), then SiLU: up to two ulps apart
CONV_BF16_ULPS = 2.0
# a whole block rounds to bf16 after each projection, the conv, y before its
# gate and the norm; an intermediate one ulp apart moves an output near zero
# by many of its own ulps, so the blocks are held in ulps of their largest
# output (``_ulps_of_max``)
BLOCK_BF16_ULPS = 4.0
ARCH = "mamba2-2.7b"
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]
GEMMS = ["xla", "pallas_paired"]
SSM_LEAVES = tuple(("mamba", n) for n in ("w_z", "w_x", "w_B", "w_C", "w_dt", "w_out"))


def _cfgs(dtype: str = "float32"):
    """(JAX, port) mamba2 smoke configs in ``dtype``."""
    return (dataclasses.replace(j_configs.get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(t_configs.get_smoke_config(ARCH), dtype=dtype))


def _scale_weights(tree: dict, scale: float) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            _scale_weights(v, scale)
        elif name.startswith("w_"):
            tree[name] = v * np.float32(scale)


@functools.cache
def _values(scale: float = 1.0):
    """The JAX smoke init as numpy, its projections times ``scale``, with
    random norm scales (the gated norm's too)."""
    cfg, _ = _cfgs()
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    seg = vals["segments"][0]
    _scale_weights(seg, scale)
    for norm in (seg["ln1"], vals["final_norm"]):
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    seg["mamba"]["norm"] = (1 + 0.1 * rng.normal(size=seg["mamba"]["norm"].shape)
                            ).astype(np.float32)
    return vals


def _mamba(gemm: str = "xla", layer: int = 0) -> dict:
    """One layer's SSM block values, with the JAX package's r=0 pairing under
    ``gemm="pallas_paired"``."""
    p = jax.tree.map(lambda a: a[layer], _values()["segments"][0]["mamba"])
    if gemm != "pallas_paired":
        return p
    fake = {"segments": [{"mamba": jax.tree.map(lambda a: a[None], p)}]}
    out, _ = j_transform.pair_params(fake, 0.0, leaves=SSM_LEAVES)
    return jax.tree.map(lambda a: a[0], out["segments"][0]["mamba"])


def _port_mamba(p: dict) -> TL.Mamba:
    t = lambda a: torch.as_tensor(np.array(a)).long() if np.asarray(a).dtype.kind == "i" \
        else torch.as_tensor(np.array(a))
    pairing = {k[:-len("_pairing")]: {mk: t(mv) for mk, mv in v.items()}
               for k, v in p.items() if k.endswith("_pairing")}
    return TL.Mamba(pairing=pairing, **{k: t(v) for k, v in p.items()
                                        if not k.endswith("_pairing")})


def _x(*shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_policy(gemm: str):
    return j_ops.pallas_paired_gemm(interpret=True) if gemm == "pallas_paired" else \
        contextlib.nullcontext()


def _ulps_of_max(got, want) -> float:
    """max |got − want| in bf16 ulps of the largest |want|."""
    want = torch.as_tensor(np.asarray(want, np.float64))
    err = (got.double() - want).abs().max()
    return float(err / torch.exp2(torch.floor(torch.log2(want.abs().max())) - 7))


def _close(got, want, dtype: str, ulps: float = BF16_ULPS, *, block: bool = False):
    """fp32: within RTOL relative; bf16: within ``ulps`` output ulps of the
    JAX value (``block``: ulps of the largest output)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        assert rel_err(got, want) <= RTOL
    elif block:
        assert _ulps_of_max(got, want) <= ulps
    else:
        assert bf16_ulps(got.float(), want) <= ulps


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
    assert port.segments() == ref.segments() == (("ssm", port.n_layers),)
    assert [port.layer_kind(i) for i in range(port.n_layers)] == ["ssm"] * port.n_layers
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    if get == "get_config":
        assert port.param_count() == 2_700_349_440
    assert t_base.default_paired_leaves(attn=False, mlp=False, ssm=True) == \
        j_configs.base.default_paired_leaves(attn=False, mlp=False, ssm=True)
    assert TM.padded_vocab(port) == JM.padded_vocab(ref)


def test_config_ssm_needs_its_geometry():
    base = dataclasses.asdict(t_configs.get_smoke_config(ARCH))
    base.pop("ssm")
    with pytest.raises(ValueError, match="family"):
        t_base.ModelConfig(**base)
    with pytest.raises(ValueError, match="family"):
        t_base.ModelConfig(**{**base, "family": "dense"}, ssm=t_base.SsmConfig())


# ---------------------------------------------------------------------------
# the conv, the decay matrix and the scan
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_matches_jax(S, dtype):
    x, w = _x(2, S, 24), _x(4, 24, seed=4)
    want = JL._causal_conv(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = TL._causal_conv(torch.as_tensor(x).to(getattr(torch, dtype)),
                          torch.as_tensor(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, S, 24)
    _close(got, want, dtype, CONV_BF16_ULPS)


@pytest.mark.parametrize("Q", [1, 5, 32])
def test_segsum_decay_matches_jax(Q):
    dA = -np.abs(_x(2, 3, Q))
    want = JL._segsum_decay(jnp.asarray(dA))
    got = TL._segsum_decay(torch.as_tensor(dA))
    assert got.shape == (2, 3, Q, Q)
    assert rel_err(got, want) <= RTOL
    assert not torch.triu(got, diagonal=1).any()
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1), torch.ones(2, 3, Q))


# (name, S, chunk, groups, h0)
SCAN_CASES = [
    ("S_below_chunk", 10, 32, 1, False),
    ("S_at_chunk", 32, 32, 1, False),
    ("S_ragged", 77, 32, 1, False),
    ("h0", 40, 16, 1, True),
    ("groups2", 50, 16, 2, False),
    ("groups2_h0_ragged", 33, 8, 2, True),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,S,chunk,G,h0", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_ssd_scan_matches_jax(name, S, chunk, G, h0, dtype):
    B, H, P, N = 2, 4, 8, 16
    rng = np.random.default_rng(S)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, H)))) * 0.5).astype(np.float32)
    A = -np.exp(rng.normal(size=H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, G, N)).astype(np.float32) for _ in range(2))
    h = rng.normal(size=(B, H, P, N)).astype(np.float32) if h0 else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want_y, want_h = jax.jit(functools.partial(JL.ssd_scan, chunk=chunk))(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jd),
        jnp.asarray(Cm, jd), h0=None if h is None else jnp.asarray(h))
    got_y, got_h = TL.ssd_scan(torch.as_tensor(x).to(td), torch.as_tensor(dt), torch.as_tensor(A),
                               torch.as_tensor(Bm).to(td), torch.as_tensor(Cm).to(td),
                               chunk=chunk, h0=None if h is None else torch.as_tensor(h))
    assert got_y.dtype == td and got_y.shape == (B, S, H, P)
    assert got_h.dtype == torch.float32 and got_h.shape == (B, H, P, N)
    _close(got_y, want_y, dtype)
    assert rel_err(got_h, want_h) <= RTOL  # the state is fp32 in both dtypes


def test_ssd_scan_chains_across_calls():
    """Two scans chained through ``h0`` give the one scan's output and
    state: the inter-chunk recurrence carries the whole history."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 48, 4, 8, 16
    x = torch.as_tensor(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dt = torch.as_tensor((np.log1p(np.exp(rng.normal(size=(B, S, H)))) * 0.5).astype(np.float32))
    A = -torch.exp(torch.as_tensor(rng.normal(size=H).astype(np.float32)))
    Bm, Cm = (torch.as_tensor(rng.normal(size=(B, S, 1, N)).astype(np.float32)) for _ in range(2))
    y, h = TL.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, h1 = TL.ssd_scan(x[:, :20], dt[:, :20], A, Bm[:, :20], Cm[:, :20], chunk=16)
    y2, h2 = TL.ssd_scan(x[:, 20:], dt[:, 20:], A, Bm[:, 20:], Cm[:, 20:], chunk=16, h0=h1)
    assert rel_err(torch.cat([y1, y2], dim=1), y) <= RTOL
    assert rel_err(h2, h) <= RTOL


# ---------------------------------------------------------------------------
# the SSM block: prefill, decode, and the prefill's cache
# ---------------------------------------------------------------------------


def _block_inputs(dtype: str, gemm: str, S: int):
    jcfg, tcfg = _cfgs(dtype)
    p = _mamba(gemm)
    x = _x(2, S, jcfg.d_model, seed=S)
    jp = jax.tree.map(jnp.asarray, p)
    return jcfg, tcfg, p, jp, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gemm", GEMMS)
@pytest.mark.parametrize("S", [5, 40])  # below and past the smoke chunk of 32
def test_ssm_block_matches_jax(S, gemm, dtype):
    jcfg, tcfg, p, jp, x = _block_inputs(dtype, gemm, S)
    with _jax_policy(gemm):
        want = JL.ssm_block(jcfg, jp, jnp.asarray(x, dtype))
    got = TL.ssm_block(tcfg, _port_mamba(p), torch.as_tensor(x).to(getattr(torch, dtype)),
                       TM.PerfKnobs(gemm=gemm))
    assert got.shape == (2, S, jcfg.d_model) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, BLOCK_BF16_ULPS, block=True)


@pytest.mark.parametrize("gemm", GEMMS)
@pytest.mark.parametrize("S", [3, 40])
def test_ssm_with_cache_matches_jax(S, gemm):
    """The prefill's output, final state and conv tails (for S ≥ W − 1,
    where the JAX package's tail is whole)."""
    jcfg, tcfg, p, jp, x = _block_inputs("float32", gemm, S)
    with _jax_policy(gemm):
        want_y, want_c = JM._ssm_with_cache(jcfg, jp, jnp.asarray(x), True)
    got_y, got_c = TM._ssm_with_cache(tcfg, _port_mamba(p), torch.as_tensor(x),
                                      TM.PerfKnobs(gemm=gemm))
    assert rel_err(got_y, want_y) <= RTOL
    assert sorted(got_c) == sorted(want_c) == sorted(TM.SSM_ENTRIES)
    for name in got_c:
        assert got_c[name].shape == want_c[name].shape, name
        assert rel_err(got_c[name], want_c[name]) <= RTOL, name


def test_ssm_with_cache_pads_short_conv_tails():
    """A prompt shorter than W − 1 = 3 keeps zero rows before its inputs, as
    the causal conv pads: 1 and 2 rows of input, 2 and 1 of zeros."""
    _, tcfg, p, _, x = _block_inputs("float32", "xla", 2)
    blk = _port_mamba(p)
    for S in (1, 2):
        xs = torch.as_tensor(x[:, :S])
        _, c = TM._ssm_with_cache(tcfg, blk, xs, TM.PerfKnobs())
        _, _, raw = TL.ssm_forward(tcfg, blk, xs, TM.PerfKnobs())
        for name in ("conv_x", "conv_B", "conv_C"):
            assert c[name].shape[1] == 3
            assert not c[name][:, : 3 - S].any()
            assert torch.equal(c[name][:, 3 - S:], raw[name])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gemm", GEMMS)
def test_ssm_decode_block_matches_jax(gemm, dtype):
    """One decode token per slot against a random state and conv tails;
    the cache is updated in place."""
    jcfg, tcfg, p, jp, _ = _block_inputs(dtype, gemm, 1)
    s, B = tcfg.ssm, 3
    d_in = s.expand * tcfg.d_model
    H, GN = d_in // s.head_dim, s.n_groups * s.d_state
    x = _x(B, 1, tcfg.d_model, seed=7)
    cache = {"h": _x(B, H, s.head_dim, s.d_state, seed=8), "conv_x": _x(B, 3, d_in, seed=9),
             "conv_B": _x(B, 3, GN, seed=10), "conv_C": _x(B, 3, GN, seed=11)}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jcache = {k: jnp.asarray(v, jnp.float32 if k == "h" else jd) for k, v in cache.items()}
    with _jax_policy(gemm):
        want_y, want_c = JL.ssm_decode_block(jcfg, jp, jnp.asarray(x, jd), jcache,
                                             jnp.zeros((B,), jnp.int32))
    tcache = {k: torch.as_tensor(v).to(torch.float32 if k == "h" else td)
              for k, v in cache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    got_y, got_c = TL.ssm_decode_block(tcfg, _port_mamba(p), torch.as_tensor(x).to(td), tcache,
                                       TM.PerfKnobs(gemm=gemm))
    assert got_c is tcache
    assert got_y.shape == (B, 1, tcfg.d_model) and got_y.dtype == td
    _close(got_y, want_y, dtype, BLOCK_BF16_ULPS, block=True)
    for name, t in got_c.items():
        assert not torch.equal(t, before[name]), name  # written in place
        # bf16: the tails are projected rows, the (fp32) state adds the
        # products of bf16 conv outputs; both as far apart as a block's
        _close(t.float(), want_c[name], dtype, BLOCK_BF16_ULPS, block=True)
    for name in ("conv_x", "conv_B", "conv_C"):  # the tail shifts by one row
        assert torch.equal(tcache[name][:, :2], before[name][:, 1:])


# ---------------------------------------------------------------------------
# pairing metadata and reports
# ---------------------------------------------------------------------------


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
        want_seg = ref["segments"][0]["mamba"]
        for l, layer in enumerate(paired.layers):
            assert sorted(layer.mamba.pairing) == sorted(n for _, n in SSM_LEAVES)
            for _, name in SSM_LEAVES:
                got, want = layer.mamba.pairing[name], want_seg[name + "_pairing"]
                assert sorted(got) == sorted(want)
                for key, arr in want.items():
                    np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                                  err_msg=f"{name}[{l}].{key}")
        assert len(report.leaves) == len(ref_report.leaves) == 6
        for a, b in zip(report.leaves, ref_report.leaves, strict=True):
            assert (a.path, a.shape, a.n_weights, a.n_pairs) == (
                b.path, b.shape, b.n_weights, b.n_pairs)
            assert a.pair_fraction == b.pair_fraction
        assert report.savings() == ref_report.savings()
    if rounding:
        assert all(leaf.n_pairs > 0 for leaf in report.leaves)
    # the convs and per-head vectors are never paired
    assert not {"conv_x", "A_log", "D", "dt_bias", "norm"} & set(paired.layers[0].mamba.pairing)


# ---------------------------------------------------------------------------
# forward and engine
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ = 40, 48  # 40 tokens: past the smoke chunk of 32
POS = [(PROMPT, PROMPT), (PROMPT + 1, PROMPT + 1)]
STEP_TOKENS = [(3, 200), (17, 42)]


def _tokens(vocab, n: int = PROMPT):
    return np.random.default_rng(1).integers(0, vocab, size=(2, n)).astype(np.int32)


@functools.cache
def _jax_forward():
    """The JAX package's prefill logits, two decode steps' logits and its
    final cache (per segment)."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _values())
    knobs = JM.PerfKnobs(remat="none")
    logits, pre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, knobs=knobs))(
        params, jnp.asarray(_tokens(jcfg.vocab)))
    full, _, _ = jax.jit(lambda p, t: JM.lm_forward(jcfg, p, {"tokens": t}, knobs=knobs))(
        params, jnp.asarray(_tokens(jcfg.vocab)))
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
    cache, out = pre, [np.asarray(logits)]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    return np.asarray(full), out, cache


@pytest.mark.parametrize("gemm", GEMMS)
def test_lm_forward_matches_jax(gemm):
    _, tcfg = _cfgs()
    want, _, _ = _jax_forward()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    got, _ = TM.lm_forward(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                           knobs=TM.PerfKnobs(gemm=gemm))
    assert got.shape == want.shape == (2, PROMPT, TM.padded_vocab(tcfg))
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("gemm", GEMMS)
def test_prefill_and_decode_match_jax(gemm):
    """Prefill of 2 × 40 tokens (two chunks), then two decode steps: logits
    and the final state and conv tails, at r=0."""
    _, tcfg = _cfgs()
    _, want, want_cache = _jax_forward()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0)
    knobs = TM.PerfKnobs(gemm=gemm)
    logits, cache = TM.prefill(tcfg, model, torch.as_tensor(_tokens(tcfg.vocab)).long(),
                               knobs=knobs)
    empty = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert sorted(cache) == sorted(empty) == sorted(TM.SSM_ENTRIES)
    for name in cache:
        assert cache[name].shape == empty[name].shape and cache[name].dtype == empty[name].dtype
    got = [logits]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        assert rel_err(g, w) <= RTOL
    for name, t in cache.items():
        assert rel_err(t, want_cache["segments"][0][name]) <= RTOL, name


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(3,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(37,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(rounding: float):
    jcfg, _ = _cfgs()
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(0.3 if rounding else 1.0), max_seq=48, batch_size=2,
                    knobs=JM.PerfKnobs(remat="none", gemm=gemm, pair_rounding=rounding))
    return eng.generate(_prompts(jcfg.vocab), 6), eng.last_logits


@pytest.mark.parametrize("rounding,gemm", [(0.0, "xla"), (0.0, "pallas_paired"),
                                           (0.05, "pallas_paired")])
def test_engine_tokens_match_jax_engine(rounding, gemm):
    """Prompts of 3 tokens (the shortest whole conv tail) and 37 (past a
    chunk), 6 tokens each; the JAX engine plain at r=0 and paired at
    r=0.05 (structured)."""
    want, want_logits = _jax_engine_tokens(rounding)
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(0.3 if rounding else 1.0), tcfg, device="cpu")
    knobs = TM.PerfKnobs(gemm=gemm, pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=48, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


@pytest.mark.parametrize("gemm", GEMMS)
@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompts_continue_exactly(plen, gemm):
    """Prompts of 1 and 2 tokens, shorter than the conv tail: the engine's
    prefill and 4 decode steps give the logits of the port's own forward
    over the prompt and the tokens it emitted (teacher forcing)."""
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    knobs = TM.PerfKnobs(gemm=gemm)
    eng = ServeEngine(tcfg, model, max_seq=16, batch_size=1, knobs=knobs)
    prompt = _tokens(tcfg.vocab, plen)[0]
    toks = [eng.add_request(0, prompt)]
    logits = []
    for _ in range(4):
        toks.append(int(eng.step()[0]))
        logits.append(eng.last_logits[0])
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))[None].long()
    want, _ = TM.lm_forward(tcfg, eng.model, seq, knobs=knobs)
    want = want[0, plen:, : tcfg.vocab]
    assert rel_err(np.stack(logits), want) <= RTOL
    assert toks[1:] == want.argmax(-1).tolist()


def test_jax_engine_fails_on_a_two_token_prompt():
    """The JAX package's prefill keeps ``x[:, -(W − 1):]`` as the conv tail,
    2 rows for a 2-token prompt, which its engine cannot splice into the 3
    rows of its cache (a fault of the reference the port does not copy)."""
    jcfg, _ = _cfgs()
    eng = JaxEngine(jcfg, _values(), max_seq=16, batch_size=1,
                    knobs=JM.PerfKnobs(remat="none"))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        eng.add_request(0, _tokens(jcfg.vocab, 2)[0])


def test_decode_launch_counts():
    """K1 calls of one decode step, counted by ``analysis.counting`` on the
    CPU: an SSM layer's six projections (``decode_launches``), no K2 under
    any ``attn``, and nothing unpaired."""
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    paired, _ = pair_params(model, 0.0)
    for attn in ("xla", "pallas_fused"):
        for block_n in (0, 16):
            knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn, pair_block_n=block_n)
            assert analysis.decode_launches(tcfg, "ssm", knobs) == {
                "paired_matmul": 6, "decode_attention": 0, "flash_attention": 0}
            with analysis.counting() as counts:
                TM.decode_step(tcfg, paired, TM.init_cache(tcfg, 2, 8, device="cpu"),
                               torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                               knobs=knobs)
            assert counts["k1_calls"] == 6 * tcfg.n_layers
    assert analysis.decode_launches(tcfg, "ssm", TM.PerfKnobs())["paired_matmul"] == 0
    with pytest.raises(ValueError, match="vlm"):  # a VLM's layers are "dense"
        analysis.decode_launches(tcfg, "vlm", TM.PerfKnobs())


def test_engine_splices_releases_and_scrubs_the_state():
    """A prefill's state lands in its slot whole, the other slot's stays
    zero; release zeroes the slot's state and tails."""
    _, tcfg = _cfgs()
    model = TM.lm_params_from_numpy(_values(), tcfg, device="cpu")
    eng = ServeEngine(tcfg, model, max_seq=16, batch_size=2, knobs=TM.PerfKnobs())
    prompt = _tokens(tcfg.vocab, 5)[0]
    eng.add_request(1, prompt)
    _, want = TM.prefill(tcfg, eng.model, torch.as_tensor(prompt)[None].long())
    assert sorted(eng.cache) == sorted(TM.SSM_ENTRIES)
    for name, t in eng.cache.items():
        assert torch.equal(t[:, 1], want[name][:, 0]), name
        assert not t[:, 0].any(), name
    eng.step()
    assert all(t[:, 1].any() for t in eng.cache.values())
    eng.release_slot(1)
    assert not any(t[:, 1].any() for t in eng.cache.values())


def test_init_lm_ssm_block_follows_the_reference_init():
    """The port's own seeded init: the JAX package's shapes, ``A_log =
    log(1…H)``, ``dt`` in [dt_min, dt_max], pass-through B/C convs."""
    _, tcfg = _cfgs()
    s = tcfg.ssm
    model = TM.init_lm(tcfg, 0, device="cpu")
    want = _values()["segments"][0]["mamba"]
    m = model.layers[0].mamba
    for name, arr in want.items():
        assert tuple(getattr(m, name).shape) == arr.shape[1:], name
    H = s.expand * tcfg.d_model // s.head_dim
    assert torch.equal(m.A_log, torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert bool(((dt >= s.dt_min * 0.999) & (dt <= s.dt_max * 1.001)).all())
    assert torch.equal(m.conv_B[-1], torch.ones(m.conv_B.shape[1]))
    assert not m.conv_B[:-1].any()
    assert not hasattr(model.layers[0], "ln2") and model.layers[0].ffn is None
    again = TM.init_lm(tcfg, 0, device="cpu")
    assert torch.equal(again.layers[1].mamba.w_x, model.layers[1].mamba.w_x)


def test_cli_serves_mamba2_smoke(capsys):
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--pair-rounding", "0.05", "--steps", "4", "--prompt-lens", "2,11"])
    out = capsys.readouterr().out
    assert "paired-kernel LM path (structured" in out and "across 6 decoder weights" in out
    assert "slot 0: prompt 2 toks" in out and "8 tokens in" in out
