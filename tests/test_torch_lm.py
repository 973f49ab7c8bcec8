"""The port's LM (prefill, decode_step) against the JAX package's, in fp32.

Both packages compute from the same weights: the JAX package's seeded
qwen2 smoke init (2 layers, d=64), with random biases and norm scales put
in so those paths carry signal, handed to the port through
``lm_params_from_numpy``.  A prompt batch is prefilled (q/k chunks of 4, so
flash attention runs several ragged blocks), then two decode steps run with
the slots at different positions.

* r=0, every gemm × attn schedule of the port (structured, and column-blocked
  with the fused QKV launch at bn=16 and bn=1), against the JAX package's
  plain path: logits within 1e-5 of the largest logit;
* r=0.05 on the JAX package's own pairing metadata (carried over as
  ``<name>_pairing`` siblings): the paired port against the JAX plain path
  on the folded weights (the fold of ``fold_lm_weight``), within 1e-5.  The matrices
  are scaled by 0.3 so that every mode pairs lanes at that rounding (at the
  init's scale only per-column pairing would).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import transform as j_transform
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch.configs import get_smoke_config
from repro_torch.core.transform import pair_lm_params
from repro_torch.kernels.ref import rel_err
from repro_torch.models import lm as TM

RTOL = 1e-5
PROMPT = 7
MAX_SEQ = 16
CHUNK = 4
POS = [(PROMPT, 4), (PROMPT + 1, 5)]  # the two slots' positions, per step
STEP_TOKENS = [(3, 200), (17, 42)]


def _values(scale: float = 1.0):
    """JAX smoke values (numpy) with random biases and norm scales."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    seg = vals["segments"][0]
    for sub in ("attn", "mlp"):
        for name, a in seg[sub].items():
            seg[sub][name] = a * scale if name.startswith("w") else (
                0.1 * rng.normal(size=a.shape)).astype(np.float32)
    for norm in (seg["ln1"], seg["ln2"], vals["final_norm"]):
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return cfg, vals


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, size=(2, PROMPT)).astype(np.int32)


@functools.cache
def _jax_steps(cfg):
    """The JAX package's plain prefill and decode step, compiled once."""
    knobs = JM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, remat="none")
    prefill = jax.jit(lambda p, t: JM.prefill(cfg, p, {"tokens": t}, knobs=knobs))
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(cfg, p, c, t, s))
    return prefill, decode


def _jax_run(cfg, vals):
    """Prefill + two decode steps on the JAX package's plain path."""
    prefill, decode = _jax_steps(cfg)
    params = jax.tree.map(jnp.asarray, vals)
    logits, pre = prefill(params, jnp.asarray(_tokens(cfg.vocab)))
    cache = unzip(JM.init_cache(cfg, 2, MAX_SEQ))[0]
    seg = {k: v.at[:, :, :PROMPT].set(pre["segments"][0][k]) for k, v in
           cache["segments"][0].items()}
    cache = {"segments": [seg]}
    out = [np.asarray(logits)]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(logits))
    return out


def _port_run(model, knobs):
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    tokens = torch.as_tensor(_tokens(cfg.vocab), dtype=torch.int64)
    logits, pre = TM.prefill(cfg, model, tokens, knobs=knobs)
    cache = TM.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    for name in ("k", "v"):
        cache[name][:, :, :PROMPT] = pre[name]
    out = [logits]
    for pos, tok in zip(POS, STEP_TOKENS, strict=True):
        logits, cache = TM.decode_step(cfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.tensor(pos, dtype=torch.int32), knobs=knobs)
        out.append(logits)
    return out


def _fold(w2, meta, block_n):
    """numpy fold of one layer's (K, N) weight under its pairing (the JAX
    package's ``fold_lm_weight``, column block by column block): paired
    rows become ±(W[I] − W[J]) / 2, residual rows pass through."""
    lanes = [meta[k] for k in ("I", "J", "resid", "pair_mask", "resid_mask")]
    if meta["I"].ndim == 1:  # structured: one block of every column
        lanes, block_n = [a[None] for a in lanes], w2.shape[1]
    wf = np.zeros_like(w2)
    for b, (I, J, R, pm, rm) in enumerate(zip(*lanes, strict=True)):
        cols = slice(b * block_n, (b + 1) * block_n)
        wb, out = w2[:, cols], wf[:, cols]
        kmat = (wb[I] - wb[J]) * np.float32(0.5) * pm[:, None]
        np.add.at(out, I, kmat)
        np.add.at(out, J, -kmat)
        np.add.at(out, R, wb[R] * rm[:, None])
    return wf


def _knobs(gemm, attn, block_n):
    return TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, gemm=gemm, attn=attn,
                        pair_block_n=block_n)


@pytest.fixture(scope="module")
def r0():
    cfg, vals = _values()
    return vals, _jax_run(cfg, vals)


SCHEDULES = [
    ("xla", "xla", 0),
    ("xla", "pallas_fused", 0),
    ("pallas_paired", "xla", 0),
    ("pallas_paired", "xla", 16),
    ("pallas_paired", "pallas_fused", 0),
    ("pallas_paired", "pallas_fused", 16),
    ("pallas_paired", "pallas_fused", 1),
]


@pytest.mark.parametrize("gemm,attn,block_n", SCHEDULES)
def test_r0_logits_match_jax(r0, gemm, attn, block_n):
    vals, want = r0
    cfg = get_smoke_config("qwen2-1.5b")
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    if gemm == "pallas_paired":
        mode = "column_blocked" if block_n else "structured"
        model, report = pair_lm_params(model, 0.0, mode=mode, block_n=block_n)
        assert len(report.leaves) == 7
    got = _port_run(model, _knobs(gemm, attn, block_n))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert rel_err(g, w) <= RTOL


@pytest.mark.parametrize("attn", ["xla", "pallas_fused"])
@pytest.mark.parametrize("mode,block_n", [("structured", 0), ("column_blocked", 16),
                                          ("column_blocked", 1)])
def test_r005_paired_matches_fold_oracle(mode, block_n, attn):
    cfg, vals = _values(scale=0.3)
    paired, report = j_transform.pair_lm_params(vals, 0.05, mode=mode, block_n=block_n)
    assert all(leaf.n_pairs > 0 for leaf in report.leaves)
    # the oracle: every paired weight replaced by its fold, the plain path
    folded = jax.tree.map(np.asarray, paired)
    seg = folded["segments"][0]
    for sub in ("attn", "mlp"):
        for name in [n for n in seg[sub] if n.endswith("_pairing")]:
            meta = seg[sub].pop(name)
            w = seg[sub][name[: -len("_pairing")]]
            for l in range(w.shape[0]):
                K = w[l].size // w[l].shape[-1] if name.startswith("wo") else w[l].shape[0]
                wf = _fold(w[l].reshape(K, -1), {k: v[l] for k, v in meta.items()}, block_n)
                w[l] = wf.reshape(w[l].shape)
    want = _jax_run(cfg, folded)
    model = TM.lm_params_from_numpy(jax.tree.map(np.asarray, paired),
                                    get_smoke_config("qwen2-1.5b"), device="cpu")
    got = _port_run(model, _knobs("pallas_paired", attn, block_n))
    for g, w in zip(got, want, strict=True):
        assert rel_err(g, w) <= RTOL


def test_bf16_prefill_tracks_fp32():
    """bf16 compute (the serving dtype) on the same weights stays close to
    the fp32 logits: the rounding points are the JAX package's, the bound is
    bf16 noise across two layers."""
    cfg = get_smoke_config("qwen2-1.5b")
    _, vals = _values()
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    model, _ = pair_lm_params(model, 0.0)
    tokens = torch.as_tensor(_tokens(cfg.vocab), dtype=torch.int64)
    knobs = _knobs("pallas_paired", "pallas_fused", 0)
    lo, _ = TM.prefill(cfg, model, tokens, knobs=knobs)
    hi, _ = TM.prefill(dataclasses.replace(cfg, dtype="float32"), model, tokens, knobs=knobs)
    assert lo.dtype == torch.float32 and torch.isfinite(lo).all()
    assert rel_err(lo, hi) <= 0.05


def test_init_lm_is_seeded_and_scaled():
    cfg = get_smoke_config("qwen2-1.5b")
    a, b = TM.init_lm(cfg, 3, device="cpu"), TM.init_lm(cfg, 3, device="cpu")
    c = TM.init_lm(cfg, 4, device="cpu")
    assert torch.equal(a.layers[1].mlp.w_down, b.layers[1].mlp.w_down)
    assert not torch.equal(a.layers[1].mlp.w_down, c.layers[1].mlp.w_down)
    w = a.layers[0].mlp.w_gate  # (d, f), fan-in d: truncated normal / sqrt(d)
    assert tuple(w.shape) == (cfg.d_model, cfg.d_ff)
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05  # std of N(0,1) cut at ±2
    assert tuple(a.embed.shape) == (TM.padded_vocab(cfg), cfg.d_model)
    assert not a.layers[0].attn.bq.any()


def test_knobs_reject_unknown_schedules():
    with pytest.raises(ValueError, match="knobs.attn"):
        TM.PerfKnobs(attn="fused")
    with pytest.raises(ValueError, match="knobs.gemm"):
        TM.PerfKnobs(gemm="pallas")
