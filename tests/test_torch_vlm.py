"""The port's vision-language family (internvl2-2b: precomputed patch
embeddings through ``vision_proj`` at the first ``vision_prefix``
positions, then the text) against the JAX package's, in fp32.

Both packages compute from the same numpy inputs: the JAX package's seeded
internvl2 smoke init (2 layers, d=64, 4 heads over 2 KV heads, 8 patch
positions of 1024 lanes, an ``lm_head`` of its own) with random norm scales,
handed to the port through ``lm_params_from_numpy``, and the stub patches
of ``launch.inputs.make_batch``.  The JAX package's Pallas GEMMs run in
interpret mode.

* the config and the patch inputs, bit for bit;
* the patch prefix of the embedded inputs; ``lm_forward``, the prefill's
  cache and two decode steps within 1e-5;
* ``lm_loss`` (patch positions masked) and every gradient under
  ``gemm="xla"`` and ``"pallas"`` against ``jax.grad``;
* the engine with ``extras`` token for token against the JAX engine; its
  refusal of a prompt no longer than the patch prefix;
* the pairing metadata, index for index; decode launches; the CLI.
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
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import analysis
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.core.transform import pair_params
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as TM
from repro_torch.serving.engine import CapacityError, ServeEngine

RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # the JAX package's test_lm_loss_grad_r0_parity
ARCH = "internvl2-2b"
VP = 8  # the smoke config's patch positions
PROMPT, MAX_SEQ = 14, 24
KNOBS = dict(q_chunk=8, k_chunk=8)
MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 3)]


def _cfgs():
    return (dataclasses.replace(j_configs.get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(t_configs.get_smoke_config(ARCH), dtype="float32"))


@functools.cache
def _values(scale: float = 1.0):
    """The JAX smoke init as numpy, random norm scales, the layer matrices
    times ``scale``."""
    cfg, _ = _cfgs()
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)
    norms = [vals["final_norm"]]
    for seg in vals["segments"]:
        norms += [seg["ln1"], seg["ln2"]]
        for sub in ("attn", "mlp"):
            seg[sub] = {k: (v * np.float32(scale)).astype(np.float32) for k, v in seg[sub].items()}
    for norm in norms:
        norm["scale"] = (1 + 0.1 * rng.normal(size=norm["scale"].shape)).astype(np.float32)
    return vals


def _model(scale: float = 1.0):
    _, tcfg = _cfgs()
    return tcfg, TM.lm_params_from_numpy(_values(scale), tcfg, device="cpu")


def _patches(batch: int = 2):
    _, tcfg = _cfgs()
    return t_inputs.make_batch(tcfg, batch, 1, "prefill", seed=1, device="cpu")["patches"]


def _tokens(vocab, n=PROMPT):
    return np.random.default_rng(1).integers(0, vocab, size=(2, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# config and inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    assert {f.name for f in dataclasses.fields(ref)} == {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.segments() == ref.segments() == (("dense", port.n_layers),)
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    assert not port.tie_embeddings and port.vision_embed_dim == 1024
    if get == "get_config":
        assert (port.vision_prefix, port.n_layers, port.d_model) == (256, 24, 2048)
    base = dataclasses.asdict(port)
    with pytest.raises(ValueError, match="vlm"):
        t_base.ModelConfig(**{**base, "vision_prefix": 0})


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_equals_jax(kind, dtype):
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs())
    want = j_inputs.make_batch(jcfg, 2, 11, kind, seed=4)
    got = t_inputs.make_batch(tcfg, 2, 11, kind, seed=4, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["patches"].shape == (2, VP, 1024) and got["patches"].dtype == getattr(torch, dtype)
    for name, t in got.items():
        w = np.asarray(jnp.asarray(want[name], jnp.float32) if name == "patches" else want[name])
        np.testing.assert_array_equal(t.float().numpy() if name == "patches" else t.numpy(), w,
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the patch prefix, forward, prefill and decode
# ---------------------------------------------------------------------------


def test_patch_prefix_replaces_the_first_positions():
    """The embedded inputs: ``patches @ vision_proj`` at the first 8
    positions, the token embeddings after them (the tokens under the
    patches never read); the positions count from 0 over both."""
    tcfg, model = _model()
    tokens = torch.as_tensor(_tokens(tcfg.vocab)).long()
    h, positions, enc_out = TM._prepare_inputs(tcfg, model, tokens, {"patches": _patches()},
                                               TM.PerfKnobs())
    assert enc_out is None and h.shape == (2, PROMPT, tcfg.d_model)
    want = _patches().numpy() @ _values()["vision_proj"]
    assert rel_err(h[:, :VP], want) <= RTOL
    assert torch.equal(h[:, VP:], model.embed[tokens[:, VP:]])  # an lm_head: no sqrt(d) scale
    assert torch.equal(positions[0], torch.arange(PROMPT))
    other = tokens.clone()
    other[:, :VP] = 0
    assert torch.equal(TM._prepare_inputs(tcfg, model, other, {"patches": _patches()},
                                          TM.PerfKnobs())[0], h)


@functools.cache
def _jax_forward():
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _values())
    knobs = JM.PerfKnobs(**KNOBS, remat="none")
    batch = {"tokens": jnp.asarray(_tokens(jcfg.vocab)),
             "patches": jnp.asarray(_patches().numpy())}
    full, _, _ = jax.jit(lambda p, b: JM.lm_forward(jcfg, p, b, knobs=knobs))(params, batch)
    logits, pre = jax.jit(lambda p, b: JM.prefill(jcfg, p, b, knobs=knobs))(params, batch)
    cache = unzip(JM.init_cache(jcfg, 2, MAX_SEQ))[0]
    seg = {k: v.at[:, :, :PROMPT].set(pre["segments"][0][k])
           for k, v in cache["segments"][0].items()}
    cache = {"segments": [seg]}
    decode = jax.jit(lambda p, c, t, s: JM.decode_step(jcfg, p, c, t, s))
    out = [np.asarray(logits)]
    for pos, tok in ((PROMPT, (3, 200)), (PROMPT + 1, (17, 42))):
        logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                               jnp.full((2,), pos, jnp.int32))
        out.append(np.asarray(logits))
    as_np = lambda c: {k: np.asarray(v) for k, v in c["segments"][0].items()}
    return np.asarray(full), as_np(pre), out, as_np(cache)


@pytest.mark.parametrize("gemm,attn,block_n", [
    ("xla", "xla", 0), ("pallas_paired", "xla", 0), ("pallas_paired", "pallas_fused", 0),
    ("pallas_paired", "pallas_fused", 16)])
def test_forward_prefill_and_decode_match_jax(gemm, attn, block_n):
    """``lm_forward`` over the patches and 6 text tokens, the prefill's K/V
    (patch positions included), two decode steps and the cache after them,
    at r=0."""
    want_full, want_pre, want, want_cache = _jax_forward()
    tcfg, model = _model()
    if gemm == "pallas_paired":
        model, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                               block_n=block_n)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_block_n=block_n)
    tokens = torch.as_tensor(_tokens(tcfg.vocab)).long()
    extras = {"patches": _patches()}
    full, _ = TM.lm_forward(tcfg, model, tokens, knobs=knobs, extras=extras)
    assert full.shape == want_full.shape and rel_err(full, want_full) <= RTOL
    logits, pre = TM.prefill(tcfg, model, tokens, knobs=knobs, extras=extras)
    for name in ("k", "v"):
        assert rel_err(pre[name], want_pre[name]) <= RTOL
    cache = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    for name, t in cache.items():
        t[:, :, :PROMPT] = pre[name]
    got = [logits]
    for pos, tok in ((PROMPT, (3, 200)), (PROMPT + 1, (17, 42))):
        logits, cache = TM.decode_step(tcfg, model, cache, torch.tensor(tok)[:, None],
                                       torch.full((2,), pos, dtype=torch.int32), knobs=knobs)
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        assert rel_err(g, w) <= RTOL
    for name, t in cache.items():
        assert rel_err(t, want_cache[name]) <= RTOL, name


def test_forward_needs_patches():
    tcfg, model = _model()
    with pytest.raises(ValueError, match="patches"):
        TM.lm_forward(tcfg, model, torch.zeros((1, 12), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the loss: patch positions masked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,gemm", [(PROMPT, "xla"), (VP + 1, "xla"), (PROMPT, "pallas")])
def test_lm_loss_masks_patches_and_grads_match_jax_grad(seq, gemm):
    """The loss over the text positions only (a masked label among them),
    ``vision_proj``'s gradient and every other's against ``jax.grad``,
    under ``gemm="xla"`` and ``"pallas"`` (the JAX package's Pallas GEMM in
    interpret mode); the labels under the patches do not move the loss."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
    labels[0, -1] = -1
    patches = _patches().numpy()
    knobs = JM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm)

    def f(p, b):
        with perf_context(knobs):
            return JM.lm_loss(jcfg, p, b, knobs=knobs)

    (want, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, _values()),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
         "patches": jnp.asarray(patches)})
    _, model = _model()
    model.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(tokens).long(), "labels": torch.as_tensor(labels).long(),
             "patches": torch.as_tensor(patches)}
    tknobs = TM.PerfKnobs(q_chunk=4, k_chunk=4, gemm=gemm)
    loss, _ = TM.lm_loss(tcfg, model, batch, knobs=tknobs)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    relabelled = dict(batch, labels=batch["labels"].clone())
    relabelled["labels"][:, :VP] = 7  # under the patches: no label is read
    with torch.no_grad():
        assert float(TM.lm_loss(tcfg, model, relabelled, knobs=tknobs)[0]) == float(loss.detach())
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
    assert np.abs(np.asarray(grads["vision_proj"])).max() > 1e-6


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(VP + 1,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(PROMPT,)).astype(np.int32)}


@functools.cache
def _jax_engine_tokens(rounding: float):
    jcfg, _ = _cfgs()
    gemm = "pallas_paired" if rounding else "xla"
    eng = JaxEngine(jcfg, _values(0.3 if rounding else 1.0), max_seq=MAX_SEQ, batch_size=2,
                    knobs=JM.PerfKnobs(**KNOBS, remat="none", gemm=gemm, pair_rounding=rounding))
    extras = {"patches": jnp.asarray(_patches(1).numpy())}
    return eng.generate(_prompts(jcfg.vocab), 6, extras), eng.last_logits


@pytest.mark.parametrize("rounding,gemm,attn", [
    (0.0, "xla", "xla"), (0.0, "pallas_paired", "pallas_fused"),
    (0.05, "pallas_paired", "xla"), (0.05, "pallas_paired", "pallas_fused")])
def test_engine_tokens_match_jax_engine(rounding, gemm, attn):
    """Prompts of 9 (one text token after the patches) and 14 tokens over
    the same stub patches, 6 tokens each."""
    want, want_logits = _jax_engine_tokens(rounding)
    tcfg, model = _model(0.3 if rounding else 1.0)
    knobs = TM.PerfKnobs(**KNOBS, gemm=gemm, attn=attn, pair_rounding=rounding)
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=2, knobs=knobs)
    if rounding:
        assert eng.pair_report.total_pairs > 0
    assert eng.generate(_prompts(tcfg.vocab), 6, {"patches": _patches(1)}) == want
    assert rel_err(eng.last_logits, want_logits) <= RTOL


@pytest.mark.parametrize("plen", [1, VP - 1, VP])
def test_engine_refuses_prompt_no_longer_than_the_patches(plen):
    """The JAX engine keeps 8 patch positions of such a prompt but decodes
    from ``plen``: its first decode writes over a patch's keys.  The port
    refuses it, and takes the prompt one token longer."""
    tcfg, model = _model()
    eng = ServeEngine(tcfg, model, max_seq=MAX_SEQ, batch_size=1, knobs=TM.PerfKnobs(**KNOBS))
    with pytest.raises(CapacityError, match="patch positions"):
        eng.add_request(0, np.ones(plen, np.int32), {"patches": _patches(1)})
    assert not eng.active[0]
    eng.add_request(0, np.ones(VP + 1, np.int32), {"patches": _patches(1)})
    assert eng.pos[0] == VP + 1


def test_jax_engine_decodes_short_prompt_over_patch_keys():
    """What the port refuses: the JAX engine's prefill of a 3-token prompt
    fills 8 cache rows (the patch prefix), but its position is 3, so the
    first decode step writes row 3, a patch's keys."""
    jcfg, _ = _cfgs()
    eng = JaxEngine(jcfg, _values(), max_seq=MAX_SEQ, batch_size=1,
                    knobs=JM.PerfKnobs(**KNOBS, remat="none"))
    eng.add_request(0, np.arange(1, 4, dtype=np.int32),
                    {"patches": jnp.asarray(_patches(1).numpy())})
    k = np.asarray(eng.cache["segments"][0]["k"])[0, 0]
    assert int(eng.pos[0]) == 3 and int((np.abs(k).sum((1, 2)) > 0).sum()) == VP
    before = k[3].copy()
    eng.step()
    assert not np.array_equal(np.asarray(eng.cache["segments"][0]["k"])[0, 0, 3], before)


# ---------------------------------------------------------------------------
# pairing, launch counts, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,block_n", MODES)
def test_pair_params_equal(mode, block_n):
    """r=0.05: the 7 leaves a layer, index for index; ``vision_proj`` is
    not paired (the JAX package's einsum)."""
    values = _values(0.3)
    tcfg, model = _model(0.3)
    ref, ref_report = j_transform.pair_params(values, 0.05, mode=mode, block_n=block_n)
    paired, report = pair_params(model, 0.05, mode=mode, block_n=block_n)
    for sub, name in tcfg.paired_leaves:
        want = ref["segments"][0][sub][name + "_pairing"]
        for l, layer in enumerate(paired.layers):
            got = getattr(layer, sub).pairing[name]
            for key, arr in want.items():
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                              err_msg=f"{sub}.{name}[{l}].{key}")
    assert [(a.path, a.n_pairs) for a in report.leaves] == [
        (b.path, b.n_pairs) for b in ref_report.leaves]
    assert len(report.leaves) == 7 and all(leaf.n_pairs > 0 for leaf in report.leaves)
    assert not paired.pairing and "vision_proj_pairing" not in ref


@pytest.mark.parametrize("attn,block_n,want_k1,want_k2", [
    ("xla", 0, 7, 0), ("pallas_fused", 0, 6, 1), ("pallas_fused", 16, 4, 1)])
def test_decode_launch_counts(attn, block_n, want_k1, want_k2):
    """A VLM decode layer is a dense one."""
    tcfg, model = _model()
    paired, _ = pair_params(model, 0.0, mode="column_blocked" if block_n else "structured",
                            block_n=block_n)
    knobs = TM.PerfKnobs(gemm="pallas_paired", attn=attn, pair_block_n=block_n)
    assert tcfg.layer_kind(0) == "dense"
    assert analysis.decode_launches(tcfg, "dense", knobs) == {
        "paired_matmul": want_k1, "decode_attention": want_k2, "flash_attention": 0}
    assert analysis.prefill_launches(tcfg, knobs) == {
        "paired_matmul": 7 * tcfg.n_layers, "decode_attention": 0, "flash_attention": 0}
    with analysis.counting() as counts:
        TM.decode_step(tcfg, paired, TM.init_cache(tcfg, 2, 8, device="cpu"),
                       torch.tensor([[3], [5]]), torch.tensor([0, 2], dtype=torch.int32),
                       knobs=knobs)
    assert counts["k1_calls"] == want_k1 * tcfg.n_layers


def test_cli_serves_internvl2_smoke(capsys):
    """The default prompts start past the patch prefix (8 + 8 + 4·slot)."""
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gemm", "pallas_paired",
                  "--attn", "pallas_fused", "--pair-rounding", "0.05", "--steps", "3",
                  "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "across 7 decoder weights" in out
    assert "slot 0: prompt 16 toks" in out and "slot 1: prompt 20 toks" in out
