"""The port's LM training path against the JAX package's.

Same numpy inputs through ``repro`` and ``repro_torch``: the JAX package's
seeded smoke init, handed to the port by ``lm_params_from_numpy``, and a
seeded numpy batch; JAX on the CPU, its Pallas kernels in interpret mode
(as its own tests run them), the port's kernels as their plain versions.

* the token stream, bit for bit, over seeds, steps and shards;
* ``chunked_xent`` (a chunk that does not divide S, masked labels, the
  padded vocab) within 1e-6 relative;
* ``lm_loss`` at the smoke config of the dense, MoE, SSM and hybrid
  families under ``gemm="xla"``: loss, xent and aux within 1e-5 relative;
* ``lm_loss`` and every weight's gradient under ``gemm="pallas"``,
  ``"pallas_paired"`` structured and column-blocked, against ``jax.grad``
  of the JAX ``lm_loss`` under the same policy, fp32, at r = 0 and r = 0.05
  (the JAX package's own metadata): loss within 1e-5 relative, gradients
  within rtol 1e-4, atol 1e-5 (``test_lm_loss_grad_r0_parity``'s);
* the three remat modes: equal losses and gradients, to the bit;
* K1 calls of a training step against ``analysis.train_launches``, the
  MoE families' expert grid among them;
* ``pair_model_params``: folded leaves equal to the JAX function's to the
  bit, the report leaf for leaf.
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
from repro.data import tokens as j_tokens
from repro.kernels.ops import perf_context
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch.analysis import counting, train_launches
from repro_torch.configs import get_smoke_config
from repro_torch.core import transform as t_transform
from repro_torch.data import tokens as t_tokens
from repro_torch.models import lm as TM

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # the JAX package's test_lm_loss_grad_r0_parity
XENT_RTOL = 1e-6
B, S = 2, 7
CHUNK = 4  # flash-attention blocks: two, the second ragged


def _values(arch="qwen2-1.5b", scale=1.0, cfg=None):
    """JAX smoke values (numpy, fp32) of ``arch`` (or of the JAX config
    ``cfg``); the layer matrices (attention's, MLA's, the MLP's, the
    experts' and shared experts', the SSM block's and the cross-attention's,
    the encoder's too) times ``scale`` (0.3 makes every pairing mode pair
    lanes at r = 0.05), random biases and norm scales so their gradients
    carry signal."""
    cfg = cfg or dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    rng = np.random.default_rng(0)

    def block(sub: dict):
        for name, a in sub.items():
            if isinstance(a, dict):  # an MoE layer's shared experts
                block(a)
            elif name.startswith("w"):
                sub[name] = (a * scale).astype(np.float32)
            elif name.startswith("b"):
                sub[name] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)

    for seg in vals["segments"] + vals.get("encoder", {}).get("segments", []):
        for sub in ("attn", "mlp", "moe", "mamba", "xattn"):
            block(seg.get(sub, {}))
        for norm in ("ln1", "ln2"):
            if norm in seg:
                seg[norm]["scale"] = (1 + 0.1 * rng.normal(size=seg[norm]["scale"].shape)
                                      ).astype(np.float32)
    return cfg, vals


def _batch(vocab, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, 2] = labels[1, -1] = -1  # masked positions
    return tokens, labels


def _port(cfg, values, knobs, tokens, labels, extras=None):
    """The port's loss, metrics and gradients (by parameter name);
    ``extras`` the numpy ``frames`` or ``patches`` beside the tokens."""
    model = TM.lm_params_from_numpy(values, cfg, device="cpu")
    model.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
             "labels": torch.as_tensor(labels, dtype=torch.int64),
             **{k: torch.as_tensor(v) for k, v in (extras or {}).items()}}
    loss, metrics = TM.lm_loss(cfg, model, batch, knobs=knobs)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


@functools.cache
def _jax_loss_and_grad(cfg, knobs):
    def f(p, batch):
        with perf_context(knobs):
            return JM.lm_loss(cfg, p, batch, knobs=knobs)

    return jax.jit(jax.value_and_grad(f, has_aux=True, allow_int=True))


def _jax(cfg, values, knobs, tokens, labels, extras=None):
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             **{k: jnp.asarray(v) for k, v in (extras or {}).items()}}
    (loss, metrics), grads = _jax_loss_and_grad(cfg, knobs)(
        jax.tree.map(jnp.asarray, values), batch)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_grad_tree(cfg, grads):
    """The port's gradients (by parameter name) in the JAX value tree's
    layout: the top-level leaves nested by name (``embed``, ``lm_head``,
    ``final_norm``, ``meta``, ``vision_proj``, the encoder's norm), each
    segment's per-layer gradients stacked, the encoder's segment too."""
    def stacked(prefix: str, segments) -> list:
        out, start = [], 0
        for _, count in segments:
            seg: dict = {}
            for name, g in grads.items():
                if not name.startswith(prefix + "."):
                    continue
                parts = name[len(prefix) + 1:].split(".")
                if not start <= int(parts[0]) < start + count:
                    continue
                node = seg
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node.setdefault(parts[-1], []).append(g)
            out.append(jax.tree.map(np.stack, seg, is_leaf=lambda x: isinstance(x, list)))
            start += count
        return out

    tree: dict = {}
    for name, g in grads.items():
        parts = name.split(".")
        if "layers" in parts:
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = g
    tree["segments"] = stacked("layers", cfg.segments())
    if cfg.encoder is not None:
        tree["encoder"]["segments"] = stacked("encoder.layers",
                                              (("dense", cfg.encoder.n_layers),))
    return tree


def _assert_grads(got_tree, jax_grads, what):
    """Every float gradient of the JAX tree against the port's."""
    flat = jax.tree_util.tree_flatten_with_path(jax_grads)[0]
    checked = 0
    for path, g in flat:
        if any(str(getattr(k, "key", "")).endswith("_pairing") for k in path):
            continue  # pairing metadata: frozen structure, no gradient
        g = np.asarray(g)
        node = got_tree
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what}: {jax.tree_util.keystr(path)}")
        checked += 1
    return checked


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (1, 5, 0), (7, 123, 3), (2**20, 99, 17)])
def test_token_stream_bit_identical(seed, step, shard):
    for batch, seq, vocab in ((4, 32, 256), (3, 17, 151936)):
        want = j_tokens.synthetic_tokens(batch, seq, vocab, seed=seed, step=step, shard=shard)
        got = t_tokens.synthetic_tokens(batch, seq, vocab, seed=seed, step=step, shard=shard)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shard_index,shard_count,start", [(0, 1, 0), (1, 2, 3), (3, 4, 10)])
def test_token_batches_bit_identical(shard_index, shard_count, start):
    kw = dict(seed=1, start_step=start, shard_index=shard_index, shard_count=shard_count)
    want = j_tokens.token_batches(8, 16, 1000, **kw)
    got = t_tokens.token_batches(8, 16, 1000, **kw)
    for _ in range(3):
        (wt, wl), (gt, gl) = next(want), next(got)
        assert np.array_equal(gt, wt) and np.array_equal(gl, wl)


def test_token_batches_refuses_a_batch_the_shards_do_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        next(t_tokens.token_batches(6, 16, 100, shard_count=4))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 0, 16])
def test_chunked_xent_matches_jax(chunk):
    """S = 7 in chunks of 3 (padded to 9), one chunk, a chunk past S; masked
    positions; the padded vocab rows (256 of the smoke vocab's 256 + 0: the
    tied embedding holds Vp = 256 rows, so a vocab cut to 200 leaves 56
    padded rows the loss must mask)."""
    cfg, vals = _values()
    cfg = dataclasses.replace(cfg, vocab=200)
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32", vocab=200)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    want = JM.chunked_xent(cfg, jax.tree.map(jnp.asarray, vals), jnp.asarray(h),
                           jnp.asarray(labels), jnp.asarray(mask), chunk)
    model = TM.lm_params_from_numpy(vals, tcfg, device="cpu")
    got = TM.chunked_xent(tcfg, model, torch.as_tensor(h), torch.as_tensor(labels).long(),
                          torch.as_tensor(mask), chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=XENT_RTOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "mamba2-2.7b", "hymba-1.5b"])
def test_lm_loss_matches_jax_per_family(arch):
    """gemm="xla", remat "full", xent chunks of 4 (S = 7): loss, xent and
    the router aux within 1e-5 relative (olmoe's prompt of 2 × 7 tokens
    routes: T·K = 56 > 2E = 32)."""
    cfg, vals = _values(arch)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tokens, labels = _batch(cfg.vocab)
    jk = JM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4)
    tk = TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4)
    want_loss, want, _ = _jax(cfg, vals, jk, tokens, labels)
    got_loss, got, _ = _port(tcfg, vals, tk, tokens, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, atol=1e-7)
    if cfg.moe is not None:
        assert got["aux"] > 0


POLICIES = [("pallas", "structured", 0), ("pallas_paired", "structured", 0),
            ("pallas_paired", "column_blocked", 16)]


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("gemm,mode,block_n", POLICIES)
def test_lm_loss_and_grads_match_jax(gemm, mode, block_n, rounding):
    """Every weight's gradient under the K1 policies against ``jax.grad`` of
    the JAX ``lm_loss`` under the same policy (its Pallas kernels in
    interpret mode, its pairing metadata carried over at r = 0.05)."""
    cfg, vals = _values(scale=0.3 if rounding else 1.0)
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    if gemm == "pallas_paired":
        vals, rep = j_transform.pair_lm_params(vals, rounding, mode=mode, block_n=block_n)
        assert (rep.total_pairs > 0) == (rounding > 0)
    tokens, labels = _batch(cfg.vocab)
    kw = dict(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4, gemm=gemm, pair_block_n=block_n)
    want_loss, want, want_grads = _jax(cfg, vals, JM.PerfKnobs(remat="none", **kw),
                                       tokens, labels)
    got_loss, got, got_grads = _port(tcfg, vals, TM.PerfKnobs(**kw), tokens, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=LOSS_RTOL)
    n = _assert_grads(_port_grad_tree(tcfg, got_grads), want_grads, f"{gemm} {mode} r={rounding}")
    assert (n, len(got_grads)) == (14, 26)  # the stacked leaves hold both layers' 12 each


def test_lm_loss_under_k1_matches_xla_at_r0():
    """At r = 0 every policy computes the plain path's loss and gradients
    (the port alone: K1's plain versions against torch.matmul)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    _, vals = _values()
    tokens, labels = _batch(cfg.vocab)
    kw = dict(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4)
    want_loss, _, want = _port(cfg, vals, TM.PerfKnobs(**kw), tokens, labels)
    for gemm, mode, block_n in POLICIES:
        v = vals
        if gemm == "pallas_paired":
            v, _ = j_transform.pair_lm_params(vals, 0.0, mode=mode, block_n=block_n)
        loss, _, grads = _port(cfg, v, TM.PerfKnobs(gemm=gemm, pair_block_n=block_n, **kw),
                               tokens, labels)
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{gemm} {mode}: {name}")


@pytest.mark.parametrize("gemm,block_n", [("xla", 0), ("pallas", 0), ("pallas_paired", 16)])
def test_remat_modes_give_equal_loss_and_grads(gemm, block_n):
    """"full", "dots" and "none" rerun or keep the same values: the loss and
    every gradient equal to the bit."""
    cfg, vals = _values(scale=0.3)
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    if gemm == "pallas_paired":
        vals, _ = j_transform.pair_lm_params(vals, 0.05, mode="column_blocked", block_n=block_n)
    tokens, labels = _batch(cfg.vocab)
    runs = {remat: _port(tcfg, vals, TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, xent_chunk=4,
                                                  gemm=gemm, pair_block_n=block_n,
                                                  remat=remat), tokens, labels)
            for remat in ("none", "full", "dots")}
    loss, _, grads = runs["none"]
    for remat in ("full", "dots"):
        assert runs[remat][0] == loss
        for name, g in grads.items():
            assert np.array_equal(runs[remat][2][name], g), (remat, name)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch,gemm", [("qwen2-1.5b", "pallas"), ("qwen2-1.5b", "pallas_paired"),
                                       ("mamba2-2.7b", "pallas_paired"), ("hymba-1.5b", "pallas"),
                                       ("olmoe-1b-7b", "pallas_paired"),
                                       ("deepseek-v2-lite-16b", "pallas_paired"),
                                       ("deepseek-v2-lite-16b", "pallas")])
def test_k1_calls_of_a_training_step(arch, gemm, remat):
    """A training step calls K1 as ``analysis.train_launches`` says it
    launches it: each layer GEMM's forward once (an MoE layer's three
    expert-grid launches under "pallas_paired", on the routed branch here:
    2 × 7 tokens at top-2 of 8 experts), again in the recompute under remat
    "full", never in the backward."""
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train.optimizer import adamw

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = TM.init_lm(cfg, 0, device="cpu")
    if gemm == "pallas_paired":
        model, _ = pair_lm_params(model, 0.0)
    knobs = TM.PerfKnobs(q_chunk=CHUNK, k_chunk=CHUNK, gemm=gemm, remat=remat)
    step = build_train_step(cfg, adamw(1e-3), knobs)
    opt_state = step.init(model)
    tokens = torch.as_tensor(_batch(cfg.vocab)[0], dtype=torch.int64)
    with counting() as c:
        metrics = step(model, opt_state, 0, {"tokens": tokens, "labels": tokens})
    assert c["k1_calls"] == train_launches(cfg, knobs) > 0
    assert c["k1_launches"] == 0  # the CPU runs the plain versions
    assert set(metrics) == {"loss", "xent", "aux"}
    if cfg.moe is not None:
        assert metrics["aux"] > 0  # the routed branch


# ---------------------------------------------------------------------------
# pair_model_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,block_n,rounding", [("per_column", 0, 0.05), ("structured", 0, 0.1),
                                                   ("column_blocked", 4, 0.05),
                                                   ("per_column", 0, 0.0)])
def test_pair_model_params_matches_jax(mode, block_n, rounding):
    """The JAX LM value tree (8 layers, so the stacked norm scales are
    eligible too) with a LeNet-style conv leaf: every leaf equal to the
    JAX function's to the bit, the report leaf for leaf."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32", n_layers=8)
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    vals["conv"] = {"w": np.random.default_rng(1).normal(size=(5, 5, 3, 16)).astype(np.float32),
                    "b": np.zeros(16, np.float32)}
    want, want_rep = j_transform.pair_model_params(vals, rounding, mode=mode, block_n=block_n)
    got, got_rep = t_transform.pair_model_params(vals, rounding, mode=mode, block_n=block_n)
    w_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    g_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g_flat] == [
        jax.tree_util.keystr(p) for p, _ in w_flat]
    for (path, w), (_, g) in zip(w_flat, g_flat, strict=True):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w)), path
    fields = lambda rep: [(lf.path, lf.shape, lf.n_weights, lf.n_pairs, lf.pair_fraction)
                          for lf in rep.leaves]
    assert fields(got_rep) == fields(want_rep) and len(got_rep.leaves) == 8
    assert got_rep.total_pairs == want_rep.total_pairs
    assert (got_rep.total_pairs > 0) == (rounding > 0)


def test_pair_model_params_keeps_tensors_on_their_device_and_dtype():
    tree = {"a": torch.randn(16, 12), "b": [torch.randn(3, 3, 2, 8, dtype=torch.float64)],
            "n": torch.arange(64).reshape(8, 8), "s": torch.randn(16)}
    got, rep = t_transform.pair_model_params(tree, 0.1, keep_pairings=True)
    assert got["a"].dtype == torch.float32 and got["b"][0].dtype == torch.float64
    assert got["n"] is tree["n"] and got["s"] is tree["s"]  # ints and vectors pass through
    assert [lf.path for lf in rep.leaves] == ["['a']", "['b'][0]"]
    assert all(lf.pairing is not None for lf in rep.leaves)
    with pytest.raises(ValueError, match="block_n"):
        t_transform.pair_model_params(tree, 0.1, mode="column_blocked")


# ---------------------------------------------------------------------------
# the fold's gradient, trainable weights beside frozen serving copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocked", [False, True])
def test_fold_gradient_reaches_w_only_through_live_lanes(blocked):
    """``fold_lm_weight`` scatter-adds into zeros: padded lanes point at row
    0 with a zero mask, so padding the lane lists changes neither the fold
    nor the gradient of ``w`` (row 0's included)."""
    from repro_torch.core.pairing import pair_rows_blocked, pair_rows_structured
    from repro_torch.core.transform import _stack_blocked, _stack_structured
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    w64 = rng.normal(size=(24, 12)) * 0.1
    w64[0] = w64[1] + 1e-4  # row 0 pairs with row 1: padding lanes alias a live row
    p = pair_rows_blocked(w64, 0.05, 4) if blocked else pair_rows_structured(w64, 0.3)
    stack = _stack_blocked if blocked else _stack_structured
    meta = {k: torch.as_tensor(v[0]) for k, v in stack([p]).items()}
    pad = {k: torch.as_tensor(np.concatenate(
        [v[0], np.zeros((*v[0].shape[:-1], 3), v.dtype)], axis=-1))
        for k, v in stack([p]).items()}
    assert int(meta["pair_mask"].sum()) > 0 and pad["I"].shape[-1] == meta["I"].shape[-1] + 3
    bn = 4 if blocked else 0
    cot = torch.as_tensor(rng.normal(size=(24, 12)), dtype=torch.float32)
    outs = []
    for m in (meta, pad):
        m = {k: v.long() if k in ("I", "J", "resid") else v.float() for k, v in m.items()}
        w = torch.as_tensor(w64, dtype=torch.float32).requires_grad_()
        folded = ops.fold_lm_weight(w, m, bn)
        (g,) = torch.autograd.grad(folded, w, cot)
        outs.append((folded.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_trainable_weights_leave_the_serving_copies_untracked():
    """``TrainStep.init`` makes the weights trainable; an engine serving the
    same weights (a frozen copy sharing them) tracks no gradient."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.train.optimizer import adamw

    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = TM.init_lm(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    step = build_train_step(cfg, adamw(1e-3), TM.PerfKnobs(gemm="pallas_paired"))
    opt_state = step.init(model)
    assert all(p.requires_grad for p in model.parameters())
    eng = ServeEngine(cfg, model, max_seq=16, batch_size=1,
                      knobs=TM.PerfKnobs(gemm="pallas_paired", q_chunk=8, k_chunk=8))
    eng.add_request(0, np.arange(5, dtype=np.int32))
    eng.step()
    assert not any(t.requires_grad for t in eng.cache.values())
    tokens = torch.as_tensor(_batch(cfg.vocab)[0], dtype=torch.int64)
    before = eng.model.embed.detach().clone()
    step(model, opt_state, 0, {"tokens": tokens, "labels": tokens})
    assert not torch.equal(eng.model.embed, before)  # the engine serves the live weights
