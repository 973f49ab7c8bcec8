"""The port's decode attention against the JAX package's Pallas kernel.

The JAX side runs ``decode_attention_fwd`` / ``fused_decode_attention``
(and the op ``fused_attn_decode`` over them) in interpret mode, on the
cases of ``tests/test_flash_kernel.py`` and ``tests/test_decode_attention.py``;
the port side runs its wrappers on CPU tensors, which take the plain
versions (``decode_attention_plain``, ``fused_decode_attention_plain``).
Same numpy inputs, fp32, within 2e-5 (the JAX decode tests' tolerance);
bf16, bare and fused, within one output ulp of the JAX kernel's output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pairing import pair_rows_blocked as j_pair_rows_blocked
from repro.core.pairing import pair_rows_structured as j_pair_rows_structured
from repro.core.transform import _stack_blocked as j_stack_blocked
from repro.kernels import decode_attention as j_da
from repro.kernels import ops as j_ops
from repro.models import layers as JL
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bf16_ulps
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B=2, S=16, H=4, KH=2, D=8, pos=None):
    rng = np.random.default_rng(seed)
    q, kc, vc = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, 1, H, D), (B, S, KH, D), (B, S, KH, D)))
    pos = np.asarray([3, S - 1] if pos is None else pos, np.int32)
    return rng, (q, kc, vc, pos)


def _both(arrays):
    """The same arrays as JAX arrays and as CPU tensors."""
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,n_sink", [(0, 0), (6, 0), (6, 2)])
@pytest.mark.parametrize("S,k_chunk", [(8, 8), (33, 16)])
def test_bare_attention_matches_jax_kernel(S, k_chunk, window, n_sink):
    """Cache lengths incl. ragged S, slots at 0 / mid / S−1, windows, sinks;
    the port's plain decode attention of the XLA path agrees too."""
    _, arrays = _inputs(S * 10 + window + n_sink, B=3, S=S, D=16, pos=[0, S // 2, S - 1])
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(arrays)
    kw = dict(window=window, n_sink=n_sink)
    want = j_da.decode_attention_fwd(jq, jk, jv, jp, k_chunk=k_chunk, interpret=True, **kw)
    _close(da.decode_attention_cuda(tq, tk, tv, tp, **kw), want)
    _close(TL.decode_attention(tq, tk, tv, tp, **kw), JL.decode_attention(jq, jk, jv, jp, **kw))


def test_fully_masked_slot_is_finite_zero():
    """pos = −1 admits no key: exact zeros, as the JAX kernel flushes."""
    _, arrays = _inputs(11, pos=[-1, 7])
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(arrays)
    got = da.decode_attention_cuda(tq, tk, tv, tp)
    assert torch.isfinite(got).all() and not got[0].any()
    _close(got, j_da.decode_attention_fwd(jq, jk, jv, jp, k_chunk=8, interpret=True))


def test_gqa_non_divisible_heads_raise():
    q, kv = torch.zeros((1, 1, 3, 8)), torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="divide evenly"):
        da.decode_attention_cuda(q, kv, kv, torch.zeros((1,), dtype=torch.int32))


def _meta(w2, rounding, block_n):
    """Single-layer metadata in the stacked-artifact layout: blocked
    (``block_n`` ≥ 1) or structured (0); numpy."""
    if block_n:
        return {k: v[0] for k, v in j_stack_blocked(
            [j_pair_rows_blocked(w2.astype(np.float64), rounding, block_n)]).items()}
    sp = j_pair_rows_structured(w2.astype(np.float64), rounding)
    return {"I": sp.I.astype(np.int32), "J": sp.J.astype(np.int32),
            "resid": sp.resid.astype(np.int32),
            "pair_mask": np.ones(sp.n_pairs, np.float32),
            "resid_mask": np.ones(len(sp.resid), np.float32)}


@pytest.mark.parametrize("rounding,block_n,residual,window,n_sink", [
    (None, 0, True, 0, 0),    # unpaired: the synthesised pure-residual block
    (0.0, 4, True, 0, 0),     # r=0: every lane residual
    (0.3, 1, False, 0, 0),    # rounded: the kernel runs the snapped magnitudes
    (0.3, 5, True, 0, 0),     # 12 columns in blocks of 5: a short last block
    (0.3, 0, True, 0, 0),     # structured metadata lifted to one block
    (None, 0, False, 6, 0),   # sliding window
    (0.3, 4, True, 6, 2),     # window + sinks
])
def test_fused_op_matches_jax(rounding, block_n, residual, window, n_sink):
    """``ops.fused_attn_decode`` (segments, gather, projection, residual)
    against the JAX op, Pallas kernel in interpret mode."""
    rng, arrays = _inputs(int(10 * (rounding or 0)) + block_n, S=24)
    w = (rng.normal(size=(32, 12)) * 0.3).astype(np.float32)  # (H·D, N)
    res = rng.normal(size=(2, 1, 12)).astype(np.float32) if residual else None
    meta = None if rounding is None else _meta(w, rounding, block_n)
    if rounding:
        assert meta["pair_mask"].sum() > 0
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(arrays)
    kw = dict(pair_block_n=block_n, window=window, n_sink=n_sink)
    want = j_ops.fused_attn_decode(
        jq, jk, jv, jp, jnp.asarray(w),
        None if meta is None else {k: jnp.asarray(v) for k, v in meta.items()},
        residual=None if res is None else jnp.asarray(res), k_chunk=8, **kw)
    tmeta = None if meta is None else {
        k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
        for k, v in meta.items()}
    got = ops.fused_attn_decode(tq, tk, tv, tp, torch.as_tensor(w), tmeta,
                                residual=None if res is None else torch.as_tensor(res), **kw)
    assert got.shape == (2, 1, 12)
    _close(got, want)


def test_fused_kernel_api_matches_jax():
    """``fused_decode_attention`` on explicit segments, the kernel's own
    entry point on both sides (bn=4, 3 blocks, a residual)."""
    rng, arrays = _inputs(5, S=20)
    w = (rng.normal(size=(32, 12)) * 0.3).astype(np.float32)
    meta = _meta(w, 0.3, 4)
    jseg = j_ops._attn_outproj_segments(jnp.asarray(w), {k: jnp.asarray(v) for k, v in
                                                         meta.items()}, 4)
    res = rng.normal(size=(2, 12)).astype(np.float32)
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(arrays)
    want = j_da.fused_decode_attention(jq, jk, jv, jp, *jseg, jnp.asarray(res), n_cols=12,
                                       k_chunk=8, interpret=True)
    tseg = [torch.as_tensor(np.array(a)) for a in jseg]
    got = da.fused_decode_attention_cuda(tq, tk, tv, tp, *tseg, torch.as_tensor(res),
                                         n_cols=12)
    _close(got, want)


def test_outproj_segments_match_jax():
    """The normalised segments themselves, index for index, in every layout."""
    w = (np.random.default_rng(3).normal(size=(32, 12)) * 0.3).astype(np.float32)
    for meta, bn in ((None, 0), (_meta(w, 0.3, 0), 0), (_meta(w, 0.3, 5), 5),
                     (_meta(w, 0.0, 4), 4)):
        want = j_ops._attn_outproj_segments(
            jnp.asarray(w), None if meta is None else
            {k: jnp.asarray(v) for k, v in meta.items()}, bn)
        got = ops.attn_outproj_segments(
            torch.as_tensor(w), None if meta is None else
            {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in meta.items()}, bn)
        for g, j in zip(got[:5], want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        assert got.n_cols == 12


def test_blocked_meta_requires_pair_block_n():
    w = np.random.default_rng(5).normal(size=(32, 12)).astype(np.float32)
    meta = {k: torch.as_tensor(v) for k, v in _meta(w, 0.0, 1).items()}
    _, (q, kc, vc, pos) = _both(_inputs(5)[1])
    with pytest.raises(ValueError, match="pair_block_n"):
        ops.fused_attn_decode(q, kc, vc, pos, torch.as_tensor(w), meta)


def test_wrappers_refuse_other_devices():
    q, kv = torch.zeros((1, 1, 2, 8), device="meta"), torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA .* or CPU"):
        da.decode_attention_cuda(q, kv, kv, torch.zeros((1,), dtype=torch.int32, device="meta"))


def _bf16(arrays):
    """The same values as bf16 JAX arrays and bf16 CPU tensors."""
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.as_tensor(a).to(torch.bfloat16) for a in arrays])


BF16_ULPS = 1.0  # one rounding of the output apart, at most


@pytest.mark.parametrize("S", [16, 33, 64])
def test_bare_attention_bf16_matches_jax_kernel(S):
    """bf16 cache and query, slots at 0 / mid / S−1: the plain version
    against the JAX kernel, in output ulps."""
    _, arrays = _inputs(S + 100, B=3, S=S, D=16, pos=[0, S // 2, S - 1])
    (jq, jk, jv), (tq, tk, tv) = _bf16(arrays[:3])
    pos = arrays[3]
    want = j_da.decode_attention_fwd(jq, jk, jv, jnp.asarray(pos), k_chunk=16, interpret=True)
    got = da.decode_attention_cuda(tq, tk, tv, torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, np.asarray(want, np.float32)) <= BF16_ULPS


@pytest.mark.parametrize("S", [16, 33, 64])
def test_fused_op_bf16_matches_jax(S):
    """bf16 through ``ops.fused_attn_decode``, column-blocked bn = 4 at
    r = 0.3 with a residual: the plain version against the JAX op (Pallas
    kernel in interpret mode), in output ulps."""
    rng, arrays = _inputs(S + 200, S=S)
    w = (rng.normal(size=(32, 12)) * 0.3).astype(np.float32)
    res = rng.normal(size=(2, 1, 12)).astype(np.float32)
    meta = _meta(w, 0.3, 4)
    (jq, jk, jv, jw, jr), (tq, tk, tv, tw, tr) = _bf16([*arrays[:3], w, res])
    pos = arrays[3]
    want = j_ops.fused_attn_decode(
        jq, jk, jv, jnp.asarray(pos), jw, {k: jnp.asarray(v) for k, v in meta.items()},
        residual=jr, k_chunk=8, pair_block_n=4)
    tmeta = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in meta.items()}
    got = ops.fused_attn_decode(tq, tk, tv, torch.as_tensor(pos), tw, tmeta, residual=tr,
                                pair_block_n=4)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 12)
    assert bf16_ulps(got, np.asarray(want, np.float32)) <= BF16_ULPS


# ---------------------------------------------------------------------------
# the fused op's gradients (the VJP of the JAX package's fused_attn_decode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,rounding,window,n_sink,residual", [
    (None, 0.0, 0, 0, True),            # unpaired
    (None, 0.0, 6, 2, False),           # unpaired, window + sinks
    ("structured", 0.0, 0, 0, True),    # r=0: every lane residual
    ("structured", 0.05, 6, 2, True),
    ("blocked", 0.0, 6, 0, False),      # bn 1, sliding window
    ("blocked", 0.05, 6, 2, True),      # bn 1, window + sinks
])
def test_fused_op_grads_match_jax_vjp(layout, rounding, window, n_sink, residual):
    """``ops.fused_attn_decode``'s gradients for q, both caches, the live
    out-projection weights and the residual against ``jax.vjp`` of the JAX
    op (its forward the Pallas kernel in interpret mode, its backward the
    XLA reference), for one random cotangent; slots at 0 and S − 1.  rtol
    1e-4 / atol 1e-5, the JAX package's gradient tolerance."""
    block_n = 1 if layout == "blocked" else 0
    rng, arrays = _inputs(31 + block_n + int(100 * rounding) + window + n_sink, S=24,
                          pos=[0, 23])
    # std 0.03: structured pairing pairs rows at r = 0.05
    w = (rng.normal(size=(32, 12)) * 0.03).astype(np.float32)
    res = rng.normal(size=(2, 1, 12)).astype(np.float32) if residual else None
    meta = None if layout is None else _meta(w, rounding, block_n)
    if rounding:
        assert meta["pair_mask"].sum() > 0
    dy = rng.normal(size=(2, 1, 12)).astype(np.float32)
    q, kc, vc, pos = arrays
    kw = dict(pair_block_n=block_n, window=window, n_sink=n_sink)
    jmeta = None if meta is None else {k: jnp.asarray(v) for k, v in meta.items()}

    def f(q, kc, vc, w, res):
        return j_ops.fused_attn_decode(q, kc, vc, jnp.asarray(pos), w, jmeta, residual=res,
                                       k_chunk=8, interpret=True, **kw)

    primals = [q, kc, vc, w] + ([res] if residual else [])
    y, vjp = jax.vjp(lambda *a: f(*a[:4], a[4] if residual else None),
                     *map(jnp.asarray, primals))
    want = vjp(jnp.asarray(dy))
    tmeta = None if meta is None else {
        k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
        for k, v in meta.items()}
    tp = [torch.as_tensor(a).requires_grad_() for a in primals]
    got = ops.fused_attn_decode(tp[0], tp[1], tp[2], torch.as_tensor(pos), tp[3], tmeta,
                                residual=tp[4] if residual else None, **kw)
    _close(got.detach(), y)
    got.backward(torch.as_tensor(dy))
    for name, t, g in zip(("q", "k_cache", "v_cache", "w", "residual"), tp, want,
                          strict=False):  # no residual: four
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tp[1].grad.abs().sum()) > 0  # the keys carry the softmax's gradient


def test_fused_op_backward_is_the_plain_composition():
    """The op's gradients equal autograd of ``fused_attn_decode_ref`` (the
    plain decode attention through the folded out-projection) and take no
    kernel launch; ``pos`` takes none."""
    rng, arrays = _inputs(41, S=20, pos=[0, 13])
    w = (rng.normal(size=(32, 12)) * 0.3).astype(np.float32)
    meta = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
            for k, v in _meta(w, 0.3, 5).items()}
    dy = torch.as_tensor(rng.normal(size=(2, 1, 12)).astype(np.float32))
    grads = []
    for fn in (ops.fused_attn_decode, ops.fused_attn_decode_ref):
        q, kc, vc, tw = (torch.as_tensor(a).requires_grad_() for a in (*arrays[:3], w))
        y = fn(q, kc, vc, torch.as_tensor(arrays[3]), tw, meta, pair_block_n=5, window=8,
               n_sink=2)
        grads.append(torch.autograd.grad(y, (q, kc, vc, tw), dy))
    for g, r in zip(*grads, strict=True):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_decode_layer_differentiates_through_the_fused_op():
    """A decode layer whose block is not frozen, under grad and
    ``attn="pallas_fused"``, calls the differentiable op on the live
    weights: its output and the gradients of the weights equal the unfused
    path's (plain attention, then the out-projection) at r = 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.models import lm as TM

    cfg = get_smoke_config("qwen2-1.5b")
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
    model, _ = pair_lm_params(TM.init_lm(cfg, 0, device="cpu"), 0.0)
    model.requires_grad_(True)
    attn = model.layers[0].attn
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    pos = torch.as_tensor([0, 5])
    outs = []
    for fused in ("xla", "pallas_fused"):
        knobs = TM.PerfKnobs(gemm="pallas_paired", attn=fused)
        cache = {n: torch.as_tensor(rng.normal(size=(2, 8, cfg.n_kv_heads, cfg.head_dim))
                                    .astype(np.float32)) for n in ("k", "v")} if not outs \
            else {n: c.detach().clone() for n, c in outs[0][2].items()}
        start = {n: c.clone() for n, c in cache.items()}
        y, _ = TL.attention_decode_block(cfg, attn, x, cache, pos, knobs, residual=x)
        (g,) = torch.autograd.grad(y.pow(2).sum(), attn.wo)
        outs.append((y.detach(), g, start))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-5)
