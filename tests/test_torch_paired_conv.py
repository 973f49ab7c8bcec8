"""The port's paired conv against the JAX package's, forward and backward.

Geometries: the three LeNet conv layers (conv3 fed a 12x12 map so its 2×2
pool is nonempty) and the strided / SAME / explicitly padded cases of
``tests/test_fused_pool.py``.  The same numpy weights and inputs go through
``repro.kernels.paired_conv`` (the Pallas kernel in interpret mode) and
``repro_torch.kernels.paired_conv`` (the kernel's plain version on CPU
tensors), each package pairing the weights itself:

* rounding 0: the paired conv equals the reference's to 1e-5 relative, in
  structured and column-blocked modes, unpooled and with the fused 2×2 pool;
* rounding 0.05: it equals the reference's folded-weight oracle;
* gradients with respect to ``x``, ``w`` and ``b`` equal ``jax.grad``'s.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pairing as j_pair
from repro.kernels.im2col import conv_output_hw as j_conv_output_hw
from repro.kernels.im2col import im2col as j_im2col
from repro.kernels.im2col import resolve_padding as j_resolve_padding
from repro_torch.core import pairing as t_pair
from repro_torch.kernels import im2col as t_im2col
from repro_torch.kernels import paired_conv as t_conv
from repro_torch.kernels.ref import rel_err

# the reference package re-exports a function of this name over the module
j_conv = importlib.import_module("repro.kernels.paired_conv")

RTOL = 1e-5
LENET_CASES = [
    ((2, 32, 32, 1), (5, 5, 1, 6), (1, 1), "VALID"),
    ((2, 14, 14, 6), (5, 5, 6, 16), (1, 1), "VALID"),
    ((2, 12, 12, 16), (5, 5, 16, 120), (1, 1), "VALID"),
]
STRIDED_PADDED_CASES = [
    ((2, 13, 13, 3), (3, 3, 3, 8), (2, 2), "SAME"),
    ((1, 16, 12, 4), (3, 5, 4, 7), (1, 2), ((1, 1), (2, 2))),
]
ALL_CASES = LENET_CASES + STRIDED_PADDED_CASES
IDS = ["conv1", "conv2", "conv3", "strided_same", "padded"]


def _data(xshape, kshape, *, paired_rows: bool = False):
    """Inputs, HWIO weights and bias.  ``paired_rows`` plants near-opposite
    weight rows, so that rounding 0.05 pairs lanes in every mode."""
    rng = np.random.default_rng(sum(xshape) * 7 + sum(kshape))
    kh, kw, cin, cout = kshape
    K = kh * kw * cin
    wm = rng.normal(size=(K, cout)) * np.sqrt(2.0 / K)
    if paired_rows:
        half = K // 2
        wm[half : 2 * half] = -wm[:half] + rng.normal(size=(half, cout)) * 0.005
    return (
        rng.normal(size=xshape).astype(np.float32),
        wm.reshape(kshape).astype(np.float32),
        rng.normal(size=cout).astype(np.float32) * 0.1,
    )


def _pairings(w, r, block_n):
    wm = w.reshape(-1, w.shape[-1]).astype(np.float64)
    if block_n:
        return j_pair.pair_rows_blocked(wm, r, block_n), t_pair.pair_rows_blocked(wm, r, block_n)
    return j_pair.pair_rows_structured(wm, r), t_pair.pair_rows_structured(wm, r)


@pytest.mark.parametrize("xshape,kshape,stride,padding", ALL_CASES, ids=IDS)
def test_im2col_matches_reference(xshape, kshape, stride, padding):
    x = np.random.default_rng(0).normal(size=xshape).astype(np.float32)
    kh, kw = kshape[:2]
    got = t_im2col.im2col(torch.as_tensor(x), kh, kw, stride=stride, padding=padding)
    want = j_im2col(jnp.asarray(x), kh, kw, stride=stride, padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h, w = xshape[1:3]
    args = (h, w, kh, kw, stride, padding)
    assert t_im2col.resolve_padding(*args) == j_resolve_padding(*args)
    assert t_im2col.conv_output_hw(*args) == j_conv_output_hw(*args)


@pytest.mark.parametrize("pool", ["max2", "avg2"])
def test_pool2_and_conv_im2col_match_reference(pool):
    x, w, b = _data((2, 11, 9, 3), (3, 3, 3, 5))
    got = t_conv.conv_im2col(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
        activation="relu", pool=pool,
    )
    want = j_conv.conv_im2col(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              activation="relu", pool=pool)
    assert tuple(got.shape) == want.shape == (2, 4, 3, 5)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("pool", ["none", "max2", "avg2"])
@pytest.mark.parametrize("xshape,kshape,stride,padding", ALL_CASES, ids=IDS)
def test_structured_paired_conv_r0_matches_reference(xshape, kshape, stride, padding, pool):
    x, w, b = _data(xshape, kshape)
    jp, tp = _pairings(w, 0.0, 0)
    geo = dict(stride=stride, padding=padding, pool=pool, activation="relu")
    want = j_conv.paired_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pairing=jp, **geo)
    got = t_conv.paired_conv(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b), pairing=tp, **geo
    )
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("block_n", [1, 4])
@pytest.mark.parametrize("xshape,kshape,stride,padding", ALL_CASES, ids=IDS)
def test_blocked_paired_conv_r0_matches_reference(xshape, kshape, stride, padding, block_n):
    x, w, b = _data(xshape, kshape)
    jp, tp = _pairings(w, 0.0, block_n)
    geo = dict(stride=stride, padding=padding, pool="max2", activation="relu")
    want = j_conv.paired_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pairing=jp, **geo)
    got = t_conv.paired_conv(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b), pairing=tp, **geo
    )
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) <= RTOL


def _xla_conv(x, w, b, stride, padding):
    pad = padding if isinstance(padding, str) else list(padding)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w, jnp.float32), window_strides=stride, padding=pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
    )
    return jax.nn.relu(y + b)


@pytest.mark.parametrize("block_n", [0, 4, 1])
@pytest.mark.parametrize("xshape,kshape,stride,padding", ALL_CASES, ids=IDS)
def test_paired_conv_positive_rounding_matches_fold_oracle(
    xshape, kshape, stride, padding, block_n
):
    """r = 0.05 with planted pairs: the port's kernel path equals a conv on
    the reference's folded weights (``fold()`` of its own pairing), and the
    port's live folded weights equal that fold."""
    x, w, b = _data(xshape, kshape, paired_rows=True)
    jp, tp = _pairings(w, 0.05, block_n)
    assert tp.n_pairs > 0
    pool = "none" if block_n else "max2"
    w_fold = jp.fold().reshape(kshape)
    want = _xla_conv(x, w_fold, b, stride, padding)
    if pool == "max2":
        want = j_conv.pool2_reference(want, "max2")
    got = t_conv.paired_conv(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b), pairing=tp,
        stride=stride, padding=padding, pool=pool, activation="relu",
    )
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) <= RTOL
    np.testing.assert_allclose(
        t_conv.folded_conv_weight(torch.as_tensor(w), tp).numpy(), w_fold, rtol=0, atol=1e-7
    )


@pytest.mark.parametrize(
    "case,block_n,pool",
    [(1, 0, "max2"), (4, 1, "avg2")],
    ids=["conv2_structured_max2", "padded_per_column_avg2"],
)
def test_paired_conv_grads_match_jax(case, block_n, pool):
    xshape, kshape, stride, padding = ALL_CASES[case]
    x, w, b = _data((1, *xshape[1:]), kshape, paired_rows=True)
    jp, tp = _pairings(w, 0.05, block_n)
    geo = dict(stride=stride, padding=padding, pool=pool, activation="relu")

    def j_loss(x, w, b, cot):
        return jnp.sum(j_conv.paired_conv(x, w, b, pairing=jp, **geo) * cot)

    t_y = t_conv.paired_conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                             pairing=tp, **geo)
    cot = np.random.default_rng(9).normal(size=t_y.shape).astype(np.float32)
    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(cot)
    )
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    loss = (t_conv.paired_conv(tx, tw, tb, pairing=tp, **geo) * torch.as_tensor(cot)).sum()
    loss.backward()
    for name, g, gw in zip("xwb", (tx.grad, tw.grad, tb.grad), want, strict=True):
        assert rel_err(g, gw) <= RTOL, name


def test_paired_conv_without_bias_and_grad_of_x_only():
    x, w, _ = _data((1, 9, 9, 2), (3, 3, 2, 4), paired_rows=True)
    _, tp = _pairings(w, 0.05, 2)
    tx = torch.tensor(x, requires_grad=True)
    y = t_conv.paired_conv(tx, torch.as_tensor(w), None, pairing=tp)
    want = t_conv.paired_conv_ref(torch.as_tensor(x), torch.as_tensor(w), None, tp)
    assert rel_err(y, want) <= RTOL
    y.sum().backward()
    assert tx.grad is not None and tx.grad.shape == tx.shape


def test_paired_conv_rejects_mismatched_pairing():
    x, w, b = _data((1, 8, 8, 2), (3, 3, 2, 4))
    _, tp = _pairings(w[:, :, :1], 0.0, 0)
    with pytest.raises(ValueError, match="pairing built for"):
        t_conv.paired_conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                           pairing=tp)
