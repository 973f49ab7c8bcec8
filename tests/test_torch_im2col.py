"""``col2im`` and ``overlap_counts`` of the port's ``kernels/im2col.py``
against the JAX package's, at the strides and paddings of its
``tests/test_fused_pool.py`` (LeNet's VALID convs, a stride-2 SAME one and
an explicit uneven padding at strides (1, 2)): the same overlap-add to
1e-6, the same counts exactly, and ``<im2col(x), y> == <x, col2im(y)>``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import im2col as t_im2col

j_im2col = importlib.import_module("repro.kernels.im2col")
j_col2im = jax.jit(j_im2col.col2im, static_argnums=(1, 2, 3), static_argnames=("stride", "padding"))
j_counts = jax.jit(j_im2col.overlap_counts, static_argnums=(0, 1, 2),
                   static_argnames=("stride", "padding"))

# (x shape NHWC, kernel (kh, kw), stride, padding)
CASES = [
    ((2, 32, 32, 1), (5, 5), 1, "VALID"),
    ((2, 14, 14, 6), (5, 5), 1, "VALID"),
    ((2, 13, 13, 3), (3, 3), (2, 2), "SAME"),
    ((1, 16, 12, 4), (3, 5), (1, 2), ((1, 1), (2, 2))),
    ((1, 9, 9, 2), (3, 3), 2, "VALID"),
]


@pytest.mark.parametrize("xshape,k,stride,padding", CASES)
def test_col2im_matches_jax(xshape, k, stride, padding):
    rng = np.random.default_rng(7)
    oh, ow = t_im2col.conv_output_hw(xshape[1], xshape[2], *k, stride, padding)
    cols = rng.normal(size=(xshape[0], oh, ow, k[0] * k[1] * xshape[3])).astype(np.float32)
    want = np.asarray(j_col2im(jnp.asarray(cols), xshape, *k, stride=stride, padding=padding))
    got = t_im2col.col2im(torch.as_tensor(cols), xshape, *k, stride=stride, padding=padding)
    assert got.shape == xshape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("xshape,k,stride,padding", CASES)
def test_overlap_counts_match_jax(xshape, k, stride, padding):
    want = np.asarray(j_counts(xshape, *k, stride=stride, padding=padding))
    got = t_im2col.overlap_counts(xshape, *k, stride=stride, padding=padding)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() <= k[0] * k[1] and got.min() >= 0


@pytest.mark.parametrize("xshape,k,stride,padding", CASES)
def test_col2im_is_the_adjoint_of_im2col(xshape, k, stride, padding):
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=xshape), dtype=torch.float64)
    cols = t_im2col.im2col(x, *k, stride=stride, padding=padding)
    y = torch.as_tensor(rng.normal(size=tuple(cols.shape)), dtype=torch.float64)
    lhs = float((cols * y).sum())
    rhs = float((x * t_im2col.col2im(y, xshape, *k, stride=stride, padding=padding)).sum())
    assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs))
