"""im2col: lower a convolution to the GEMM the paired kernel understands.

The port of ``repro.kernels.im2col`` (``im2col``, its adjoint ``col2im``,
``overlap_counts``, ``resolve_padding``, ``conv_output_hw``).  Every
receptive field becomes one row of a patch matrix, so the conv becomes

    y[n, oh, ow, :] = patches[n, oh, ow, :] @ W.reshape(kh*kw*cin, cout)

Layout contract: NHWC activations, HWIO weights, and the patch axis ordered
``(kh, kw, cin)`` row-major — exactly the order of
``w.reshape(kh*kw*cin, cout)``, so pairing metadata built on that matrix
indexes patch lanes directly.  ``stride`` is an int or (sh, sw);
``padding`` is ``"VALID"``, ``"SAME"`` (XLA/TF split: low = total // 2) or
explicit ``((ph_lo, ph_hi), (pw_lo, pw_hi))``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Stride = int | tuple[int, int]
Padding = str | tuple[tuple[int, int], tuple[int, int]]


def _stride_hw(stride: Stride) -> tuple[int, int]:
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if sh < 1 or sw < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    return int(sh), int(sw)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """TF/XLA SAME: out = ceil(size / s), low pad gets the smaller half."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def resolve_padding(
    h: int, w: int, kh: int, kw: int, stride: Stride, padding: Padding
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Normalise ``padding`` to explicit ((ph_lo, ph_hi), (pw_lo, pw_hi))."""
    sh, sw = _stride_hw(stride)
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return _same_pad(h, kh, sh), _same_pad(w, kw, sw)
    (ph, pw) = padding  # explicit pairs
    return (int(ph[0]), int(ph[1])), (int(pw[0]), int(pw[1]))


def conv_output_hw(
    h: int,
    w: int,
    kh: int,
    kw: int,
    stride: Stride = 1,
    padding: Padding = "VALID",
) -> tuple[int, int]:
    """Output spatial dims of a conv at the given stride/padding."""
    sh, sw = _stride_hw(stride)
    (ph0, ph1), (pw0, pw1) = resolve_padding(h, w, kh, kw, stride, padding)
    oh = (h + ph0 + ph1 - kh) // sh + 1
    ow = (w + pw0 + pw1 - kw) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"kernel ({kh},{kw}) stride {(sh, sw)} padding {padding} yields empty "
            f"output for input ({h},{w})"
        )
    return oh, ow


def im2col(
    x: torch.Tensor,
    kh: int,
    kw: int,
    *,
    stride: Stride = 1,
    padding: Padding = "VALID",
) -> torch.Tensor:
    """Extract patches: (N, H, W, C) → (N, OH, OW, kh*kw*C), lanes (kh, kw, cin)."""
    _, h, w, _ = x.shape
    sh, sw = _stride_hw(stride)
    (ph0, ph1), (pw0, pw1) = resolve_padding(h, w, kh, kw, stride, padding)
    oh, ow = conv_output_hw(h, w, kh, kw, stride, padding)
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    views = [
        x[:, i : i + sh * (oh - 1) + 1 : sh, j : j + sw * (ow - 1) + 1 : sw, :]
        for i in range(kh)
        for j in range(kw)
    ]
    return torch.cat(views, dim=-1)


def col2im(
    cols: torch.Tensor,
    x_shape: tuple[int, int, int, int],
    kh: int,
    kw: int,
    *,
    stride: Stride = 1,
    padding: Padding = "VALID",
) -> torch.Tensor:
    """Adjoint of :func:`im2col`: overlap-add patches back to image shape,
    (N, OH, OW, kh*kw*C) → (N, H, W, C).  ``<im2col(x), y> == <x,
    col2im(y)>`` at every stride and padding: a scatter-add into the padded
    frame, then the padding sliced off (the transpose of pad-then-strided-
    slice)."""
    n, h, w, c = x_shape
    sh, sw = _stride_hw(stride)
    (ph0, ph1), (pw0, pw1) = resolve_padding(h, w, kh, kw, stride, padding)
    oh, ow = conv_output_hw(h, w, kh, kw, stride, padding)
    out = cols.new_zeros((n, h + ph0 + ph1, w + pw0 + pw1, c))
    for idx, (i, j) in enumerate((i, j) for i in range(kh) for j in range(kw)):
        out[:, i : i + sh * (oh - 1) + 1 : sh, j : j + sw * (ow - 1) + 1 : sw, :] += (
            cols[..., idx * c : (idx + 1) * c])
    return out[:, ph0 : ph0 + h, pw0 : pw0 + w, :]


def overlap_counts(
    x_shape: tuple[int, int, int, int],
    kh: int,
    kw: int,
    *,
    stride: Stride = 1,
    padding: Padding = "VALID",
    device=None,
) -> torch.Tensor:
    """How many patches cover each input pixel, ``col2im(im2col(1))``
    (fp32): dividing by it undoes the round trip where the count is
    nonzero (a stride can skip pixels; padding makes the borders uneven)."""
    ones = torch.ones(x_shape, dtype=torch.float32, device=device)
    cols = im2col(ones, kh, kw, stride=stride, padding=padding)
    return col2im(cols, x_shape, kh, kw, stride=stride, padding=padding)
