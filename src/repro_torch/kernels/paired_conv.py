"""Convolution through the paired GEMM kernel — the paper's headline path.

The port of ``repro.kernels.paired_conv``.  The lowering chain is::

    conv (NHWC, HWIO, any stride / VALID / SAME / explicit padding)
      → im2col patches (kernels/im2col.py): (N, OH, OW, K), K = kh·kw·cin
      → gather patch lanes into the [I | J | residual] layout of the pairing
        built offline on W.reshape(K, cout) (one gather per column block in
        the column-blocked layout)
      → the paired GEMM kernel, with bias + activation fused in its epilogue.

With ``pool="max2"``/``"avg2"`` the patch rows are re-arranged window-major
— the four GEMM rows of one 2×2 pooling window become the leading axis of a
``(4, N·⌊OH/2⌋·⌊OW/2⌋, K)`` operand — so the kernel reduces the window
before its only store (odd trailing rows/cols are trimmed, VALID pooling).

The pairing artifact carries only the index structure; the magnitudes are
recomputed from the live weights in every forward (``Kmat = (W[I] − W[J])
/ 2``), so one artifact serves inference and autograd.  ``paired_conv`` is
a ``torch.autograd.Function``: the kernel runs the forward, and the
backward is the autograd of the folded dense conv (:func:`paired_conv_ref`),
the same split as the JAX custom VJP.
"""
from __future__ import annotations

import torch

from repro_torch.core.pairing import BlockedPairing, StructuredPairing
from repro_torch.kernels import ops
from repro_torch.kernels.im2col import Padding, Stride, im2col
from repro_torch.kernels.paired_matmul import ACTIVATIONS, POOL_WINDOW, POOLS


def pool2_reference(y: torch.Tensor, pool: str) -> torch.Tensor:
    """2×2/stride-2 window reduction on an NHWC map, VALID semantics."""
    if pool == "none" or pool is None:
        return y
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}")
    n, oh, ow, c = y.shape
    poh, pow_ = oh // 2, ow // 2
    if poh == 0 or pow_ == 0:
        raise ValueError(f"map {(oh, ow)} too small for a 2x2 pool")
    yw = y[:, : 2 * poh, : 2 * pow_, :].reshape(n, poh, 2, pow_, 2, c)
    if pool == "max2":
        return yw.amax(dim=(2, 4))
    return yw.mean(dim=(2, 4))


def _window_major(patches: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(N, OH, OW, K) patches → window-major (4, N·POH·POW, K) GEMM rows.

    Axis 0 enumerates the 2×2 window elements (dh-major) of pooled output
    row ``m = ((n·POH) + poh)·POW + pow``; odd trailing rows/cols are trimmed.
    """
    n, oh, ow, K = patches.shape
    poh, pow_ = oh // 2, ow // 2
    pw = patches[:, : 2 * poh, : 2 * pow_, :].reshape(n, poh, 2, pow_, 2, K)
    pw = pw.permute(2, 4, 0, 1, 3, 5)  # (2, 2, n, poh, pow, K)
    return pw.reshape(POOL_WINDOW, n * poh * pow_, K), (n, poh, pow_)


def conv_im2col(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    stride: Stride = 1,
    padding: Padding = "VALID",
    pool: str = "none",
) -> torch.Tensor:
    """Reference conv-as-GEMM: im2col patches against the flattened kernel.

    Plain PyTorch (differentiable as-is); ``pool`` applies the 2×2 window
    reduction after the activation (the megakernel's epilogue order).
    """
    kh, kw, cin, cout = w.shape
    patches = im2col(x, kh, kw, stride=stride, padding=padding)
    y = patches @ w.reshape(kh * kw * cin, cout)
    if bias is not None:
        y = y + bias
    y = ACTIVATIONS[activation](y)
    return pool2_reference(y, pool)


def _pairing_of(artifact) -> StructuredPairing | BlockedPairing:
    """Accept a (Structured|Blocked)Pairing or anything carrying one
    (PairedLayer)."""
    return artifact.pairing if hasattr(artifact, "pairing") else artifact


def _index_tensors(sp, device) -> dict[str, torch.Tensor]:
    """The pairing's lane metadata as tensors on ``device``."""
    arrays = (
        sp.index_arrays() if isinstance(sp, BlockedPairing)
        else {"I": sp.I, "J": sp.J, "resid": sp.resid, "perm": sp.perm()}
    )
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _live_segments(wm: torch.Tensor, idx: dict):
    """Kmat / W_res recomputed from live weights under the frozen structure."""
    kmat = (wm[idx["I"]] - wm[idx["J"]]) * 0.5
    return kmat, wm[idx["resid"]]


def _block_major_weights(wm: torch.Tensor, bp: BlockedPairing) -> torch.Tensor:
    """(K, N) live weights → block-major (n_blocks, K, bn), zero-padded cols."""
    K, N = bp.shape
    bn = bp.block_n
    pad = bp.n_blocks * bn - N
    wm_p = torch.nn.functional.pad(wm, (0, pad)) if pad else wm
    return wm_p.reshape(K, bp.n_blocks, bn).transpose(0, 1)


def _blocked_live_segments(wm: torch.Tensor, bp: BlockedPairing, idx: dict):
    """Packed per-block Kmat (B, Pmax, bn) / W_res (B, Rmax, bn) from live
    weights; the pad masks zero the padded lanes."""
    wm_t = _block_major_weights(wm, bp)  # (B, K, bn)
    bn = wm_t.shape[-1]

    def take(ind):
        return torch.gather(wm_t, 1, ind[:, :, None].expand(-1, -1, bn))

    pmask = idx["pair_mask"].to(wm.dtype)[:, :, None]
    rmask = idx["resid_mask"].to(wm.dtype)[:, :, None]
    kmat = (take(idx["I"]) - take(idx["J"])) * 0.5 * pmask
    w_res = take(idx["resid"]) * rmask
    return kmat, w_res


def _segments(wm, sp, idx):
    if isinstance(sp, BlockedPairing):
        return _blocked_live_segments(wm, sp, idx)
    return _live_segments(wm, idx)


def folded_conv_weight(w: torch.Tensor, pairing) -> torch.Tensor:
    """Dense W_approx (kh, kw, cin, cout) the paired kernel is equivalent to.

    Paired rows snap to ±Kmat, residual rows pass through (per block, for a
    BlockedPairing).  A plain conv on this weight is the kernel's oracle and
    the backward pass's function.
    """
    sp = _pairing_of(pairing)
    kh, kw, cin, cout = w.shape
    wm = w.reshape(kh * kw * cin, cout)
    idx = _index_tensors(sp, w.device)
    kmat, w_res = _segments(wm, sp, idx)
    if isinstance(sp, BlockedPairing):
        B, K = sp.n_blocks, sp.shape[0]
        bar = torch.arange(B, device=w.device)[:, None]
        # scatter-add: padded entries all point at row 0 but add exact zeros
        wf_t = (
            wm.new_zeros((B, K, sp.block_n))
            .index_put((bar, idx["I"]), kmat, accumulate=True)
            .index_put((bar, idx["J"]), -kmat, accumulate=True)
            .index_put((bar, idx["resid"]), w_res, accumulate=True)
        )
        wf = wf_t.transpose(0, 1).reshape(K, B * sp.block_n)[:, :cout]
        return wf.reshape(w.shape)
    wf = (
        torch.zeros_like(wm)
        .index_put((idx["I"],), kmat)
        .index_put((idx["J"],), -kmat)
        .index_put((idx["resid"],), w_res)
    )
    return wf.reshape(w.shape)


def paired_conv_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None,
    pairing,
    *,
    activation: str = "none",
    stride: Stride = 1,
    padding: Padding = "VALID",
    pool: str = "none",
) -> torch.Tensor:
    """Plain oracle: folded dense conv (+pool) == the paired kernel's math."""
    return conv_im2col(
        x, folded_conv_weight(w, pairing), bias,
        activation=activation, stride=stride, padding=padding, pool=pool,
    )


def conv_gemm_operands(
    x: torch.Tensor,
    w: torch.Tensor,
    pairing,
    *,
    stride: Stride = 1,
    padding: Padding = "VALID",
    pool: str = "none",
):
    """The operands ``paired_conv`` hands the kernel, and its output shape.

    Returns ``(xg, kmat, w_res, out_shape)``: ``xg`` is the lane-gathered
    patch matrix — ``(M, K)`` / ``(4, M, K)`` for a StructuredPairing,
    ``(B, M, K')`` / ``(B, 4, M, K')`` for a BlockedPairing — and
    ``kmat``/``w_res`` the live weight segments in ``x``'s dtype.
    """
    sp = _pairing_of(pairing)
    kh, kw, cin, cout = w.shape
    K = kh * kw * cin
    if sp.shape != (K, cout):
        raise ValueError(f"pairing built for {sp.shape}, conv kernel flattens to {(K, cout)}")
    idx = _index_tensors(sp, x.device)
    kmat, w_res = _segments(w.reshape(K, cout), sp, idx)
    patches = im2col(x, kh, kw, stride=stride, padding=padding)
    if pool != "none":
        rows, (n, poh, pow_) = _window_major(patches)  # (4, M, K)
        out_shape = (n, poh, pow_, cout)
    else:
        rows = patches.reshape(-1, K)  # (M, K)
        out_shape = (*patches.shape[:-1], cout)
    perm = idx["perm"]
    if isinstance(sp, BlockedPairing):
        # one gather straight into the block-major (B, [4,] M, K') layout
        B, Kp = perm.shape
        lead = rows.shape[:-1]
        index = perm.view(B, *(1,) * len(lead), Kp).expand(B, *lead, Kp)
        xg = torch.gather(rows.expand(B, *rows.shape), -1, index)
    else:
        xg = rows.index_select(-1, perm)
    return xg, kmat.to(x.dtype), w_res.to(x.dtype), out_shape


def _paired_conv_forward(x, w, bias, sp, conf):
    xg, kmat, w_res, out_shape = conv_gemm_operands(x, w, sp, **conf["geometry"])
    act, pool = conf["activation"], conf["geometry"]["pool"]
    if isinstance(sp, BlockedPairing):
        y = ops.paired_matmul_blocked(
            xg, kmat, w_res, bias, n_cols=out_shape[-1], activation=act, pool=pool
        )
    else:
        y = ops.paired_matmul(xg, kmat, w_res, bias, activation=act, pool=pool)
    return y.reshape(out_shape)


class _PairedConv(torch.autograd.Function):
    """Kernel forward, folded-conv backward (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, bias, sp, conf):
        ctx.save_for_backward(x, w, bias)
        ctx.sp, ctx.conf = sp, conf
        return _paired_conv_forward(x, w, bias, sp, conf)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_() for t in saved]
            y = paired_conv_ref(
                *inputs, ctx.sp, activation=ctx.conf["activation"],
                **ctx.conf["geometry"],
            )
            live = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(y, live, dy))
        return (*(None if t is None else next(grads) for t in inputs), None, None)


def paired_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    pairing,
    activation: str = "none",
    stride: Stride = 1,
    padding: Padding = "VALID",
    pool: str = "none",
) -> torch.Tensor:
    """Conv through the paired kernel. x: (N, H, W, cin) → (N, OH, OW, cout).

    ``pairing`` is the offline artifact (StructuredPairing, BlockedPairing,
    or a PairedLayer carrying either) for ``w.reshape(K, cout)``.
    ``pool="max2"``/``"avg2"`` fuses the 2×2 window reduction into the
    kernel epilogue (output is the pooled (N, ⌊OH/2⌋, ⌊OW/2⌋, cout) map).
    Differentiable: kernel forward, folded-conv backward.
    """
    if pool != "none" and pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}")
    conf = {
        "activation": activation,
        "geometry": {"stride": stride, "padding": padding, "pool": pool},
    }
    return _PairedConv.apply(x, w, bias, _pairing_of(pairing), conf)
