"""Kernel entry points: the paired GEMM, applying a pairing, and the LM ops.

The port of ``repro.kernels.ops``.  The GEMM functions take any leading
shape, flatten it to the kernel's 2-D layout and restore it, and apply a
:class:`~repro_torch.core.pairing.StructuredPairing` or
:class:`~repro_torch.core.pairing.BlockedPairing` to activations (the lane
gather, which in production folds into the previous layer).  The LM ops run
a decoder weight through the paired kernel from its live values and frozen
pairing metadata (``core.transform.pair_lm_params``), and decode attention
through the kernel that applies the paired out-projection in its flush; an
MoE layer's experts run one projection each as one launch of the
column-blocked kernel over the expert grid.  :func:`fused_dense` (K1's
dense form), :func:`fused_paired_dense`, :func:`fused_paired_expert_dense`
(the expert grid) and :func:`fused_attn_decode` (K2) are differentiable, as
the JAX package's custom VJPs are: the kernel's forward, a backward of
``torch.matmul``/``torch.einsum`` on the folded weights (the JAX package's
XLA dots); :func:`paired_dense`, :func:`expert_dense` and
:func:`attn_decode`, on segments a frozen serving block keeps, are forward
only.
K1's launch plans come from ``kernels.tuning``: a persisted, measured tile
cache where :func:`tile_cache_context` installs one, else the heuristic.
Each call runs where its tensors lie: the CUDA kernels for CUDA tensors,
the plain PyTorch versions for CPU tensors.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.pairing import BlockedPairing, StructuredPairing
from repro_torch.kernels import tuning
from repro_torch.kernels.decode_attention import (
    decode_attention_plain,
    fused_decode_attention_cuda,
)
from repro_torch.kernels.paired_matmul import (
    ACTIVATIONS,
    dense_matmul_cuda,
    paired_matmul_blocked_cuda,
    paired_matmul_cuda,
)


def paired_matmul(
    x: torch.Tensor,
    kmat: torch.Tensor,
    w_res: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    activation: str = "none",
    pool: str = "none",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(…, K) @ paired weights → (…, N). x pre-permuted to [I|J|residual].

    ``bias``/``activation`` and an output-shaped ``residual`` fuse into the
    kernel epilogue.  With ``pool="max2"``/``"avg2"`` ``x`` must be
    window-major ``(4, M, K)`` and the result is the pooled ``(M, N)`` map.
    ``out_dtype=torch.float32`` keeps the epilogue's fp32 result uncast.
    """
    if pool != "none":
        return paired_matmul_cuda(
            x, kmat, w_res, bias, residual=residual, activation=activation, pool=pool,
            out_dtype=out_dtype,
        )
    lead = x.shape[:-1]
    res2 = None if residual is None else residual.reshape(-1, residual.shape[-1])
    y = paired_matmul_cuda(
        x.reshape(-1, x.shape[-1]), kmat, w_res, bias,
        residual=res2, activation=activation, out_dtype=out_dtype,
    )
    return y.reshape(*lead, y.shape[-1])


def dense_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    activation: str = "none",
) -> torch.Tensor:
    """Plain GEMM with the same epilogue as the paired kernel."""
    lead = x.shape[:-1]
    res2 = None if residual is None else residual.reshape(-1, residual.shape[-1])
    y = dense_matmul_cuda(
        x.reshape(-1, x.shape[-1]), w, bias, residual=res2, activation=activation
    )
    return y.reshape(*lead, y.shape[-1])


def paired_matmul_blocked(
    x: torch.Tensor,
    kmat: torch.Tensor,
    w_res: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    n_cols: int,
    activation: str = "none",
    pool: str = "none",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Column-blocked paired GEMM → (M, n_cols).

    ``x`` is block-gathered ``(B, M, K')`` (window-major ``(B, 4, M, K')``
    with pooling), ``kmat``/``w_res`` the packed per-block weight segments.
    """
    return paired_matmul_blocked_cuda(
        x, kmat, w_res, bias, n_cols=n_cols, residual=residual,
        activation=activation, pool=pool, out_dtype=out_dtype,
    )


def apply_blocked_pairing(x: torch.Tensor, bp: BlockedPairing, **kw) -> torch.Tensor:
    """Evaluate x @ W through the blocked kernel given a BlockedPairing.

    Gathers the activations through the packed ``(n_blocks, K')`` index
    matrix and packs the offline per-block weight segments.
    """
    lead = x.shape[:-1]
    perm = torch.as_tensor(bp.index_arrays()["perm"], device=x.device)
    xg = x.reshape(-1, x.shape[-1])[:, perm].movedim(1, 0)  # (B, M, K')
    kmat, w_res = bp.packed_weights()
    y = paired_matmul_blocked(
        xg,
        torch.as_tensor(kmat, dtype=x.dtype, device=x.device),
        torch.as_tensor(w_res, dtype=x.dtype, device=x.device),
        n_cols=bp.shape[1], **kw,
    )
    return y.reshape(*lead, y.shape[-1])


def apply_structured_pairing(
    x: torch.Tensor, sp: StructuredPairing, *, fold_perm: bool = False, **kw
) -> torch.Tensor:
    """Evaluate x @ W through the paired kernel given a StructuredPairing.

    ``fold_perm=False`` applies the [I|J|residual] permutation here (one
    gather); ``fold_perm=True`` takes ``x`` already permuted.
    """
    xp = x if fold_perm else x[..., torch.as_tensor(sp.perm(), device=x.device)]
    kmat = torch.as_tensor(sp.Kmat, dtype=x.dtype, device=x.device)
    w_res = torch.as_tensor(sp.W_res, dtype=x.dtype, device=x.device)
    return paired_matmul(xp, kmat, w_res, **kw)


# ---------------------------------------------------------------------------
# the LM: paired dense from live weights + frozen pairing metadata
# ---------------------------------------------------------------------------
#
# The pairing metadata of one decoder weight (a layer's slice of
# ``core.transform.pair_lm_params``) holds only the index structure: lane
# lists ``I``/``J``/``resid`` and their masks, 1-D for a structured pairing
# and ``(B, Pmax)`` for a column-blocked one, padded to the segment-wide
# (Pmax, Rmax).  Padded pair lanes point I == J == 0 and every padded
# weight row is masked to zero, so padding contracts against nothing.  The
# magnitudes come from the live weights, ``Kmat = (W[I] − W[J]) / 2``,
# computed in the weights' dtype (the compute dtype) as the JAX package does.


class PairedSegments(NamedTuple):
    """What the paired kernel contracts for one weight: the activation lane
    order ``perm`` (``(K',)``, or ``(B, K')`` per column block) and the live
    segments ``kmat``/``w_res`` (``(P, N)``/``(R, N)``, or
    ``(B, Pmax, bn)``/``(B, Rmax, bn)``).  On the expert grid
    (:func:`lm_expert_segments`) the blocks are the ``n_experts`` experts'
    (or their column blocks', expert-major) and ``n_cols`` is ``E·F``."""

    perm: torch.Tensor
    kmat: torch.Tensor
    w_res: torch.Tensor
    n_cols: int
    n_experts: int = 0


class AttnOutSegments(NamedTuple):
    """The out-projection in the decode-attention kernel's column-blocked
    form: int32 lane lists ``(Bw, Pmax)``/``(Bw, Rmax)`` and segments
    ``(Bw, Pmax, bn)``/``(Bw, Rmax, bn)``."""

    idx_i: torch.Tensor
    idx_j: torch.Tensor
    idx_r: torch.Tensor
    kmat: torch.Tensor
    w_res: torch.Tensor
    n_cols: int


def _lm_structured_segments(w2: torch.Tensor, meta: dict):
    """Live (kmat, w_res) for a structured LM pairing."""
    kmat = (w2[meta["I"]] - w2[meta["J"]]) * 0.5
    kmat = kmat * meta["pair_mask"][:, None].to(w2.dtype)
    w_res = w2[meta["resid"]] * meta["resid_mask"][:, None].to(w2.dtype)
    return kmat, w_res


def _lm_blocked_weights(w2: torch.Tensor, n_blocks: int, bn: int) -> torch.Tensor:
    """(K, N) live weights → block-major (n_blocks, K, bn), zero-padded cols."""
    K, N = w2.shape
    pad = n_blocks * bn - N
    w_p = F.pad(w2, (0, pad)) if pad else w2
    return w_p.reshape(K, n_blocks, bn).permute(1, 0, 2)


def _take_block_segments(wm_t: torch.Tensor, meta: dict):
    """Live per-block (kmat, w_res) from block-major (B, K, bn) weights and
    (B, Pmax/Rmax) lane lists."""
    bar = torch.arange(wm_t.shape[0], device=wm_t.device)[:, None]
    pmask = meta["pair_mask"][:, :, None].to(wm_t.dtype)
    rmask = meta["resid_mask"][:, :, None].to(wm_t.dtype)
    kmat = (wm_t[bar, meta["I"]] - wm_t[bar, meta["J"]]) * 0.5 * pmask  # (B, Pmax, bn)
    w_res = wm_t[bar, meta["resid"]] * rmask  # (B, Rmax, bn)
    return kmat, w_res


def _lm_blocked_segments(w2: torch.Tensor, meta: dict, bn: int):
    """Packed per-block live (kmat, w_res) for a blocked LM pairing."""
    return _take_block_segments(_lm_blocked_weights(w2, meta["I"].shape[0], bn), meta)


def _check_block_n(meta: dict, pair_block_n: int) -> None:
    if meta["I"].ndim == 2 and pair_block_n < 1:
        raise ValueError("blocked pairing metadata needs pair_block_n >= 1")


def fold_lm_weight(w2: torch.Tensor, meta: dict, pair_block_n: int = 0) -> torch.Tensor:
    """Dense W_approx (K, N) the paired LM GEMM is equivalent to.

    The live-weight fold under a frozen pairing structure (the backward's
    function and the test oracle): paired rows snap to ±Kmat, residual rows
    pass through.  Scatter-*add* because padded lanes all point at row 0
    with exactly-zero contributions; their masks zero those lanes' gradient
    too, so ``w`` is reached only through live lanes.
    """
    K, N = w2.shape
    if meta["I"].ndim == 2:  # blocked: (B, Pmax)-shaped lane lists
        B, bn = meta["I"].shape[0], pair_block_n
        if bn < 1 or B != -(-N // bn):
            raise ValueError(f"{B} blocks do not cover {N} columns at pair_block_n={bn}")
        kmat, w_res = _lm_blocked_segments(w2, meta, bn)
        bar = torch.arange(B, device=w2.device)[:, None]
        wf_t = torch.zeros((B, K, bn), dtype=w2.dtype, device=w2.device)
        wf_t.index_put_((bar, meta["I"]), kmat, accumulate=True)
        wf_t.index_put_((bar, meta["J"]), -kmat, accumulate=True)
        wf_t.index_put_((bar, meta["resid"]), w_res, accumulate=True)
        return wf_t.permute(1, 0, 2).reshape(K, B * bn)[:, :N]
    kmat, w_res = _lm_structured_segments(w2, meta)
    wf = torch.zeros_like(w2)
    wf.index_put_((meta["I"],), kmat, accumulate=True)
    wf.index_put_((meta["J"],), -kmat, accumulate=True)
    wf.index_put_((meta["resid"],), w_res, accumulate=True)
    return wf


def lm_paired_segments(w2: torch.Tensor, meta: dict, pair_block_n: int = 0) -> PairedSegments:
    """The paired kernel's operands for (K, N) live weights ``w2`` under
    ``meta``; ``pair_block_n`` is the block size blocked metadata was built
    with."""
    _check_block_n(meta, pair_block_n)
    perm = torch.cat([meta["I"], meta["J"], meta["resid"]], dim=-1)
    if meta["I"].ndim == 2:
        kmat, w_res = _lm_blocked_segments(w2, meta, pair_block_n)
    else:
        kmat, w_res = _lm_structured_segments(w2, meta)
    return PairedSegments(perm, kmat, w_res, w2.shape[1])


def _k1(xg: torch.Tensor, kmat: torch.Tensor, w_res: torch.Tensor, bias: torch.Tensor | None,
        residual: torch.Tensor | None, n_cols: int, activation: str,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One K1 call on gathered activations: structured (``xg`` (…, K'),
    ``kmat`` (P, N); the dense form at P = 0) or column-blocked (``xg``
    (B, M, K'), ``kmat`` (B, Pmax, bn), ``residual`` (M, n_cols))."""
    if kmat.ndim == 3:
        return paired_matmul_blocked(xg, kmat, w_res, bias, residual, n_cols=n_cols,
                                     activation=activation, out_dtype=out_dtype)
    return paired_matmul(xg, kmat, w_res, bias, residual, activation=activation,
                         out_dtype=out_dtype)


@torch.library.custom_op("repro_torch::k1", mutates_args=())
def k1_op(xg: torch.Tensor, kmat: torch.Tensor, w_res: torch.Tensor, bias: torch.Tensor | None,
          residual: torch.Tensor | None, n_cols: int, activation: str,
          out_fp32: bool = False) -> torch.Tensor:
    """:func:`_k1` as an operator of its own, which the differentiable LM
    GEMMs call: a selective checkpoint policy sees it among the aten ops and
    can keep its output (``models.lm`` under ``remat="dots"``).  ``out_fp32``
    stores the fp32 epilogue result uncast (a tensor-parallel rank's partial
    sum)."""
    return _k1(xg, kmat, w_res, bias, residual, n_cols, activation,
               out_dtype=torch.float32 if out_fp32 else None)


def _paired_dense(x, seg: PairedSegments, bias, activation, residual, gemm,
                  **kw) -> torch.Tensor:
    kmat, w_res = seg.kmat.to(x.dtype), seg.w_res.to(x.dtype)
    if seg.perm.ndim == 1:
        return gemm(x[..., seg.perm], kmat, w_res, bias, residual, seg.n_cols, activation, **kw)
    xg = x.reshape(-1, x.shape[-1])[:, seg.perm].movedim(1, 0)  # (B, M, K')
    res2 = None if residual is None else residual.reshape(-1, seg.n_cols)
    y = gemm(xg, kmat, w_res, bias, res2, seg.n_cols, activation, **kw)
    return y.reshape(*x.shape[:-1], seg.n_cols)


def paired_dense(
    x: torch.Tensor,
    seg: PairedSegments,
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    residual: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(…, K) through the paired kernel on precomputed segments → (…, N);
    one launch.  ``bias``/``activation``/``residual`` fuse into its epilogue;
    ``out_dtype=torch.float32`` keeps its fp32 result uncast (a
    tensor-parallel rank's partial sum).
    Forward only (the serving engines' frozen blocks), so it calls the
    kernel's wrapper directly, not through :func:`k1_op` (the operator's
    dispatch costs some 20 µs of host time a call, a decode step makes
    hundreds)."""
    return _paired_dense(x, seg, bias, activation, residual, _k1, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# differentiable LM GEMMs: K1's forward, the backward by torch.matmul
# ---------------------------------------------------------------------------
#
# The JAX package differentiates its Pallas GEMMs with custom VJPs whose
# backward is plain XLA dots (``_fused_dense_grad``, ``_fused_paired_dense_grad``):
# pallas_call has no transpose rule.  Here each is a torch.autograd.Function
# whose forward is one K1 launch and whose backward is torch.matmul: for the
# dense form the pre-activation is recomputed, not saved; for the paired
# forms the backward is autograd of the folded dense equivalent
# (fold_lm_weight) with respect to the live weights.  The pairing metadata
# is frozen structure and takes no gradient.


def _ref_grads(ref, tensors, needs, dy: torch.Tensor) -> list:
    """The backward of a kernel's autograd Function: autograd of its plain
    reference ``ref(*tensors)`` for cotangent ``dy``; a gradient for each
    tensor whose ``needs`` entry (``ctx.needs_input_grad``, in the inputs'
    order) is true, None for the others (a None tensor, integer positions)."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(tensors, needs, strict=False)]  # needs: every input
        y = ref(*inputs)
        live = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(y, live, dy.to(y.dtype)))
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]


def _out_fp32(x: torch.Tensor, out_dtype: torch.dtype | None) -> bool:
    """Whether a differentiable K1 GEMM stores fp32 rather than x's dtype
    (``out_dtype`` None, x's dtype or float32; the kernel stores no other)."""
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"K1 stores {x.dtype} or float32, not {out_dtype}")
    return out_dtype == torch.float32 and x.dtype != torch.float32


def _act_grad(activation: str, z: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dy · act'(z)."""
    if activation == "none":
        return dy
    with torch.enable_grad():
        zz = z.detach().requires_grad_()
        (dz,) = torch.autograd.grad(ACTIVATIONS[activation](zz), zz, dy)
    return dz


class _FusedDense(torch.autograd.Function):
    """K1's dense form forward, torch.matmul backward (``_fused_dense_grad``
    of the JAX package's ``kernels/ops.py``)."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, out_fp32):
        N = w.shape[1]
        y = k1_op(x, w.new_zeros((0, N)), w, bias, None, N, activation, out_fp32)
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dy = dy.to(x.dtype)  # an fp32 store's cotangent, as _ref_grads casts it
        z = torch.matmul(x, w)  # the pre-activation, recomputed
        if b is not None:
            z = z + b
        dz = _act_grad(ctx.activation, z, dy)
        N = w.shape[1]
        dz2, x2 = dz.reshape(-1, N), x.reshape(-1, x.shape[-1])
        dx = torch.matmul(dz, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x2.t(), dz2).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = dz2.sum(0).to(b.dtype) if b is not None and ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None


def fused_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Differentiable ``act(x @ w + bias)``: one launch of K1's dense form
    (P = 0), the bias and activation in its epilogue; what
    ``layers.dense`` calls under ``gemm="pallas"``.  ``out_dtype=torch.float32``
    stores the epilogue's fp32 result uncast (a tensor-parallel rank's
    partial sum); the backward is the same."""
    return _FusedDense.apply(x, w, bias, activation, _out_fp32(x, out_dtype))


def fused_paired_dense_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    meta: dict,
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    residual: torch.Tensor | None = None,
    pair_block_n: int = 0,
) -> torch.Tensor:
    """The plain folded reference of :func:`fused_paired_dense`: ``x @
    fold_lm_weight(w) + bias → act → + residual``, differentiable in every
    tensor but ``meta``; its autograd is the paired GEMM's backward."""
    z = torch.matmul(x, fold_lm_weight(w, meta, pair_block_n))
    if bias is not None:
        z = z + bias
    z = ACTIVATIONS[activation](z)
    return z if residual is None else z + residual.to(z.dtype)


class _FusedPairedDense(torch.autograd.Function):
    """The paired kernel's forward on segments of the live weights, the
    folded reference's autograd as the backward (``_fused_paired_dense_grad``
    of the JAX package's ``kernels/ops.py``; ``paired_conv._PairedConv`` for
    LeNet)."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, meta, activation, pair_block_n, out_fp32):
        seg = lm_paired_segments(w, meta, pair_block_n)
        y = _paired_dense(x, seg, bias, activation, residual, k1_op, out_fp32=out_fp32)
        ctx.save_for_backward(x, w, bias, residual)
        ctx.conf = (meta, activation, pair_block_n)
        return y

    @staticmethod
    def backward(ctx, dy):
        meta, activation, pair_block_n = ctx.conf
        ref = lambda x, w, b, res: fused_paired_dense_ref(
            x, w, meta, b, activation=activation, residual=res, pair_block_n=pair_block_n)
        return (*_ref_grads(ref, ctx.saved_tensors, ctx.needs_input_grad, dy),
                None, None, None, None)


def fused_paired_dense(
    x: torch.Tensor,
    w: torch.Tensor,  # (K, N) live weights (reshape attention weights first)
    meta: dict,  # one layer's pairing metadata (core.transform.pair_lm_params)
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    residual: torch.Tensor | None = None,
    pair_block_n: int = 0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Differentiable paired GEMM from live weights + frozen LM pairing.

    1-D lane lists select the structured kernel, ``(B, Pmax)`` lists the
    column-blocked one (``pair_block_n`` is then the block size the metadata
    was built with).  ``residual`` fuses the sublayer skip connection into
    the kernel's epilogue.  One K1 launch forward; the backward is
    :func:`fused_paired_dense_ref`'s, with respect to ``x``, ``w``,
    ``bias`` and ``residual``.  ``out_dtype=torch.float32`` stores the
    epilogue's fp32 result uncast, as :func:`paired_dense` does (a
    tensor-parallel rank's partial sum, rounded once after its sum); the
    backward is the same.
    """
    _check_block_n(meta, pair_block_n)
    return _FusedPairedDense.apply(x, w, bias, residual, meta, activation, pair_block_n,
                                   _out_fp32(x, out_dtype))


# ---------------------------------------------------------------------------
# the paired GEMM over a leading expert axis (MoE)
# ---------------------------------------------------------------------------
#
# Per-expert pairing runs on the column-blocked kernel with the experts on
# its block grid: structured-per-expert metadata (E, Pmax) makes each expert
# one block of bn = F output columns; blocked-within-expert metadata
# (E, Bc, Pmax) makes E·Bc blocks of pair_block_n columns.  Either way the
# result is (M, E, F): the einsum "tk,ekf->tef" (shared activations) or
# "etk,ekf->tef" (per-expert activations, each block's rows gathered from
# its own expert's).  :func:`expert_dense` launches it on segments a frozen
# serving block keeps; :func:`fused_paired_expert_dense` on segments of the
# live weights, differentiably: its backward is autograd of that einsum on
# the folded experts (``_fused_paired_expert_dense_grad`` of the JAX
# package's ``kernels/ops.py``).


def _expert_blocked_weights(w: torch.Tensor, n_blocks: int, bn: int) -> torch.Tensor:
    """(E, K, F) live expert weights → block-major (E·n_blocks, K, bn),
    zero-padding the short last block of each expert."""
    E, K, n_ff = w.shape
    pad = n_blocks * bn - n_ff
    w_p = F.pad(w, (0, pad)) if pad else w
    return w_p.reshape(E, K, n_blocks, bn).permute(0, 2, 1, 3).reshape(E * n_blocks, K, bn)


def _expert_segments(w: torch.Tensor, meta: dict, pair_block_n: int):
    """(kmat, w_res, the metadata flattened to the grid's blocks, Bc, bn)."""
    E, _, n_ff = w.shape
    if meta["I"].ndim == 3:  # blocked within each expert: (E, Bc, Pmax)
        Bc, bn = meta["I"].shape[1], pair_block_n
        if bn < 1 or Bc != -(-n_ff // bn):
            raise ValueError(f"{Bc} blocks do not cover {n_ff} columns at pair_block_n={bn}")
        m = {k: v.reshape(E * Bc, *v.shape[2:]) for k, v in meta.items()}
        kmat, w_res = _take_block_segments(_expert_blocked_weights(w, Bc, bn), m)
        return kmat, w_res, m, Bc, bn
    kmat, w_res = _take_block_segments(w, meta)  # an expert is one block of F columns
    return kmat, w_res, meta, 1, n_ff


def fold_lm_expert_weight(w: torch.Tensor, meta: dict, pair_block_n: int = 0) -> torch.Tensor:
    """Dense (E, K, F) equivalent of the per-expert paired weights: the
    expert-axis :func:`fold_lm_weight` (the test oracle, and the weights of
    the einsum the card times the expert GEMM against)."""
    E, K, n_ff = w.shape
    kmat, w_res, m, Bc, bn = _expert_segments(w, meta, pair_block_n)
    bar = torch.arange(E * Bc, device=w.device)[:, None]
    wf_t = torch.zeros((E * Bc, K, bn), dtype=w.dtype, device=w.device)
    wf_t.index_put_((bar, m["I"]), kmat, accumulate=True)
    wf_t.index_put_((bar, m["J"]), -kmat, accumulate=True)
    wf_t.index_put_((bar, m["resid"]), w_res, accumulate=True)
    return wf_t.reshape(E, Bc, K, bn).permute(0, 2, 1, 3).reshape(E, K, Bc * bn)[:, :, :n_ff]


def lm_expert_segments(w: torch.Tensor, meta: dict, pair_block_n: int = 0) -> PairedSegments:
    """The blocked kernel's operands for (E, K, F) live expert weights under
    per-expert ``meta`` (``core.transform.pair_params``): ``(E, Pmax)`` lane
    lists give E blocks of bn = F columns, ``(E, Bc, Pmax)`` lists E·Bc
    blocks of ``pair_block_n`` columns."""
    E, _, n_ff = w.shape
    kmat, w_res, m, _, _ = _expert_segments(w, meta, pair_block_n)
    perm = torch.cat([m["I"], m["J"], m["resid"]], dim=-1)  # (E·Bc, K')
    return PairedSegments(perm, kmat, w_res, E * n_ff, E)


def expert_rows(x: torch.Tensor, seg: PairedSegments, x_per_expert: bool) -> torch.Tensor:
    """The blocked kernel's activations on the expert grid, (E·Bc, M, K'):
    each block's ``[I | J | resid]`` lanes of shared (M, K) rows, or of its
    own expert's rows of (E, M, K) with ``x_per_expert``."""
    EB, Kp = seg.perm.shape
    M = x.shape[-2]
    if not x_per_expert:
        return x[:, seg.perm].movedim(1, 0)
    E = seg.n_experts
    e = torch.arange(E, device=x.device)[:, None, None]
    xg = x.transpose(1, 2)[e, seg.perm.reshape(E, EB // E, Kp)]  # (E, Bc, K', M)
    return xg.transpose(2, 3).reshape(EB, M, Kp)


def _expert_grid(x, seg: PairedSegments, activation: str, x_per_expert: bool,
                 gemm) -> torch.Tensor:
    E, M = seg.n_experts, x.shape[-2]
    EB, bn = seg.perm.shape[0], seg.kmat.shape[-1]
    y = gemm(expert_rows(x, seg, x_per_expert), seg.kmat.to(x.dtype), seg.w_res.to(x.dtype),
             None, None, EB * bn, activation)
    return y.reshape(M, E, EB // E * bn)[..., : seg.n_cols // E]


def expert_dense(
    x: torch.Tensor,
    seg: PairedSegments,
    *,
    activation: str = "none",
    x_per_expert: bool = False,
) -> torch.Tensor:
    """Every expert's GEMM as one launch of the blocked kernel → (M, E, F).

    ``x`` is shared (M, K) activations (``"tk,ekf->tef"``), or per-expert
    (E, M, K) ones with ``x_per_expert`` (``"etk,ekf->tef"``: expert ``e``'s
    rows meet expert ``e``'s weights only), gathered by :func:`expert_rows`;
    ``activation`` fuses into the kernel's epilogue.  Forward only, on the
    segments a frozen serving block keeps (not through :func:`k1_op`, as
    :func:`paired_dense`).
    """
    return _expert_grid(x, seg, activation, x_per_expert, _k1)


def fused_paired_expert_dense_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    meta: dict,
    *,
    activation: str = "none",
    x_per_expert: bool = False,
    pair_block_n: int = 0,
) -> torch.Tensor:
    """The plain folded reference of :func:`fused_paired_expert_dense`:
    ``act(einsum(eq, x, fold_lm_expert_weight(w)))``, the weights cast to x's
    dtype, differentiable in ``x`` and ``w``; its autograd is the expert
    grid's backward."""
    eq = "etk,ekf->tef" if x_per_expert else "tk,ekf->tef"
    wf = fold_lm_expert_weight(w.to(x.dtype), meta, pair_block_n)
    return ACTIVATIONS[activation](torch.einsum(eq, x, wf))


class _FusedPairedExpertDense(torch.autograd.Function):
    """One K1 launch over the expert grid on segments of the live weights,
    the folded reference's autograd as the backward
    (``_fused_paired_expert_dense_grad`` of the JAX package's
    ``kernels/ops.py``)."""

    @staticmethod
    def forward(ctx, x, w, meta, activation, x_per_expert, pair_block_n):
        seg = lm_expert_segments(w.to(x.dtype), meta, pair_block_n)
        y = _expert_grid(x, seg, activation, x_per_expert, k1_op)
        ctx.save_for_backward(x, w)
        ctx.conf = (meta, activation, x_per_expert, pair_block_n)
        return y

    @staticmethod
    def backward(ctx, dy):
        meta, activation, x_per_expert, pair_block_n = ctx.conf
        ref = lambda x, w: fused_paired_expert_dense_ref(
            x, w, meta, activation=activation, x_per_expert=x_per_expert,
            pair_block_n=pair_block_n)
        # dw comes back in w's dtype, as autograd gives a leaf's gradient
        return (*_ref_grads(ref, ctx.saved_tensors, ctx.needs_input_grad, dy),
                None, None, None, None)


def fused_paired_expert_dense(
    x: torch.Tensor,  # (M, K) shared or (E, M, K) per-expert activations
    w: torch.Tensor,  # (E, K, F) live expert weights
    meta: dict,  # (E, …) per-expert pairing metadata (core.transform.pair_params)
    *,
    activation: str = "none",
    x_per_expert: bool = False,
    pair_block_n: int = 0,
) -> torch.Tensor:
    """Differentiable per-expert paired GEMM → (M, E, F): what
    :func:`expert_dense` computes, from the live weights.

    ``(E, Pmax)`` lane lists select the structured-per-expert layout (each
    expert one kernel block of all F columns), ``(E, Bc, Pmax)`` the
    blocked-within-expert one (``pair_block_n`` columns a block, as the
    metadata was built).  One K1 launch forward, through :func:`k1_op` (so
    ``remat="dots"`` keeps its output), on :func:`lm_expert_segments` of
    ``w`` in x's dtype; the backward is :func:`fused_paired_expert_dense_ref`'s
    with respect to ``x`` and ``w`` (``dw`` in w's dtype).  The metadata
    takes no gradient.
    """
    if meta["I"].ndim == 3 and pair_block_n < 1:
        raise ValueError("blocked expert pairing metadata needs pair_block_n >= 1")
    return _FusedPairedExpertDense.apply(x, w, meta, activation, bool(x_per_expert),
                                         pair_block_n)


# ---------------------------------------------------------------------------
# fused decode attention feeding the paired out-projection
# ---------------------------------------------------------------------------
#
# The decode-attention kernel applies the paired out-projection in its flush,
# so the attended values never reach device memory.  Whatever out-projection
# metadata the layer has is normalised into the kernel's column-blocked form:
#
#   * structured metadata lifts to one block of bn = N columns;
#   * an unpaired weight becomes a pure-residual block (one zero pair lane,
#     resid = arange(K)), so (o[I] − o[J])·kmat is exactly zero and
#     o[resid]·w_res == o @ W;
#   * empty pair/residual segments (r=0 pairs nothing) pad to one zero lane,
#     so every kernel operand is non-empty.


def attn_outproj_segments(
    w2: torch.Tensor, meta: dict | None, pair_block_n: int = 0
) -> AttnOutSegments:
    """The out-projection's segments for the fused decode-attention kernel."""
    K, N = w2.shape
    i32 = dict(dtype=torch.int32, device=w2.device)
    if meta is None:
        zero = torch.zeros((1, 1), **i32)
        return AttnOutSegments(zero, zero, torch.arange(K, **i32)[None],
                               w2.new_zeros((1, 1, N)), w2[None], N)
    _check_block_n(meta, pair_block_n)
    if meta["I"].ndim == 1:
        meta, bn = {k: v[None] for k, v in meta.items()}, N
    else:
        bn = pair_block_n
    kmat, w_res = _lm_blocked_segments(w2, meta, bn)
    idx_i, idx_j, idx_r = (meta[k].to(torch.int32) for k in ("I", "J", "resid"))
    B = idx_i.shape[0]
    if idx_i.shape[1] == 0:
        idx_i = idx_j = torch.zeros((B, 1), **i32)
        kmat = w2.new_zeros((B, 1, bn))
    if idx_r.shape[1] == 0:
        idx_r = torch.zeros((B, 1), **i32)
        w_res = w2.new_zeros((B, 1, bn))
    return AttnOutSegments(idx_i, idx_j, idx_r, kmat, w_res, N)


def attn_decode(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,)
    seg: AttnOutSegments,
    *,
    residual: torch.Tensor | None = None,  # (B, 1, N)
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """Decode attention + the out-projection on precomputed segments, one
    launch → (B, 1, N)."""
    res2 = None if residual is None else residual.reshape(-1, seg.n_cols)
    y = fused_decode_attention_cuda(
        q, k_cache, v_cache, pos, seg.idx_i, seg.idx_j, seg.idx_r,
        seg.kmat.to(q.dtype), seg.w_res.to(q.dtype), res2,
        n_cols=seg.n_cols, window=window, n_sink=n_sink,
    )
    return y[:, None]


def fused_attn_decode_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    w: torch.Tensor,
    meta: dict | None = None,
    *,
    residual: torch.Tensor | None = None,
    pair_block_n: int = 0,
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """The plain composition :func:`fused_attn_decode` computes: the plain
    decode attention under the same window and sinks, its rows in q's dtype
    through ``fold_lm_weight(w)`` (``w`` itself when ``meta`` is None), plus
    the residual; differentiable in every tensor but ``pos`` and ``meta``,
    and its autograd is the fused op's backward."""
    out = decode_attention_plain(q, k_cache, v_cache, pos, window=window, n_sink=n_sink)
    wf = w if meta is None else fold_lm_weight(w, meta, pair_block_n)
    z = torch.matmul(out.reshape(*out.shape[:2], -1), wf.to(out.dtype))
    return z if residual is None else z + residual.to(z.dtype)


class _FusedAttnDecode(torch.autograd.Function):
    """One K2 launch on :func:`attn_outproj_segments` of the live weights,
    the plain composition's autograd as the backward
    (``_fused_attn_decode_grad`` of the JAX package's ``kernels/ops.py``)."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, pos, w, residual, meta, pair_block_n, window, n_sink):
        y = attn_decode(q, k_cache, v_cache, pos, attn_outproj_segments(w, meta, pair_block_n),
                        residual=residual, window=window, n_sink=n_sink)
        ctx.save_for_backward(q, k_cache, v_cache, pos, w, residual)
        ctx.conf = (meta, pair_block_n, window, n_sink)
        return y

    @staticmethod
    def backward(ctx, dy):
        meta, pair_block_n, window, n_sink = ctx.conf
        ref = lambda q, kc, vc, pos, w, res: fused_attn_decode_ref(
            q, kc, vc, pos, w, meta, residual=res, pair_block_n=pair_block_n, window=window,
            n_sink=n_sink)
        return (*_ref_grads(ref, ctx.saved_tensors, ctx.needs_input_grad, dy),
                None, None, None, None)


def fused_attn_decode(
    q: torch.Tensor,  # (B, 1, H, D) one post-rope query row per slot
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32
    w: torch.Tensor,  # (K=H·D, N) live out-projection weights
    meta: dict | None = None,  # out-projection pairing metadata (any layout)
    *,
    residual: torch.Tensor | None = None,  # (B, 1, N) fused skip connection
    pair_block_n: int = 0,
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """Differentiable fused decode attention + paired out-projection.

    One K2 launch per decode step: attention over the KV cache with the
    out-projection (and the sublayer residual) applied in the kernel's
    flush, on :func:`attn_outproj_segments` of the live ``w``.  ``meta`` is
    the out-projection's pairing in either LM layout, or ``None`` for an
    unpaired weight.  Returns (B, 1, N).  The backward is
    :func:`fused_attn_decode_ref`'s, for ``q``, the caches, ``w`` and the
    residual; ``pos`` and the metadata take none.
    """
    return _FusedAttnDecode.apply(q, k_cache, v_cache, pos, w, residual, meta, pair_block_n,
                                  window, n_sink)


def paired_mode_of(knobs) -> tuple[str, int]:
    """(pairing mode, block_n) a ``pair_block_n`` knob encodes: 0 →
    structured, n ≥ 1 → column-blocked (1 == the paper's per-column)."""
    n = int(knobs.pair_block_n or 0)
    return ("column_blocked", n) if n >= 1 else ("structured", 0)


@contextlib.contextmanager
def tile_cache_context(knobs, cache: tuning.TileCache | None = None):
    """Install what a PerfKnobs-like object asks of K1's plans for the
    calls inside: ``knobs.tile_cache`` (a path, which must exist; or
    ``cache``, already loaded from it) makes measured plans beat the
    heuristic, and ``knobs.block_k`` (0: none) sets the K-slice width of
    every launch, winning over the cache.  The JAX package's context sets the
    cache alone (its ``block_k`` rides its GEMM policy, which the port does
    not have).  Thread-local: enter it where the step runs.  Yields the
    cache, or None."""
    path = getattr(knobs, "tile_cache", "")
    if cache is None and path:
        cache = tuning.load_tile_cache(path)
    with contextlib.ExitStack() as stack:
        if cache is not None:
            stack.enter_context(tuning.use_tile_cache(cache))
        stack.enter_context(tuning.use_block_k(getattr(knobs, "block_k", 0)))
        yield cache
