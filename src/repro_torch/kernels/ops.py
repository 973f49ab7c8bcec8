"""GEMM entry points over the paired kernel, and applying a pairing.

The port of the GEMM half of ``repro.kernels.ops``.  These functions take
any leading shape, flatten it to the kernel's 2-D layout and restore it, and
apply a :class:`~repro_torch.core.pairing.StructuredPairing` or
:class:`~repro_torch.core.pairing.BlockedPairing` to activations (the lane
gather, which in production folds into the previous layer).  The kernel's
tiles are fixed (see ``csrc/paired_matmul.cu``); the JAX package's tile
cache has no counterpart yet.  Each call runs where its tensors lie: the
CUDA kernel for CUDA tensors, the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.pairing import BlockedPairing, StructuredPairing
from repro_torch.kernels.paired_matmul import (
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
) -> torch.Tensor:
    """(…, K) @ paired weights → (…, N). x pre-permuted to [I|J|residual].

    ``bias``/``activation`` and an output-shaped ``residual`` fuse into the
    kernel epilogue.  With ``pool="max2"``/``"avg2"`` ``x`` must be
    window-major ``(4, M, K)`` and the result is the pooled ``(M, N)`` map.
    """
    if pool != "none":
        return paired_matmul_cuda(
            x, kmat, w_res, bias, residual=residual, activation=activation, pool=pool
        )
    lead = x.shape[:-1]
    res2 = None if residual is None else residual.reshape(-1, residual.shape[-1])
    y = paired_matmul_cuda(
        x.reshape(-1, x.shape[-1]), kmat, w_res, bias,
        residual=res2, activation=activation,
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
) -> torch.Tensor:
    """Column-blocked paired GEMM → (M, n_cols).

    ``x`` is block-gathered ``(B, M, K')`` (window-major ``(B, 4, M, K')``
    with pooling), ``kmat``/``w_res`` the packed per-block weight segments.
    """
    return paired_matmul_blocked_cuda(
        x, kmat, w_res, bias, n_cols=n_cols, residual=residual,
        activation=activation, pool=pool,
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
