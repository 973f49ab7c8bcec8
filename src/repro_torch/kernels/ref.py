"""Plain PyTorch oracles of the paired GEMM (no epilogue), and the error
measures the kernel and the port are held to them by."""
from __future__ import annotations

import numpy as np
import torch


def paired_matmul_ref(
    x: torch.Tensor, kmat: torch.Tensor, w_res: torch.Tensor
) -> torch.Tensor:
    """y = (x[:, :P] - x[:, P:2P]) @ Kmat + x[:, 2P:] @ W_res, fp32 accum.

    The subtraction happens at *input* precision (the paper's subtractor
    operates on the input format), then the products accumulate in fp32.
    """
    P = kmat.shape[0]
    diff = x[:, :P] - x[:, P : 2 * P]  # input-dtype subtract
    y = diff.float() @ kmat.float()
    y = y + x[:, 2 * P :].float() @ w_res.float()
    return y.to(x.dtype)


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def _f64(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def rel_err(got, want) -> float:
    """max |got − want| relative to the largest |want|, in float64.

    Takes tensors on any device or array-likes (numpy, JAX arrays).
    """
    got = _f64(got)
    want = _f64(want).to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bf16_ulps(got, oracle) -> float:
    """max |got − oracle| in bf16 ulps of the oracle value.

    The ulp of a value below 1/256 of the largest output's ulp is floored
    there, so exact zeros and cancellations do not divide by a vanishing ulp.
    """
    got = _f64(got)
    oracle = _f64(oracle).to(got.device)
    mag = oracle.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-38))) - 7)
    floor = torch.exp2(torch.floor(torch.log2(mag.max().clamp_min(1e-38))) - 7) / 256
    return float(((got - oracle).abs() / torch.maximum(ulp, floor)).max())
