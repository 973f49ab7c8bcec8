"""The paired subtractor GEMM: CUDA kernel wrappers and their plain versions.

The port of ``repro.kernels.paired_matmul``.  With ``P`` shared pairs and
``R`` residual lanes (``K = 2P + R``) of an activation pre-permuted to the
``[I | J | residual]`` layout,

    y = (x[:, :P] − x[:, P:2P]) @ Kmat  +  x[:, 2P:] @ W_res

contracts over ``P + R = K − P`` lanes instead of ``K``, followed by the
fused epilogue bias → activation → optional 2×2 window pool → optional fp32
residual add → one cast to the input dtype (or no cast: ``out_dtype=torch.float32``
keeps a bf16 launch's fp32 result, a tensor-parallel partial sum).

Three wrappers mirror the JAX package's Pallas entry points:
:func:`paired_matmul_cuda` (structured; ``x`` is ``(M, K)``, or window-major
``(4, M, K)`` with ``pool="max2"``/``"avg2"``), :func:`paired_matmul_blocked_cuda`
(column-blocked; ``x`` is ``(B, [4,] M, K')`` gathered per block) and
:func:`dense_matmul_cuda` (``P == 0``).  Each launches the kernel in
``csrc/paired_matmul.cu`` for a CUDA tensor and adds one to
``LAUNCHES[<form>]``; for a CPU tensor it runs the plain PyTorch version
(``paired_matmul_plain``, ``paired_matmul_blocked_plain``; the dense
form is the paired one at ``P == 0``), and for any other device it raises.
The launch's plan (form, tile, K-split over a cluster) is
:func:`launch_plan`: an explicit ``block_k``, else the active tile cache's
plan for the launch's key, else the heuristic, a pure function of the
operands' shapes (``kernels/tuning.py`` ``resolve_plan``); each wrapper also
takes a ``plan`` to launch at (the autotuner's candidates).  A plan the
kernel refuses raises, naming the tile cache's key where the plan came from
one.
``P + R == 0`` (an empty contraction) launches the kernel too: its
contraction loop runs no step and the epilogue runs on zero accumulators.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, tuning

# Epilogue activations the kernel can fuse ("none" is the identity); gelu is
# the tanh approximation, which is jax.nn.gelu's default.
ACTIVATIONS: dict[str, Callable] = {
    "none": lambda x: x,
    "relu": F.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
}
_ACT_CODE = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "swish": 3, "tanh": 4}

# 2×2 window reductions over the leading (window) axis of the fp32 result.
POOLS: dict[str, Callable] = {
    "max2": lambda a: a.amax(dim=0),
    "avg2": lambda a: a.mean(dim=0),
}
_POOL_CODE = {"none": 0, "max2": 1, "avg2": 2}
POOL_WINDOW = 4  # 2×2 — the only window geometry LeNet (and the paper) uses

# Kernel launches by form (paired_matmul / dense_matmul, + _blocked, + _pool),
# and by (launch, plan), a launch being ``tuning.launch_key``'s arguments:
# the wrappers add one per launch, and only there.
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_BY_PLAN: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    _LAUNCHES_BY_PLAN.clear()


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launches`, all forms."""
    return sum(LAUNCHES.values())


def launches_by_plan() -> dict[tuple[str, tuning.Plan], int]:
    """Kernel launches since the last :func:`reset_launches` by (tile-cache
    key, plan)."""
    return {(tuning.launch_key(*launch), plan): n
            for (launch, plan), n in _LAUNCHES_BY_PLAN.items()}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernel's oracle on the card)
# ---------------------------------------------------------------------------


def _epilogue(y, bias, activation, pool, residual, out_dtype):
    """Bias → activation → pool → residual on the fp32 result, one cast."""
    if bias is not None:
        y = y + bias.float()
    y = ACTIVATIONS[activation](y)
    if pool != "none":
        y = POOLS[pool](y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _segments_matmul(x, kmat, w_res):
    """fp32 result of the paired contraction; the subtract is at input dtype."""
    P = kmat.shape[-2]
    diff = x[..., :P] - x[..., P : 2 * P]
    return diff.float() @ kmat.float() + x[..., 2 * P :].float() @ w_res.float()


def paired_matmul_plain(
    x, kmat, w_res, bias=None, *, residual=None, activation="none", pool="none",
    out_dtype=None,
) -> torch.Tensor:
    """Plain version of :func:`paired_matmul_cuda`.

    ``out_dtype=torch.float32`` skips the final cast: for bf16 inputs that
    is the fp32 oracle the kernel's bf16 output is held to in output ulps.
    """
    y = _segments_matmul(x, kmat, w_res)
    return _epilogue(y, bias, activation, pool, residual, out_dtype or x.dtype)


def paired_matmul_blocked_plain(
    x, kmat, w_res, bias=None, *, n_cols, residual=None, activation="none",
    pool="none", out_dtype=None,
) -> torch.Tensor:
    """Plain version of :func:`paired_matmul_blocked_cuda`."""
    if pool != "none":  # (B, 4, M, K') against (B, 1, P, bn)
        kmat, w_res = kmat[:, None], w_res[:, None]
    y = _segments_matmul(x, kmat, w_res)  # (B, [4,] M, bn)
    y = y.movedim(0, -2)  # ([4,] M, B, bn)
    y = y.reshape(*y.shape[:-2], -1)[..., :n_cols]
    return _epilogue(y, bias, activation, pool, residual, out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    lib = _build.load("paired_matmul")
    fn = lib.paired_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong] + [i] * 19 + [p]
    fn.restype = i
    lib.paired_matmul_error_string.argtypes = [i]
    lib.paired_matmul_error_string.restype = ctypes.c_char_p
    lib.paired_matmul_smem.argtypes = [i] * 10
    lib.paired_matmul_smem.restype = ctypes.c_longlong
    return fn, lib.paired_matmul_error_string, lib.paired_matmul_smem


def _on_cuda(x: torch.Tensor) -> bool:
    """True → launch the kernel; False → the plain version (CPU tensors only)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(
        f"paired_matmul runs on CUDA (kernel) or CPU (plain version), got {x.device}"
    )


def _problem(x, kmat, w_res, pool: str) -> tuple:
    """(M, P, R, n_blocks, bn, pool, itemsize) of a launch (structured
    ``kmat`` (P, N) or blocked (B, P, bn))."""
    B, P, bn = kmat.shape if kmat.ndim == 3 else (1, *kmat.shape)
    return x.shape[-2], P, w_res.shape[-2], B, bn, pool, x.element_size()


def launch_plan(x, kmat, w_res, pool: str = "none", residual: bool = False) -> tuning.Plan:
    """The kernel's launch plan for these operands (``tuning.resolve_plan``:
    an explicit block_k, the active tile cache, or the heuristic)."""
    return tuning.resolve_plan(*_problem(x, kmat, w_res, pool), residual=residual)


def launch_key(x, kmat, w_res, pool: str = "none", residual: bool = False) -> str:
    """The tile cache's key of a launch on these operands."""
    return tuning.launch_key(*_problem(x, kmat, w_res, pool), residual)


def kernel_smem(plan: tuning.Plan, P: int, R: int, window: int, itemsize: int) -> int:
    """The dynamic shared memory, in bytes, that the kernel lays out for
    ``plan`` (``plan.smem`` is the planner's model of it); needs the built
    library."""
    return _kernel()[2](P, R, window, int(itemsize == 2), int(plan.form == "skinny"), plan.rows,
                        plan.cols, plan.tn, plan.splits, plan.stages)


@functools.cache
def _check():
    fn = _build.load("paired_matmul").paired_matmul_check
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 14
    fn.restype = ctypes.c_int
    return fn


def kernel_accepts(plan: tuning.Plan, M: int, P: int, R: int, n_blocks: int, bn: int,
                   window: int, itemsize: int) -> bool:
    """Whether the C entry point takes ``plan`` for this problem: its own
    checks, run without a launch (``tuning.refusal`` is their copy on the
    host); needs the built library."""
    return _check()(M, P, R, n_blocks, bn, window, int(itemsize == 2),
                    *plan.as_args()) == 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(
    x, kmat, w_res, bias, residual, *, M, n_blocks, bn, n_cols, activation, pool,
    blocked, plan=None, out_dtype=None,
) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the paired_matmul kernel takes fp32 or bf16, got {x.dtype}")
    for name, t in (("kmat", kmat), ("w_res", w_res), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if bias is not None and bias.numel() != n_cols:
        raise ValueError(f"bias has {bias.numel()} entries for {n_cols} output columns")
    # the kernel's vector copies need 16-byte aligned operands (a view
    # into a larger buffer may start anywhere)
    x, kmat, w_res = (_aligned(t.to(x.dtype).contiguous()) for t in (x, kmat, w_res))
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if residual is not None:
        if residual.dtype not in (torch.float32, torch.bfloat16):
            residual = residual.float()
        residual = residual.contiguous()
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"the kernel stores {x.dtype} or float32, not {out_dtype}")
    out = torch.empty((M, n_cols), dtype=out_dtype, device=x.device)
    P, R = kmat.shape[-2], w_res.shape[-2]
    window = POOL_WINDOW if pool != "none" else 1
    launch = (*_problem(x, kmat, w_res, pool), residual is not None)
    plan = plan or tuning.resolve_plan(*launch[:-1], residual=launch[-1])
    fn, err_str, _ = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = fn(
            ptr(x), ptr(kmat), ptr(w_res), ptr(bias), ptr(residual), ptr(out),
            M, P, R, n_blocks, bn, n_cols, window, _POOL_CODE[pool],
            _ACT_CODE[activation], int(x.dtype == torch.bfloat16),
            int(residual is not None and residual.dtype == torch.bfloat16),
            int(out_dtype == torch.float32 and x.dtype != torch.float32),
            *plan.as_args(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        cache = tuning.active_tile_cache()
        key = tuning.launch_key(*launch)
        cached = (f", the tile cache {cache.path}'s plan for {key}"
                  if cache is not None and key in cache else "")
        raise RuntimeError(f"paired_matmul kernel launch failed: {err_str(err).decode()} "
                           f"({err}) at {plan}{cached}")
    form = ("paired_matmul" if P else "dense_matmul") + ("_blocked" if blocked else "")
    LAUNCHES[form + ("_pool" if pool != "none" else "")] += 1
    _LAUNCHES_BY_PLAN[launch, plan] += 1
    return out


def _check_common(activation, pool):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if pool != "none" and pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}")


def paired_matmul_cuda(
    x: torch.Tensor,  # (M, K) pre-permuted to [I | J | residual], or (4, M, K)
    kmat: torch.Tensor,  # (P, N) per-column pair magnitudes
    w_res: torch.Tensor,  # (R, N) residual weights, R = K - 2P
    bias: torch.Tensor | None = None,  # (N,) fused epilogue bias
    *,
    residual: torch.Tensor | None = None,  # (M, N) fused skip-connection add
    activation: str = "none",
    pool: str = "none",
    plan: tuning.Plan | None = None,  # launch at this plan (on a CUDA tensor)
    out_dtype: torch.dtype | None = None,  # x's dtype (None), or float32
) -> torch.Tensor:
    """Fused subtract-then-MAC GEMM with epilogue. Returns (M, N).

    With ``pool="max2"``/``"avg2"`` ``x`` is window-major ``(4, M, K)`` (axis
    0 enumerates the 2×2 window elements of pooled row ``m``) and the result
    is the pooled ``(M, N)`` map; ``residual`` is then pooled-shaped too.
    ``out_dtype=torch.float32`` stores the fp32 epilogue result of bf16
    operands uncast: a tensor-parallel rank's partial sum, reduced across
    ranks before the one cast.
    """
    _check_common(activation, pool)
    if x.ndim != (3 if pool != "none" else 2) or (pool != "none" and x.shape[0] != 4):
        raise ValueError(f"pool={pool!r} does not take activations of shape {tuple(x.shape)}")
    M, K = x.shape[-2], x.shape[-1]
    P, N = kmat.shape
    R = w_res.shape[0]
    if K != 2 * P + R or w_res.shape[1] != N:
        raise ValueError(f"layout mismatch: K={K}, kmat {tuple(kmat.shape)}, "
                         f"w_res {tuple(w_res.shape)}")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"residual must be {(M, N)}, got {tuple(residual.shape)}")
    if not _on_cuda(x):
        return paired_matmul_plain(
            x, kmat, w_res, bias, residual=residual, activation=activation, pool=pool,
            out_dtype=out_dtype,
        )
    return _launch(
        x, kmat, w_res, bias, residual, M=M, n_blocks=1, bn=N, n_cols=N,
        activation=activation, pool=pool, blocked=False, plan=plan, out_dtype=out_dtype,
    )


def paired_matmul_blocked_cuda(
    x: torch.Tensor,  # (B, M, K') block-gathered, or (B, 4, M, K') window-major
    kmat: torch.Tensor,  # (B, Pmax, bn) packed per-block pair magnitudes
    w_res: torch.Tensor,  # (B, Rmax, bn) packed per-block residual weights
    bias: torch.Tensor | None = None,  # (n_cols,) fused epilogue bias
    *,
    n_cols: int,
    residual: torch.Tensor | None = None,  # (M, n_cols) fused skip-connection add
    activation: str = "none",
    pool: str = "none",
    plan: tuning.Plan | None = None,  # launch at this plan (on a CUDA tensor)
    out_dtype: torch.dtype | None = None,  # as paired_matmul_cuda's
) -> torch.Tensor:
    """Column-blocked paired GEMM. Returns (M, n_cols).

    Block ``b`` owns output columns ``[b·bn, (b+1)·bn)`` and its own
    ``[I | J | resid]`` lanes, padded to the common ``(Pmax, Rmax)`` split
    (padded lanes carry zero weights); the last block may be short, and
    ``n_cols`` trims it.
    """
    _check_common(activation, pool)
    if x.ndim != (4 if pool != "none" else 3) or (pool != "none" and x.shape[1] != 4):
        raise ValueError(f"pool={pool!r} does not take activations of shape {tuple(x.shape)}")
    B, P, bn = kmat.shape
    R = w_res.shape[1]
    M, Kp = x.shape[-2], x.shape[-1]
    if (w_res.shape[0], w_res.shape[2]) != (B, bn) or x.shape[0] != B or Kp != 2 * P + R:
        raise ValueError(f"packed layout mismatch: x {tuple(x.shape)}, kmat "
                         f"{tuple(kmat.shape)}, w_res {tuple(w_res.shape)}")
    if not 0 < n_cols <= B * bn:
        raise ValueError(f"n_cols={n_cols} outside (0, {B * bn}]")
    if residual is not None and tuple(residual.shape) != (M, n_cols):
        raise ValueError(f"residual must be {(M, n_cols)}, got {tuple(residual.shape)}")
    if not _on_cuda(x):
        return paired_matmul_blocked_plain(
            x, kmat, w_res, bias, n_cols=n_cols, residual=residual,
            activation=activation, pool=pool, out_dtype=out_dtype,
        )
    return _launch(
        x, kmat, w_res, bias, residual, M=M, n_blocks=B, bn=bn, n_cols=n_cols,
        activation=activation, pool=pool, blocked=True, plan=plan, out_dtype=out_dtype,
    )


def dense_matmul_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    residual: torch.Tensor | None = None,
    activation: str = "none",
    plan: tuning.Plan | None = None,
) -> torch.Tensor:
    """Plain GEMM with the same epilogue: the paired kernel at ``P == 0``."""
    p0 = w.new_zeros((0, w.shape[1]))
    return paired_matmul_cuda(
        x, p0, w, bias, residual=residual, activation=activation, plan=plan
    )
