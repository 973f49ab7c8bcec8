"""Single-token decode attention fused into the paired out-projection: the
CUDA kernel's wrappers and their plain versions.

The port of ``repro.kernels.decode_attention``.  One query row per slot
attends over the KV cache ``(B, S, KH, D)`` (GQA: head ``h`` reads KV head
``h // G``), with the mask ``k ≤ pos ∧ (k > pos − window ∨ k < n_sink)``, an
fp32 softmax, and zeros for a slot whose mask admits no key.  The fused form
then casts the attended vector to the I/O dtype, gathers it by the
out-projection's ``[I | J | resid]`` lanes and applies

    y[w] = (o[I[w]] − o[J[w]]) · kmat[w] + o[R[w]] · w_res[w]

per column block ``w``, trims to ``n_cols`` and adds the residual in fp32,
so the attended vector never reaches device memory.

:func:`decode_attention_cuda` (the bare attention, ``(B, 1, H, D)``) and
:func:`fused_decode_attention_cuda` (``(B, n_cols)``) launch the kernel in
``csrc/decode_attention.cu`` for CUDA tensors and add one to
``LAUNCHES[<form>]``; for CPU tensors they run :func:`decode_attention_plain`
and :func:`fused_decode_attention_plain`; any other device raises.  Each
launch follows a plan from ``kernels.tuning.k2_plan`` (:func:`launch_plan`),
a pure function of the shapes that also lays out the kernel's shared
memory: a thread-block cluster splits the slots' attention over its CTAs and
merges their partial sums through distributed shared memory, and in the
fused form each CTA projects a column tile for every slot of its cluster.  The kernel walks the cache in tiles of 32 keys;
the TPU kernel's ``k_chunk`` (its block of the sequence axis) has no
counterpart here.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, tuning

# Kernel launches by form: the wrappers add one per launch, and only there.
LAUNCHES: collections.Counter = collections.Counter()
_RES_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launches`, both forms."""
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernel's oracle on the card)
# ---------------------------------------------------------------------------


def decode_mask(pos: torch.Tensor, S: int, window: int = 0, n_sink: int = 0) -> torch.Tensor:
    """(B, S) keys a slot at ``pos`` attends: ``k ≤ pos``, and inside the
    sliding window (``k > pos − window``) or among the first ``n_sink``."""
    pk = torch.arange(S, device=pos.device)[None, :]
    p = pos.to(torch.int64)[:, None]
    ok = pk <= p
    if window:
        in_w = pk > p - window
        if n_sink:
            in_w = in_w | (pk < n_sink)
        ok = ok & in_w
    return ok


def decode_attention_plain(
    q, k_cache, v_cache, pos, *, window: int = 0, n_sink: int = 0, out_dtype=None
) -> torch.Tensor:
    """Plain version of :func:`decode_attention_cuda`: fp32 scores,
    probabilities and sums; a fully masked slot gives zeros."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q[:, 0].reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    ok = decode_mask(pos, S, window, n_sink)[:, None, None, :]
    s = s.masked_fill(~ok, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, D).to(out_dtype or q.dtype)


def outproj_plain(
    o, idx_i, idx_j, idx_r, kmat, w_res, residual=None, *, n_cols: int, out_dtype=None,
) -> torch.Tensor:
    """The fused form's flush on attended rows ``o`` (B, 1, H, D), already at
    the I/O dtype: gather by the lanes, project per column block in fp32,
    trim to ``n_cols``, add the residual; the residual's dtype (``o``'s when
    there is none) unless ``out_dtype`` says otherwise."""
    B = o.shape[0]
    of = o.reshape(B, -1).float()
    idx_i, idx_j, idx_r = (t.to(torch.int64) for t in (idx_i, idx_j, idx_r))
    y = torch.einsum("bwp,wpn->bwn", of[:, idx_i] - of[:, idx_j], kmat.float())
    y = y + torch.einsum("bwr,wrn->bwn", of[:, idx_r], w_res.float())
    y = y.reshape(B, -1)[:, :n_cols]
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or (residual.dtype if residual is not None else o.dtype))


def fused_decode_attention_plain(
    q, k_cache, v_cache, pos, idx_i, idx_j, idx_r, kmat, w_res, residual=None, *,
    n_cols: int, window: int = 0, n_sink: int = 0, out_dtype=None,
) -> torch.Tensor:
    """Plain version of :func:`fused_decode_attention_cuda`: the attended
    rows cast to the I/O dtype, then :func:`outproj_plain`.

    ``out_dtype=torch.float32`` skips the final cast.  The cast of the
    attended rows stays: it is the function's own rounding point, so for
    bf16 inputs two correct implementations may round an attended value
    apart (their fp32 sums differ in the last bits) and move an output near
    zero by several of its ulps.  A bf16 kernel is therefore held, in output
    ulps, to :func:`outproj_plain` of its own bare form's rows.
    """
    o = decode_attention_plain(q, k_cache, v_cache, pos, window=window, n_sink=n_sink)
    return outproj_plain(o, idx_i, idx_j, idx_r, kmat, w_res, residual, n_cols=n_cols,
                         out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 11 + [i] * 15 + [ctypes.c_float, ctypes.POINTER(i), i, p]
    fn.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.decode_attention_error_string


def launch_plan(q, k_cache, n_cols: int = 0, bn: int = 1, P: int = 0, R: int = 0
                ) -> tuning.K2Plan:
    """The plan of a launch on these operands: the bare form at ``n_cols ==
    0``, else the fused form over ``n_cols`` columns in blocks of ``bn`` with
    ``P`` pair and ``R`` residual lanes a block."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    return tuning.k2_plan(B, S, H, KH, D, n_cols, bn, P, R, q.element_size())


@functools.cache
def _plan_array(plan: tuning.K2Plan):
    """The plan as the C entry point's int array (one per plan)."""
    args = plan.as_args()
    return (ctypes.c_int * len(args))(*args)


def _on_cuda(x: torch.Tensor) -> bool:
    """True → launch the kernel; False → the plain version (CPU tensors only)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(
        f"decode_attention runs on CUDA (kernel) or CPU (plain version), got {x.device}"
    )


def _check_attention(q, k_cache, v_cache, pos):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D:
        raise ValueError(f"caches must both be (B={B}, S, KH, D={D}), got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    if H % k_cache.shape[2]:
        raise ValueError("GQA requires query heads to divide evenly over kv heads: "
                         f"H={H}, KH={k_cache.shape[2]}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")


def _launch(q, k_cache, v_cache, pos, proj, residual, out, *, window, n_sink, form):
    """Launch the kernel; ``proj`` is None or (idx_i, idx_j, idx_r, kmat, w_res, n_cols)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the decode_attention kernel takes fp32 or bf16, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype}, the caches {k_cache.dtype}/{v_cache.dtype}")
    tensors = [q, k_cache, v_cache, pos] + ([] if proj is None else list(proj[:5]))
    if residual is not None:
        tensors.append(residual)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    q2 = q[:, 0].contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    pos = pos.to(torch.int32).contiguous()
    if proj is None:
        idx = seg = (None,) * 3
        P = R = bn = n_blocks = n_cols = 0
    else:
        idx_i, idx_j, idx_r, kmat, w_res, n_cols = proj
        idx = tuple(t.to(torch.int32).contiguous() for t in (idx_i, idx_j, idx_r))
        seg = (kmat.to(q.dtype).contiguous(), w_res.to(q.dtype).contiguous())
        n_blocks, P, bn = kmat.shape
        R = w_res.shape[1]
    plan = tuning.k2_plan(B, S, H, KH, D, n_cols, max(bn, 1), P, R, q.element_size())
    if residual is not None:
        if residual.dtype not in (torch.float32, torch.bfloat16):
            residual = residual.float()
        residual = residual.contiguous()
    if out is None:
        out_dtype = residual.dtype if residual is not None else q.dtype
        out = torch.empty((B, n_cols), dtype=out_dtype, device=q.device)
    fn, err_str = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        err = fn(
            ptr(q2), ptr(k_cache), ptr(v_cache), ptr(pos), *map(ptr, idx),
            *map(ptr, seg[:2]), ptr(residual), ptr(out),
            B, S, H, KH, D, window, n_sink, P, R, bn, n_blocks, n_cols,
            int(proj is not None), int(q.dtype == torch.bfloat16),
            _RES_KIND[None if residual is None else residual.dtype],
            1.0 / math.sqrt(D), _plan_array(plan), len(plan.as_args()),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"decode_attention kernel launch failed: {err_str(err).decode()} ({err})"
        )
    LAUNCHES[form] += 1
    return out


def decode_attention_cuda(
    q: torch.Tensor,  # (B, 1, H, D) one post-rope query row per slot
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,) current position of each slot
    *,
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """Bare decode attention: the attended ``(B, 1, H, D)`` rows."""
    _check_attention(q, k_cache, v_cache, pos)
    if not _on_cuda(q):
        return decode_attention_plain(q, k_cache, v_cache, pos, window=window, n_sink=n_sink)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k_cache, v_cache, pos, None, None, out[:, 0],
            window=window, n_sink=n_sink, form="decode_attention")
    return out


def fused_decode_attention_cuda(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,)
    idx_i: torch.Tensor,  # (Bw, Pmax) blocked pair lanes of the out-projection
    idx_j: torch.Tensor,  # (Bw, Pmax)
    idx_r: torch.Tensor,  # (Bw, Rmax) residual lanes
    kmat: torch.Tensor,  # (Bw, Pmax, bn) masked pair magnitudes (W[I] − W[J]) / 2
    w_res: torch.Tensor,  # (Bw, Rmax, bn) masked residual weights
    residual: torch.Tensor | None = None,  # (B, n_cols) fused skip connection
    *,
    n_cols: int,
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """Decode attention + paired out-projection in one launch → ``(B, n_cols)``,
    in the residual's dtype (``q``'s when there is none)."""
    _check_attention(q, k_cache, v_cache, pos)
    Bw, P = idx_i.shape
    R = idx_r.shape[1]
    bn = kmat.shape[-1]
    if idx_j.shape != idx_i.shape or tuple(kmat.shape) != (Bw, P, bn) \
            or tuple(w_res.shape) != (Bw, R, bn) or idx_r.shape[0] != Bw:
        raise ValueError(f"segment layout mismatch: I {tuple(idx_i.shape)}, J "
                         f"{tuple(idx_j.shape)}, resid {tuple(idx_r.shape)}, kmat "
                         f"{tuple(kmat.shape)}, w_res {tuple(w_res.shape)}")
    if not 0 < n_cols <= Bw * bn:
        raise ValueError(f"n_cols={n_cols} outside (0, {Bw * bn}]")
    if residual is not None and tuple(residual.shape) != (q.shape[0], n_cols):
        raise ValueError(f"residual must be {(q.shape[0], n_cols)}, got {tuple(residual.shape)}")
    if not _on_cuda(q):
        return fused_decode_attention_plain(
            q, k_cache, v_cache, pos, idx_i, idx_j, idx_r, kmat, w_res, residual,
            n_cols=n_cols, window=window, n_sink=n_sink,
        )
    return _launch(q, k_cache, v_cache, pos, (idx_i, idx_j, idx_r, kmat, w_res, n_cols),
                   residual, None, window=window, n_sink=n_sink,
                   form="fused_decode_attention")
