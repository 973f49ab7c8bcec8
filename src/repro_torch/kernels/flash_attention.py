"""Flash-attention forward (GQA, causal or full): the CUDA kernel's wrapper
and its plain version.

The port of ``repro.kernels.flash_attention``.  For q (B, Sq, H, D) and
k, v (B, Sk, KH, D) with ``H % KH == 0``, query head ``h`` attends KV head
``h // (H // KH)`` with scores ``q · k / sqrt(D)`` in fp32 (q, k and v cast
to fp32 first), an online softmax in fp32, probabilities kept in fp32 for
the product with V, the flush ``acc / max(l, 1e-30)`` and the output in q's
dtype.  The causal mask is top-left aligned: key ``j`` is live for query
``i`` when ``j ≤ i``, both counted from 0 even when ``Sq ≠ Sk``.

:func:`flash_attention_fwd` launches the kernel in
``csrc/flash_attention.cu`` for CUDA tensors (adding one to
``LAUNCHES["flash_attention"]``) and runs :func:`flash_attention_plain` for
CPU tensors; any other device raises.  ``q_chunk``/``k_chunk`` are the TPU
kernel's blocks: they decide only the order of the fp32 sums, which the
plain version follows; the kernel uses its own 64 × 64 tiles, in one of two
forms that its entry point chooses from the dtype and head dim (and that
:func:`kernel_form` names): bf16 with a head dim that is a multiple of 16
runs on the tensor cores (``wgmma``, p kept in fp32 as a bf16 hi + lo pair
for the PV product), everything else (fp32, and bf16 at D = 8) on the CUDA
cores' fp32 FMAs.  In the JAX package no model path calls this kernel
(prefill runs the blocked XLA ``layers.flash_attention``); in the port,
``models.layers.full_attention`` calls it for whisper's encoder
self-attention and cross-attention prefill under ``attn="pallas_fused"``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

# Kernel launches: the wrapper adds one per launch, and only there.
LAUNCHES: collections.Counter = collections.Counter()
#: head dims the kernel is compiled for
HEAD_DIMS = (8, 16, 32, 64, 128)


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launches`."""
    return sum(LAUNCHES.values())


def kernel_form(dtype: torch.dtype, head_dim: int) -> str:
    """The form the kernel's entry point runs for inputs of ``dtype`` at
    ``head_dim``: ``"tensor_core"`` for bf16 at a head dim that is a
    multiple of 16 (``wgmma``'s depth), else ``"fma"`` (fp32 stays off the
    tensor cores: TF32 would miss the fp32 gate)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "tensor_core"
    return "fma"


def _check(q, k, v, q_chunk: int, k_chunk: int):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k, v must be (B={B}, Sk, KH, D={D}), got {tuple(k.shape)}")
    if H % KH != 0:
        raise ValueError(
            f"GQA requires query heads to divide evenly over kv heads: H={H}, KH={KH}")
    if min(Sq, Sk) < 1 or q_chunk < 1 or k_chunk < 1:
        raise ValueError(f"empty sequence or chunk: Sq={Sq}, Sk={Sk}, "
                         f"q_chunk={q_chunk}, k_chunk={k_chunk}")


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the kernel's oracle on the card)
# ---------------------------------------------------------------------------


def flash_attention_plain(
    q, k, v, *, causal: bool = True, q_chunk: int = 512, k_chunk: int = 512, out_dtype=None,
) -> torch.Tensor:
    """The TPU kernel's computation in PyTorch, block for block: q blocks of
    ``q_chunk`` rows, k blocks of ``k_chunk`` keys (both clamped to the
    sequence), a k block skipped when its first key lies past the q block's
    last row (causal), and the (m, l, acc) update with its guards against
    rows that have no live key yet.  The last blocks are cut at the sequence
    ends, where the TPU kernel pads and masks (its padded keys add zeros).
    ``out_dtype`` defaults to q's."""
    _check(q, k, v, q_chunk, k_chunk)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    # (B, KH, G, S, D) fp32: head h = kh * G + g reads KV head kh
    qf = q.float().reshape(B, Sq, KH, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, KH, G, Sq, D), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        q0, q1 = qi * q_chunk, min((qi + 1) * q_chunk, Sq)
        pos_q = torch.arange(q0, q1, device=q.device)
        m = torch.full((B, KH, G, q1 - q0), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, G, q1 - q0, D), device=q.device)
        for ki in range(nk):
            k0, k1 = ki * k_chunk, min((ki + 1) * k_chunk, Sk)
            if causal and k0 > (qi + 1) * q_chunk - 1:
                continue
            s = torch.matmul(qf[:, :, :, q0:q1], kf[:, :, :, k0:k1].transpose(-1, -2)) * scale
            if causal:
                ok = torch.arange(k0, k1, device=q.device)[None, :] <= pos_q[:, None]
                s = s.masked_fill(~ok, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vf[:, :, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(out_dtype or q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p] * 4 + [i] * 6 + [i64] * 9 + [i] * 2 + [ctypes.c_float, p]
    fn.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _on_cuda(x: torch.Tensor) -> bool:
    """True → launch the kernel; False → the plain version (CPU tensors only)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(
        f"flash_attention runs on CUDA (kernel) or CPU (plain version), got {x.device}")


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash_attention kernel takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype}, k and v {k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"operands on {q.device}, {k.device} and {v.device}")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in {HEAD_DIMS}, got {D}")
    form = kernel_form(q.dtype, D)
    # the kernel reads any (batch, seq, head) strides; a head_dim that is not
    # contiguous is copied here, and so, for the tensor-core form's 16-byte
    # copies, are rows that do not start 16-byte aligned
    def usable(t):
        if t.stride(-1) != 1:
            return False
        return form == "fma" or (t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]))

    q, k, v = (t if usable(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KH, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    k_chunk: int = 512,
) -> torch.Tensor:
    """Fused flash-attention forward. Returns (B, Sq, H, D) in q's dtype."""
    if not _on_cuda(q):
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    _check(q, k, v, q_chunk, k_chunk)
    return _launch(q, k, v, causal)
