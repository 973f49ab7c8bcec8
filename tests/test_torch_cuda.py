"""The port's CUDA kernels on the card (``cuda`` marker; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it also runs where
only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same CUDA tensors:
the paired GEMM in fp32 to 1e-5 relative to the largest output, the decode
attention in fp32 to 2e-5 (the JAX decode tests' tolerance), both in bf16
to 2 output ulps of the fp32 oracle (the plain version without its final
cast); the flash-attention forward in fp32 to 1e-5 and in bf16 to 1 output
ulp (one rounding of its fp32 result).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.pairing import pair_rows_blocked
from repro_torch.core.transform import _stack_blocked, build_conv_pairings
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.ref import bf16_ulps, rel_err
from repro_torch.models import lm as M
from repro_torch.models.lenet import init_lenet, lenet_apply
from repro_torch.serving.engine import ServeEngine

RTOL = 1e-5
ATTN_RTOL = 2e-5
BF16_ULPS = 2.0
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs the same checks)")
    # full fp32 in the F.conv2d reference too: TF32 would miss the 1e-5 gate
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    pm.reset_launches()
    da.reset_launches()
    fa.reset_launches()
    return torch.device("cuda")


def _check(got, oracle, dtype, rtol=RTOL):
    if dtype == torch.float32:
        assert rel_err(got, oracle) <= rtol
    else:
        assert bf16_ulps(got, oracle) <= BF16_ULPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype):
    """Structured with the pooled epilogue and an fp32 residual, then blocked
    with a short last block; one launch each."""
    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    x, kmat, w_res = rnd(4, 300, 2 * 9 + 40), rnd(9, 33), rnd(40, 33)
    bias, res = rnd(33, dt=torch.float32), rnd(300, 33, dt=torch.float32)
    kw = dict(residual=res, activation="relu", pool="max2")
    got = pm.paired_matmul_cuda(x, kmat, w_res, bias, **kw)
    want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
    _check(got, want, dtype)

    xb, kb, wb = rnd(3, 21, 2 * 5 + 9), rnd(3, 5, 4), rnd(3, 9, 4)
    kb[-1, :, 2:] = 0  # 10 columns in blocks of 4: the last block's padding
    wb[-1, :, 2:] = 0
    bb = rnd(10, dt=torch.float32)
    got = pm.paired_matmul_blocked_cuda(xb, kb, wb, bb, n_cols=10, activation="gelu")
    want = pm.paired_matmul_blocked_plain(
        xb, kb, wb, bb, n_cols=10, activation="gelu", out_dtype=torch.float32
    )
    _check(got, want, dtype)
    assert pm.launch_count() == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_runs_the_empty_contraction(cuda, dtype):
    """P + R == 0 launches the kernel: the epilogue on zero accumulators."""
    g = torch.Generator(device=cuda).manual_seed(6)
    bias = torch.randn(10, generator=g, device=cuda)
    res = torch.randn(7, 10, generator=g, device=cuda)
    x = torch.empty((4, 7, 0), dtype=dtype, device=cuda)
    empty = torch.empty((0, 10), dtype=dtype, device=cuda)
    kw = dict(residual=res, activation="gelu", pool="max2")
    got = pm.paired_matmul_cuda(x, empty, empty, bias, **kw)
    want = pm.paired_matmul_plain(x, empty, empty, bias, out_dtype=torch.float32, **kw)
    _check(got, want, dtype)
    xb, eb = torch.empty((3, 7, 0), dtype=dtype, device=cuda), empty.new_empty((3, 0, 4))
    got = pm.paired_matmul_blocked_cuda(xb, eb, eb, bias, n_cols=10, activation="silu")
    want = pm.paired_matmul_blocked_plain(
        xb, eb, eb, bias, n_cols=10, activation="silu", out_dtype=torch.float32
    )
    _check(got, want, dtype)
    assert pm.launch_count() == 2


@pytest.mark.parametrize("mode,block_n", [("structured", 0), ("column_blocked", 4),
                                          ("per_column", 0)])
def test_paired_lenet_matches_torch_conv(cuda, mode, block_n):
    """r=0: the paired LeNet equals the F.conv2d LeNet, three launches per
    fused forward."""
    params = init_lenet(0, device=cuda)
    x = torch.as_tensor(np.random.default_rng(1).random((64, 32, 32, 1)),
                        dtype=torch.float32, device=cuda)
    paired = build_conv_pairings(params, 0.0, mode=mode, block_n=block_n)
    with torch.no_grad():
        want = lenet_apply(params, x)
        got = lenet_apply(params, x, conv_impl="paired", paired=paired, fuse_pool=True)
    _check(got, want, torch.float32)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert pm.launch_count() == 3


def _outproj(w2, rounding, block_n):
    """Out-projection segments of ``w2`` in the decode kernel's form: paired
    per ``block_n`` columns (0 → structured, None → unpaired)."""
    if block_n is None:
        return ops.attn_outproj_segments(w2, None)
    bp = pair_rows_blocked(w2.double().cpu().numpy(), rounding, block_n or w2.shape[1])
    meta = {k: torch.as_tensor(v[0], device=w2.device) for k, v in _stack_blocked([bp]).items()}
    meta = {k: v.long() if k in ("I", "J", "resid") else v for k, v in meta.items()}
    if not block_n:
        meta = {k: v[0] for k, v in meta.items()}  # structured: 1-D lane lists
    return ops.attn_outproj_segments(w2, meta, block_n or 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,window,n_sink,block_n,residual", [
    (6, 128, 0, 0, 0, True),      # qwen2's heads; structured out-projection
    (1, 64, 0, 0, 64, False),     # MHA; blocked, a short last block
    (6, 64, 20, 0, 1, True),      # sliding window; per-column blocks
    (1, 128, 20, 3, None, True),  # window + sinks; unpaired out-projection
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, G, D, window, n_sink, block_n,
                                               residual):
    """Both forms against their plain versions: slots at 0, mid-cache, S−1
    and −1 (no key: zeros); S = 77 is not a multiple of the 32-key tile."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, KH, N = 4, 77, 2, 150
    H = G * KH
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    q, kc, vc = rnd(B, 1, H, D).to(dtype), rnd(B, S, KH, D).to(dtype), rnd(B, S, KH, D).to(dtype)
    pos = torch.tensor([0, S // 2, S - 1, -1], dtype=torch.int32, device=cuda)
    kw = dict(window=window, n_sink=n_sink)
    got = da.decode_attention_cuda(q, kc, vc, pos, **kw)
    want = da.decode_attention_plain(q, kc, vc, pos, out_dtype=torch.float32, **kw)
    _check(got, want, dtype, ATTN_RTOL)
    assert not got[3].any()

    seg = _outproj(rnd(H * D, N) * 0.1, 0.3, block_n)  # most lanes pair
    res = rnd(B, N).to(dtype) if residual else None
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dtype),
            seg.w_res.to(dtype), res)
    got = da.fused_decode_attention_cuda(*args, n_cols=N, **kw)
    if dtype == torch.float32:
        want = da.fused_decode_attention_plain(*args, n_cols=N, out_dtype=dtype, **kw)
    else:  # the projection of the kernel's own bf16 rows: the attended
        # vector's rounding point is where two correct versions may differ
        want = da.outproj_plain(da.decode_attention_cuda(q, kc, vc, pos, **kw), *args[4:],
                                n_cols=N, out_dtype=torch.float32)
    assert got.dtype == dtype and got.shape == (B, N)
    _check(got, want, dtype, ATTN_RTOL)
    assert da.LAUNCHES == {"decode_attention": 1 + (dtype == torch.bfloat16),
                           "fused_decode_attention": 1}


@pytest.mark.parametrize("block_n", [0, 16])
def test_engine_paired_fused_matches_plain_engine(cuda, block_n):
    """r=0, fp32: the paired GEMMs with the fused decode attention give the
    plain engine's tokens, logits within 1e-5; per decode step and layer,
    one launch of the decode kernel and 6 (structured) or 4 (blocked, QKV as
    one launch) of the paired GEMM."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    base = dict(q_chunk=16, k_chunk=16)
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**base))
    fused = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused", pair_block_n=block_n))
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg.vocab, size=5), 1: rng.integers(0, cfg.vocab, size=11)}
    for slot, prompt in prompts.items():
        assert plain.add_request(slot, prompt) == fused.add_request(slot, prompt)
    pm.reset_launches()
    da.reset_launches()
    for _ in range(5):
        np.testing.assert_array_equal(plain.step(), fused.step())
        assert rel_err(fused.last_logits, plain.last_logits) <= RTOL
    per_layer = 5 * cfg.n_layers
    assert da.launch_count() == per_layer
    assert pm.launch_count() == (4 if block_n else 6) * per_layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", [
    (2, 64, 64, 4, 2, 16),
    (2, 32, 32, 4, 1, 8),     # MQA
    (2, 37, 53, 4, 2, 16),    # ragged, neither a multiple of the 64-row tile
    (2, 17, 64, 4, 2, 32),    # Sq < Sk: the causal mask is top-left
    (2, 64, 21, 4, 2, 64),    # Sq > Sk: rows past Sk see every key
    (1, 130, 200, 12, 2, 128),  # qwen2's heads, three query tiles
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, B, Sq, Sk, H, KH, D):
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda).to(dtype)
               for shape in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)))
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert rel_err(got, want) <= RTOL
    else:
        assert bf16_ulps(got, want) <= 1.0
    assert fa.LAUNCHES == {"flash_attention": 1}


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q as a (B, S, H, D) view of a (B, H, S, D) tensor and k sliced from a
    wider head axis: the kernel reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(2, 12, 96, 128, generator=g, device=cuda).transpose(1, 2)
    kv = torch.randn(2, 96, 4, 128, generator=g, device=cuda)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rel_err(got, fa.flash_attention_plain(q, k, v)) <= RTOL
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(*(torch.zeros(1, 8, 2, 24, device=cuda),) * 3)
