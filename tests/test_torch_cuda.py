"""The port's CUDA kernel on the card (``cuda`` marker; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it also runs where
only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held to its plain PyTorch version on the same CUDA tensors:
fp32 to 1e-5 relative to the largest output, bf16 to 2 output ulps of the
fp32 oracle (the plain version without its final cast).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.transform import build_conv_pairings
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.ref import bf16_ulps, rel_err
from repro_torch.models.lenet import init_lenet, lenet_apply

RTOL = 1e-5
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
    return torch.device("cuda")


def _check(got, oracle, dtype):
    if dtype == torch.float32:
        assert rel_err(got, oracle) <= RTOL
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
