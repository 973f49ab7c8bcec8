"""The port's flash-attention forward (K3) against the JAX package's Pallas
kernel.

The JAX side runs ``flash_attention_fwd`` in interpret mode on every case
of ``tests/test_flash_kernel.py`` (the shape grid, MQA, causal and full,
ragged lengths, bf16); the port side runs its wrapper on CPU tensors, which
takes the plain version (``flash_attention_plain``).  Same numpy inputs;
fp32 within 1e-5 relative to the largest output, bf16 within one output ulp
(``kernels.ref.bf16_ulps``: the two sum in fp32 in different orders, so a
value at a rounding boundary may land one bf16 ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as j_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import bf16_ulps, rel_err
from repro_torch.models import layers as TL

RTOL = 1e-5
BF16_ULPS = 1.0


def _inputs(seed, B, Sq, Sk, H, KH, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))]


def _check(arrays, *, causal, q_chunk, k_chunk, bf16=False):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = j_flash(*(jnp.asarray(a, jdt) for a in arrays), causal=causal,
                   q_chunk=q_chunk, k_chunk=k_chunk, interpret=True)
    got = fa.flash_attention_fwd(*(torch.as_tensor(a).to(tdt) for a in arrays),
                                 causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    assert torch.isfinite(got.float()).all()
    want = np.asarray(want, np.float32)
    if bf16:
        assert bf16_ulps(got, want) <= BF16_ULPS
    else:
        assert rel_err(got, want) <= RTOL
    return got


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,qc,kc", [
    (2, 64, 64, 4, 2, 16, 16, 16),
    (1, 128, 128, 2, 2, 32, 32, 64),
    (2, 32, 32, 4, 1, 8, 32, 32),  # single kv head (MQA), one block
])
def test_matches_jax_kernel(B, Sq, Sk, H, KH, D, qc, kc, causal):
    _check(_inputs(B * 100 + H, B, Sq, Sk, H, KH, D), causal=causal, q_chunk=qc, k_chunk=kc)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(37, 53), (17, 64), (64, 21)])
def test_ragged_lengths_match_jax_kernel(Sq, Sk, causal):
    """Lengths the chunk grid does not divide, Sq ≠ Sk both ways: the causal
    mask is top-left (key j live for query i when j ≤ i)."""
    _check(_inputs(Sq * 100 + Sk, 2, Sq, Sk, 4, 2, 16), causal=causal, q_chunk=16, k_chunk=16)


def test_bf16_matches_jax_kernel():
    _check(_inputs(9, 1, 64, 64, 2, 2, 32), causal=True, q_chunk=32, k_chunk=32, bf16=True)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_ragged_gqa_matches_jax_kernel(causal):
    _check(_inputs(5, 2, 37, 53, 4, 2, 16), causal=causal, q_chunk=16, k_chunk=16, bf16=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(64, 64), (37, 53), (64, 21)])
def test_matches_port_layers_flash_attention(Sq, Sk, causal):
    """The model's blocked attention (window 0, no sink, q_offset 0), fp32:
    the path the kernel would replace in prefill."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(7 + Sq, 2, Sq, Sk, 4, 2, 16))
    got = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=16, k_chunk=16)
    want = TL.flash_attention(q, k, v, causal=causal, q_chunk=16, k_chunk=16)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("causal", [True, False])
def test_chunks_only_reorder_the_sums(causal):
    """q_chunk / k_chunk decide only the summation order (clamped to the
    sequence): every choice agrees with the single-block result."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(21, 2, 45, 70, 6, 2, 32))
    ref = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=512, k_chunk=512)
    for qc, kc in ((1, 7), (16, 16), (13, 64), (45, 1), (64, 33)):
        got = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc)
        assert rel_err(got, ref) <= RTOL, (qc, kc)


def test_non_contiguous_views_match_contiguous():
    """The wrapper takes (batch, seq, head)-strided views as they are."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(3, 2, 24, 24, 4, 2, 16))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # (B, S, H, D) over (B, H, S, D)
    kt = torch.cat([k, k], dim=2)[:, :, :2]  # seq stride 2·KH·D
    assert not (qt.is_contiguous() or kt.is_contiguous())
    got = fa.flash_attention_fwd(qt, kt, v, q_chunk=8, k_chunk=8)
    assert torch.equal(got, fa.flash_attention_fwd(q, k, v, q_chunk=8, k_chunk=8))


def test_gqa_non_divisible_heads_raise():
    q = torch.zeros((1, 8, 3, 8))
    kv = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="divide evenly"):
        fa.flash_attention_fwd(q, kv, kv, q_chunk=8, k_chunk=8)


def test_other_devices_raise_and_nothing_launches():
    fa.reset_launches()
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA .* or CPU"):
        fa.flash_attention_fwd(q, q, q)
    fa.flash_attention_fwd(*(torch.zeros((1, 8, 2, 8)),) * 3)
    assert fa.launch_count() == 0  # the CPU path is the plain version
