"""The port's paired GEMM entry points against the JAX package's.

The same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernel,
in interpret mode on the CPU) and ``repro_torch.kernels.ops`` (on CPU
tensors: the kernel's plain PyTorch version).  fp32 outputs agree to 1e-5
relative to the largest output.  bf16 outputs are held, in output ulps, to
the fp32 oracle — the bf16-rounded difference, then every product, sum and
epilogue step in fp32 — and not to the reference kernel's bf16 bits, which
are off by about one ulp on this JAX version.  The CUDA kernel itself is
held to the same plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pairing as j_pair
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import pairing as t_pair
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paired_matmul as t_pm
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.ref import bf16_ulps, rel_err

RTOL = 1e-5
BF16_ULPS = 2.0
J_ACT = {
    "none": lambda a: a, "relu": jax.nn.relu, "gelu": jax.nn.gelu,
    "silu": jax.nn.silu, "tanh": jnp.tanh,
}


def _case(seed, M, P, R, N, *, pool="none", bias=True, residual=None):
    rng = np.random.default_rng(seed)
    lead = (4,) if pool != "none" else ()
    return {
        "x": rng.normal(size=(*lead, M, 2 * P + R)).astype(np.float32),
        "kmat": rng.normal(size=(P, N)).astype(np.float32),
        "w_res": rng.normal(size=(R, N)).astype(np.float32),
        "bias": rng.normal(size=N).astype(np.float32) if bias else None,
        "residual": None if residual is None else rng.normal(size=(M, N)).astype(np.float32),
    }


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a).to(dtype)


def _fold_oracle(c, activation, pool, x_dtype):
    """bf16-rounded differences, then fp32 everything (jnp, independent of
    both packages' kernels)."""
    x = jnp.asarray(c["x"], x_dtype)
    P = c["kmat"].shape[0]
    diff = (x[..., :P] - x[..., P : 2 * P]).astype(jnp.float32)
    km = jnp.asarray(c["kmat"], x_dtype).astype(jnp.float32)
    wr = jnp.asarray(c["w_res"], x_dtype).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    y = jnp.matmul(diff, km, precision=hi) + jnp.matmul(
        x[..., 2 * P :].astype(jnp.float32), wr, precision=hi
    )
    if c["bias"] is not None:
        y = y + c["bias"]
    y = J_ACT[activation](y)
    if pool == "max2":
        y = y.max(axis=0)
    elif pool == "avg2":
        y = y.mean(axis=0)
    return np.asarray(y, np.float64)


STRUCTURED = [
    # (M, P, R, N, pool, activation, residual dtype)
    (37, 5, 11, 9, "none", "none", None),
    (20, 8, 3, 16, "none", "relu", None),
    (33, 0, 25, 6, "none", "relu", None),  # P == 0: dense
    (17, 12, 0, 7, "none", "tanh", None),  # R == 0
    (9, 6, 13, 5, "max2", "relu", None),
    (11, 4, 20, 8, "avg2", "gelu", None),
    (24, 7, 9, 10, "none", "silu", "fp32"),
    (13, 3, 14, 6, "max2", "relu", "bf16"),
]


@pytest.mark.parametrize("M,P,R,N,pool,act,res", STRUCTURED)
def test_paired_matmul_fp32_matches_reference(M, P, R, N, pool, act, res):
    c = _case(M * 31 + P, M, P, R, N, pool=pool, residual=res)
    rdt_j = jnp.bfloat16 if res == "bf16" else jnp.float32
    rdt_t = torch.bfloat16 if res == "bf16" else torch.float32
    want = j_ops.paired_matmul(
        _jax(c["x"]), _jax(c["kmat"]), _jax(c["w_res"]), _jax(c["bias"]),
        _jax(c["residual"], rdt_j), activation=act, pool=pool,
    )
    got = t_ops.paired_matmul(
        _torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]), _torch(c["bias"]),
        _torch(c["residual"], rdt_t), activation=act, pool=pool,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("M,P,R,N,pool,act,res", STRUCTURED)
def test_paired_matmul_bf16_within_ulps_of_fold_oracle(M, P, R, N, pool, act, res):
    c = _case(M * 37 + R, M, P, R, N, pool=pool, residual=res)
    rdt = {None: torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16}[res]
    got = t_ops.paired_matmul(
        _torch(c["x"], torch.bfloat16), _torch(c["kmat"], torch.bfloat16),
        _torch(c["w_res"], torch.bfloat16), _torch(c["bias"]),
        _torch(c["residual"], rdt), activation=act, pool=pool,
    )
    assert got.dtype == torch.bfloat16
    oracle = _fold_oracle(c, act, pool, jnp.bfloat16)
    if c["residual"] is not None:
        oracle = oracle + _torch(c["residual"], rdt).double().numpy()
    assert bf16_ulps(got.float().numpy(), oracle) <= BF16_ULPS


@pytest.mark.parametrize("P", [0, 6])
def test_ref_oracles_match_reference(P):
    c = _case(P, 19, P, 10, 7)
    want = j_ref.paired_matmul_ref(_jax(c["x"]), _jax(c["kmat"]), _jax(c["w_res"]))
    got = t_ref.paired_matmul_ref(_torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]))
    assert rel_err(got, want) <= RTOL
    want = j_ref.dense_matmul_ref(_jax(c["x"]), _jax(c["x"].T))
    got = t_ref.dense_matmul_ref(_torch(c["x"]), _torch(c["x"].T))
    assert rel_err(got, want) <= RTOL


def test_empty_contraction_is_the_epilogue():
    """P + R == 0: zeros, then bias → activation → pool → residual."""
    c = _case(1, 6, 0, 0, 5, pool="max2", residual="fp32")
    want = j_ops.paired_matmul(
        _jax(c["x"]), _jax(c["kmat"]), _jax(c["w_res"]), _jax(c["bias"]),
        _jax(c["residual"]), activation="gelu", pool="max2",
        block_m=8, block_n=8, block_k=8,  # the reference's tile heuristic divides by K
    )
    got = t_ops.paired_matmul(
        _torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]), _torch(c["bias"]),
        _torch(c["residual"]), activation="gelu", pool="max2",
    )
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu", "tanh"])
def test_dense_matmul_matches_reference(act):
    rng = np.random.default_rng(7)
    x, w = rng.normal(size=(3, 10, 48)), rng.normal(size=(48, 20))
    b, res = rng.normal(size=20), rng.normal(size=(3, 10, 20))
    want = j_ops.dense_matmul(_jax(x), _jax(w), _jax(b), _jax(res), activation=act)
    got = t_ops.dense_matmul(_torch(x), _torch(w), _torch(b), _torch(res), activation=act)
    assert tuple(got.shape) == want.shape == (3, 10, 20)
    assert rel_err(got, want) <= RTOL


def _packed_case(seed, B, bn, n_cols, M, P, R, pool):
    rng = np.random.default_rng(seed)
    lead = (4,) if pool != "none" else ()
    kmat = rng.normal(size=(B, P, bn)).astype(np.float32)
    w_res = rng.normal(size=(B, R, bn)).astype(np.float32)
    short = n_cols - (B - 1) * bn
    kmat[-1, :, short:] = 0.0  # the short last block's padded columns
    w_res[-1, :, short:] = 0.0
    return {
        "x": rng.normal(size=(B, *lead, M, 2 * P + R)).astype(np.float32),
        "kmat": kmat, "w_res": w_res,
        "bias": rng.normal(size=n_cols).astype(np.float32),
        "residual": rng.normal(size=(M, n_cols)).astype(np.float32),
    }


@pytest.mark.parametrize(
    "B,bn,n_cols,M,P,R,pool,act",
    [
        (3, 4, 10, 21, 5, 9, "none", "relu"),  # short last block
        (6, 1, 6, 15, 3, 19, "max2", "relu"),  # per-column
        (4, 4, 13, 9, 6, 4, "avg2", "tanh"),
    ],
)
def test_paired_matmul_blocked_matches_reference(B, bn, n_cols, M, P, R, pool, act):
    c = _packed_case(B * 100 + M, B, bn, n_cols, M, P, R, pool)
    want = j_ops.paired_matmul_blocked(
        _jax(c["x"]), _jax(c["kmat"]), _jax(c["w_res"]), _jax(c["bias"]),
        _jax(c["residual"]), n_cols=n_cols, activation=act, pool=pool,
    )
    got = t_ops.paired_matmul_blocked(
        _torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]), _torch(c["bias"]),
        _torch(c["residual"]), n_cols=n_cols, activation=act, pool=pool,
    )
    assert tuple(got.shape) == want.shape == (M, n_cols)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("block_n", [0, 1, 3])
def test_apply_pairing_matches_reference(block_n):
    """A pairing built by each package on the same weights, applied to the
    same activations (lane gather included)."""
    rng = np.random.default_rng(block_n)
    w = rng.normal(size=(30, 7)) * 0.3
    w[10] = -w[3] + 0.001  # a pair the structured walk finds
    x = rng.normal(size=(2, 11, 30)).astype(np.float32)
    if block_n:
        want = j_ops.apply_blocked_pairing(
            _jax(x), j_pair.pair_rows_blocked(w, 0.2, block_n), activation="relu"
        )
        got = t_ops.apply_blocked_pairing(
            _torch(x), t_pair.pair_rows_blocked(w, 0.2, block_n), activation="relu"
        )
    else:
        want = j_ops.apply_structured_pairing(
            _jax(x), j_pair.pair_rows_structured(w, 0.2), activation="relu"
        )
        got = t_ops.apply_structured_pairing(
            _torch(x), t_pair.pair_rows_structured(w, 0.2), activation="relu"
        )
    assert tuple(got.shape) == want.shape == (2, 11, 7)
    assert rel_err(got, want) <= RTOL


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    t_pm.reset_launches()
    c = _case(0, 8, 2, 3, 4)
    y = t_pm.paired_matmul_cuda(_torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]))
    want = t_pm.paired_matmul_plain(_torch(c["x"]), _torch(c["kmat"]), _torch(c["w_res"]))
    assert torch.equal(y, want)
    assert t_pm.launch_count() == 0


def test_other_devices_raise():
    x = torch.empty((4, 7), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pm.paired_matmul_cuda(x, torch.empty((2, 3), device="meta"),
                                torch.empty((3, 3), device="meta"))


def test_layout_errors_raise():
    x = torch.zeros((4, 7))
    with pytest.raises(ValueError):
        t_pm.paired_matmul_cuda(x, torch.zeros((2, 3)), torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        t_pm.paired_matmul_cuda(x, torch.zeros((2, 3)), torch.zeros((3, 3)), pool="max2")
    with pytest.raises(ValueError):
        t_pm.paired_matmul_cuda(x, torch.zeros((2, 3)), torch.zeros((3, 3)), activation="elu")
