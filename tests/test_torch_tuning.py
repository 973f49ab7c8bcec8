"""K1's launch plans (``repro_torch.kernels.tuning``) for every shape the
port's main paths launch, checked on the CPU against the card's limits and
against the partition the kernel derives from them.

Shapes: LeNet's three conv layers in every pairing mode with the pool fused
and unfused (operands built by ``conv_gemm_operands`` on a small batch, rows
scaled to a 1000-image request); qwen2-1.5b's six decoder weights at decode
and prefill rows, structured at several pair counts; the parity and chaos
engines' column-blocked (bn=64, r=0) GEMMs; olmoe-1b-7b's attention GEMMs
and its experts on the expert grid (one block per expert, or 64-column
blocks within each) at decode, parity and routed prefill rows;
deepseek-v2-lite-16b's MLA projections, its dense first layer's MLP, its
shared experts and its expert grid (64 × 1408 columns) from decode to
2048-row prefill rows; mamba2-2.7b's six SSM projections and
hymba-1.5b's thirteen GEMMs a layer (its column-blocked fused QKV too) from
decode to prefill rows (meta tokens included); and the kernel phase's cases
(``kernels/k1_cases.py``).  Each plan must fit a block's shared memory, a
portable cluster and the grid; cut the contraction into non-empty slices that read every
column of ``x`` once (a pair's two, a residual lane's one); cover every
output column and row once; and come out the same every time.  The skinny
decode shapes must put two CTAs on every SM.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.transform import build_conv_pairings
from repro_torch.kernels import tuning
from repro_torch.kernels.k1_cases import k1_cases
from repro_torch.kernels.paired_conv import conv_gemm_operands, pool2_reference
from repro_torch.models.lenet import LENET_CONV_POSITIONS, _torch_conv, init_lenet

QWEN = {"d": 1536, "kv": 256, "ff": 8960}
# (weight, K, N) of qwen2-1.5b's decoder GEMMs on K1
QWEN_WEIGHTS = [("wq", QWEN["d"], QWEN["d"]), ("wk", QWEN["d"], QWEN["kv"]),
                ("wv", QWEN["d"], QWEN["kv"]), ("w_gate", QWEN["d"], QWEN["ff"]),
                ("w_up", QWEN["d"], QWEN["ff"]), ("w_down", QWEN["ff"], QWEN["d"])]
# pairs as a share of K: r=0 pairs none; r=0.05 pairs 45-50% of the lanes
PAIR_SHARES = (0.0, 0.25, 0.4995, 0.5)


def _lenet_shapes():
    """(label, M, P, R, B, bn, window, itemsize) of LeNet's K1 launches for a
    request of 1000 images, every mode, r ∈ {0, 0.05}, pool fused or not."""
    params = init_lenet(0, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((2, 32, 32, 1)), dtype=torch.float32)

    def conv_pool(name, x):
        return pool2_reference(torch.relu(_torch_conv(x, params[name]["w"], params[name]["b"])),
                               "max2")

    x2 = conv_pool("conv1", x)
    inputs = {"conv1": x, "conv2": x2, "conv3": conv_pool("conv2", x2)}
    shapes = []
    for r in (0.0, 0.05):
        for mode, bn in (("structured", 0), ("column_blocked", 4), ("per_column", 1)):
            pr = build_conv_pairings(params, r, mode=mode, block_n=bn,
                                     positions=LENET_CONV_POSITIONS)
            for fused in (True, False):
                for name in ("conv1", "conv2", "conv3"):
                    pool = "max2" if fused and name != "conv3" else "none"
                    xg, kmat, w_res, _ = conv_gemm_operands(inputs[name], params[name]["w"],
                                                            pr[name], pool=pool)
                    B, P, bn_ = kmat.shape if kmat.ndim == 3 else (1, *kmat.shape)
                    M = xg.shape[-2] * 500  # 2 images -> 1000
                    shapes.append((f"lenet_{mode}_r{r}_{name}_{pool}", M, P, w_res.shape[-2],
                                   B, bn_, 4 if pool != "none" else 1, 4))
    return shapes


def _qwen_shapes():
    shapes = []
    for name, K, N in QWEN_WEIGHTS:
        for share in PAIR_SHARES:
            P = int(share * K)
            for M in (1, 4, 16, 20):
                for itemsize in (2, 4):  # the serve engine (bf16), parity (fp32)
                    shapes.append((f"qwen_{name}_P{P}_M{M}_{itemsize}", M, P, K - 2 * P, 1, N,
                                   1, itemsize))
    # the parity and chaos engines: column-blocked bn=64 at r=0 (no pairs),
    # fp32, batch 2 / 4, prompts of up to 48 tokens; QKV is one launch
    for name, K, N in (("qkv", QWEN["d"], QWEN["d"] + 2 * QWEN["kv"]),
                       ("w_gate", QWEN["d"], QWEN["ff"]), ("w_down", QWEN["ff"], QWEN["d"])):
        for M in (1, 2, 4, 5, 11, 16, 48):
            shapes.append((f"blocked64_{name}_M{M}", M, 0, K, -(-N // 64), 64, 1, 4))
    return shapes


OLMOE = {"d": 2048, "experts": 64, "ff": 1024}


def _olmoe_shapes():
    """olmoe-1b-7b on K1: wq/wk/wv (and the prefill wo), d × d; every
    expert's gate/up (K = d, F columns) and down (K = F, d columns) as one
    launch over the expert grid.  Rows: decode batches of 1-4 (and the parity
    engine's 2), routed prefill capacities C of 4-40 (prompts of 24-255
    tokens at top-8 of 64, capacity factor 1.25)."""
    d, E, F = OLMOE["d"], OLMOE["experts"], OLMOE["ff"]
    shapes = []
    for share in PAIR_SHARES:
        for itemsize in (2, 4):
            for M in (1, 2, 4, 12, 64):
                P = int(share * d)
                shapes.append((f"olmoe_wq_P{P}_M{M}_{itemsize}", M, P, d - 2 * P, 1, d, 1,
                               itemsize))
            for name, K, bn in (("gate", d, F), ("down", F, d)):
                P = int(share * K)
                for M in (1, 2, 4, 10, 40):
                    shapes.append((f"olmoe_expert_{name}_P{P}_M{M}_{itemsize}", M, P,
                                   K - 2 * P, E, bn, 1, itemsize))
                # blocked within each expert, 64 columns a block
                shapes.append((f"olmoe_expert64_{name}_P{P}_M4_{itemsize}", 4, P, K - 2 * P,
                               E * bn // 64, 64, 1, itemsize))
    return shapes


DEEPSEEK = {"d": 2048, "q": 16 * 192, "kv_lora": 512, "rope": 64, "ff": 10944,
            "experts": 64, "expert_ff": 1408, "shared_ff": 2 * 1408}


def _deepseek_shapes():
    """deepseek-v2-lite-16b on K1: MLA's wq (N = 16·192), w_dkv (512),
    w_kr (64) and wo (K = 16·128 = d); the dense first layer's gate/up
    (N = 10944) and down (K = 10944); the shared experts' gate/up (N = 2816)
    and down (K = 2816); the expert grid, one block per expert (64 × 1408
    columns, or K = 1408 for down) or 64-column blocks within each (22 an
    expert).  Rows: decode batches of 1-4, routed capacities 10-24, prefill
    prompts of 64-2048 tokens."""
    ds = DEEPSEEK
    d, E, F = ds["d"], ds["experts"], ds["expert_ff"]
    weights = [("wq", d, 1, ds["q"]), ("w_dkv", d, 1, ds["kv_lora"]), ("w_kr", d, 1, ds["rope"]),
               ("wo", d, 1, d), ("dense_gate", d, 1, ds["ff"]), ("dense_down", ds["ff"], 1, d),
               ("shared_gate", d, 1, ds["shared_ff"]), ("shared_down", ds["shared_ff"], 1, d),
               ("expert_gate", d, E, F), ("expert_down", F, E, d),
               ("expert64_gate", d, E * F // 64, 64)]
    shapes = []
    for name, K, B, bn in weights:
        for share in PAIR_SHARES:
            P = int(share * K)
            for M in (1, 4, 10, 24, 64, 256, 2048):
                for itemsize in (2, 4):
                    shapes.append((f"deepseek_{name}_P{P}_M{M}_{itemsize}", M, P, K - 2 * P, B,
                                   bn, 1, itemsize))
    return shapes


MAMBA2 = {"d": 2560, "d_in": 5120, "state": 128, "heads": 80}
HYMBA = {"d": 1600, "kv": 320, "ff": 5504, "d_in": 3200, "state": 16, "heads": 50}


def _ssm_shapes():
    """mamba2-2.7b's SSM projections on K1 (w_z/w_x: N = 5120, w_B/w_C: 128,
    w_dt: 80, w_out: K = 5120) and hymba-1.5b's GEMMs (wq/wo 1600 × 1600,
    wk/wv N = 320, the MLP's N = 5504 and K = 5504, its SSM block's w_z/w_x
    N = 3200, w_B/w_C 16, w_dt 50, w_out K = 3200; the fused QKV of the
    column-blocked engine in 35 blocks of 64).  Rows: decode batches of 1-4,
    prompts of 12-300 tokens (mamba2) and 140-1328 rows (hymba: 128 meta
    tokens and a prompt)."""
    m, h = MAMBA2, HYMBA
    weights = [("mamba", "w_x", m["d"], 1, m["d_in"], (1, 4, 12, 24, 300)),
               ("mamba", "w_B", m["d"], 1, m["state"], (1, 4, 12, 300)),
               ("mamba", "w_dt", m["d"], 1, m["heads"], (1, 4, 12, 300)),
               ("mamba", "w_out", m["d_in"], 1, m["d"], (1, 4, 12, 300)),
               ("hymba", "wq", h["d"], 1, h["d"], (1, 4, 140, 1328)),
               ("hymba", "wk", h["d"], 1, h["kv"], (1, 4, 140, 1328)),
               ("hymba", "w_gate", h["d"], 1, h["ff"], (1, 4, 140, 1328)),
               ("hymba", "w_down", h["ff"], 1, h["d"], (1, 4, 140, 1328)),
               ("hymba", "w_z", h["d"], 1, h["d_in"], (1, 4, 140, 1328)),
               ("hymba", "w_B", h["d"], 1, h["state"], (1, 4, 140, 1328)),
               ("hymba", "w_dt", h["d"], 1, h["heads"], (1, 4, 140, 1328)),
               ("hymba", "w_out", h["d_in"], 1, h["d"], (1, 4, 140, 1328)),
               ("hymba", "qkv64", h["d"], (h["d"] + 2 * h["kv"]) // 64, 64, (1, 4))]
    shapes = []
    for arch, name, K, B, bn, rows in weights:
        for share in PAIR_SHARES:
            P = int(share * K)
            for M in rows:
                for itemsize in (2, 4):
                    shapes.append((f"{arch}_{name}_P{P}_M{M}_{itemsize}", M, P, K - 2 * P, B,
                                   bn, 1, itemsize))
    return shapes


def _phase_kernel_shapes():
    shapes = []
    for name, blocked, M, P, R, N, pool, _, dt, _ in k1_cases():
        B, bn = (N[0], N[1]) if blocked else (1, N)
        shapes.append((f"phase_{name}_{dt}", M, P, R, B, bn, 4 if pool != "none" else 1,
                       4 if dt == "float32" else 2))
    return shapes


SHAPES = (_lenet_shapes() + _qwen_shapes() + _olmoe_shapes() + _deepseek_shapes()
          + _ssm_shapes() + _phase_kernel_shapes())
# the skinny decode shapes: qwen2's, olmoe's, deepseek's, mamba2's and
# hymba's weights at batch 1-4 (but the narrow ones, w_kr's 64 columns and
# the SSM blocks' B, C and dt projections, cannot fill the card)
NARROW = ("deepseek_w_kr", "mamba_w_B", "mamba_w_dt", "hymba_w_B", "hymba_w_dt")
DECODE = [s for s in SHAPES if s[0].startswith(("qwen_", "olmoe_", "deepseek_", "mamba_",
                                                 "hymba_"))
          and s[1] in (1, 4) and s[2] + s[3] > 0 and not s[0].startswith(NARROW)]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_the_card(shape):
    _, M, P, R, B, bn, window, itemsize = shape
    p = tuning.plan(M, P, R, B, bn, window, itemsize)
    assert p.form in ("skinny", "tall")
    grid = p.grid(M, B, bn)
    assert 0 < p.smem <= tuning.SMEM_PER_BLOCK
    assert 1 <= p.splits <= tuning.MAX_CLUSTER
    assert grid[0] % p.splits == 0 and 1 <= grid[1] <= tuning.MAX_GRID_Y
    assert p.cols % p.tn == 0 and p.tn in (1, 4, 8)
    if p.form == "skinny":
        assert window == 1 and (p.rows, p.tn) in tuning.SKINNY_SHAPES[itemsize]
        assert p.cols & (p.cols - 1) == 0 and p.cols // p.tn <= tuning.THREADS
        assert bn % p.tn == 0 and grid[0] == p.splits
    else:
        assert p.tn in tuning.TALL_TN and p.lanes * window <= 32
        assert (window * p.rows * p.lanes) % tuning.THREADS == 0
        assert 1 <= p.stages <= tuning.TALL_STAGES and (p.splits == 1 or p.subtiles == 1)
        assert p.cols == p.tn
    assert len(p.as_args()) == 8


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_partitions_the_work(shape):
    """Slices: contiguous, non-empty, every column of x read once (a pair
    reads I and J, a residual lane its own column) whatever the seam; output
    columns and rows: each exactly once."""
    _, M, P, R, B, bn, window, itemsize = shape
    p = tuning.plan(M, P, R, B, bn, window, itemsize)
    ke, K = P + R, 2 * P + R
    slices = p.slices(P, R)
    assert len(slices) == p.splits
    if ke:
        assert slices[0][0] == 0 and slices[-1][1] == ke
        assert all(b > a for a, b in slices), slices
        assert all(s[1] == t[0] for s, t in zip(slices, slices[1:]))
    read = np.zeros(K, dtype=int)
    for begin, end in slices:
        e = np.arange(begin, end)
        pairs, resid = e[e < P], e[e >= P]
        np.add.at(read, pairs, 1)  # I lane
        np.add.at(read, P + pairs, 1)  # J lane
        np.add.at(read, P + resid, 1)  # residual lane, from column 2P on
        assert (P + resid >= 2 * P).all()
    assert (read == 1).all()

    tiles_n = -(-bn // p.cols)
    grid = p.grid(M, B, bn)
    assert grid[1] == B * tiles_n
    cols = np.zeros(B * bn, dtype=int)
    for tile in range(grid[1]):
        b, c0 = tile // tiles_n, (tile % tiles_n) * p.cols
        c = np.arange(c0, min(c0 + p.cols, bn))
        np.add.at(cols, b * bn + c, 1)
    assert (cols == 1).all()

    if p.form == "tall":
        n_sub = -(-M // p.rows)
        groups = grid[0] // p.splits
        rows = np.zeros(groups * p.subtiles * p.rows, dtype=int)
        for g in range(groups):
            s0 = g * p.subtiles
            sub = min(p.subtiles, n_sub - s0)
            assert sub >= 1
            rows[s0 * p.rows:(s0 + sub) * p.rows] += 1
        assert (rows[:M] == 1).all()
    else:
        assert min(M, 4) <= p.rows  # more rows than a pass run in passes


@pytest.mark.parametrize("shape", SHAPES[::7], ids=[s[0] for s in SHAPES[::7]])
def test_plan_is_deterministic(shape):
    args = shape[1:]
    first = tuning.plan(*args)
    for other in SHAPES[:5]:  # no state carries from one call to the next
        tuning.plan(*other[1:])
    assert tuning.plan(*args) == first == dataclasses.replace(first)


@pytest.mark.parametrize("shape", DECODE, ids=[s[0] for s in DECODE])
def test_skinny_decode_fills_the_card(shape):
    _, M, P, R, B, bn, window, itemsize = shape
    p = tuning.plan(M, P, R, B, bn, window, itemsize)
    assert p.form == "skinny"
    x, y = p.grid(M, B, bn)
    assert x * y >= 2 * tuning.SMS


def test_plan_refuses_what_no_instance_takes():
    with pytest.raises(ValueError):
        tuning.plan(4, 1, 1, 1, 8, 2, 4)  # no 2-element window
    with pytest.raises(ValueError):
        tuning.plan(4, 1, 1, 1, 8, 1, 8)  # no fp64
