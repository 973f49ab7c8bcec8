"""Launch plans of the decode-attention kernel (K2, ``kernels.tuning.k2_plan``)
and the flash-attention kernel's form choice (K3,
``flash_attention.kernel_form``), checked on the CPU.

K2's shapes are every launch the port's main paths make: the parity engine
(fp32, batch 2, cache 32, column-blocked bn=64 at r=0), the serve engine and
its load sweep (bf16, batch 4, cache 256, structured at r=0.05), the chaos
run's engine (fp32, batch 4, cache 48, bn=64), the bare form of each, and the
card checks' shapes (bn ∈ {1, 64, N}, unpaired, windows).  Each plan must fit
a block's shared memory and a portable cluster, lay out regions that hold
what the kernel puts in them, deal every work item to one rank, tile every
output column exactly once with whole thread vectors, and come out the same
every time.  Every shape that the kernel's previous design served (D ≤ 256
and its shared memory within 227 KB) must get a plan.
"""
import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import HEAD_DIMS, kernel_form

QWEN = dict(H=12, KH=2, D=128)
D_MODEL = 1536
# (label, B, S, H, KH, D, n_cols, bn, P, R, itemsize); n_cols == 0: bare
K2_SHAPES = [
    ("parity_fused", 2, 32, *QWEN.values(), D_MODEL, 64, 1, D_MODEL, 4),
    ("parity_bare", 2, 32, *QWEN.values(), 0, 1, 0, 0, 4),
    ("chaos_fused", 4, 48, *QWEN.values(), D_MODEL, 64, 1, D_MODEL, 4),
    ("chaos_bare", 4, 48, *QWEN.values(), 0, 1, 0, 0, 4),
    ("frontend_batch1", 1, 48, *QWEN.values(), D_MODEL, 64, 1, D_MODEL, 4),
    ("frontend_batch3", 3, 48, *QWEN.values(), D_MODEL, 64, 1, D_MODEL, 4),
    ("serve_structured_r005", 4, 256, *QWEN.values(), D_MODEL, D_MODEL, 700, 136, 2),
    ("serve_structured_r0", 4, 256, *QWEN.values(), D_MODEL, D_MODEL, 1, D_MODEL, 2),
    ("serve_structured_all_pairs", 4, 256, *QWEN.values(), D_MODEL, D_MODEL, 768, 1, 2),
    ("serve_bare", 4, 256, *QWEN.values(), 0, 1, 0, 0, 2),
    ("serve_unpaired", 4, 256, *QWEN.values(), D_MODEL, D_MODEL, 1, D_MODEL, 2),
    ("serve_bn64_fp32", 4, 256, *QWEN.values(), D_MODEL, 64, 700, 136, 4),
    ("serve_bn1", 4, 256, *QWEN.values(), D_MODEL, 1, 760, 16, 2),
    ("serve_batch8", 8, 256, *QWEN.values(), D_MODEL, D_MODEL, 700, 136, 2),
    ("long_cache_bf16", 4, 2048, *QWEN.values(), D_MODEL, D_MODEL, 700, 136, 2),
    ("long_cache_bare", 4, 2048, *QWEN.values(), 0, 1, 0, 0, 4),
    ("card_qwen_structured", 4, 77, 12, 2, 128, 150, 150, 70, 10, 4),
    ("card_mha_bn64_short", 4, 77, 2, 2, 64, 150, 64, 60, 8, 2),
    ("card_window_bn1", 4, 77, 12, 2, 64, 150, 1, 300, 20, 4),
    ("card_window_sink_unpaired", 4, 77, 2, 2, 128, 150, 150, 1, 256, 2),
    ("phase_short_block", 4, 77, 2, 2, 64, 1000, 64, 60, 8, 4),
    ("phase_bn1", 4, 77, 12, 2, 64, 200, 1, 300, 20, 2),
    ("phase_unpaired", 4, 300, 2, 2, 128, 700, 700, 1, 256, 2),
    ("phase_window_structured", 4, 77, 12, 2, 128, 320, 320, 700, 100, 4),
    ("smoke_heads", 2, 32, 4, 2, 16, 64, 16, 10, 12, 4),
    ("mqa_max_d", 4, 512, 8, 1, 256, 2048, 2048, 900, 248, 4),
    ("odd_head_dim", 2, 40, 6, 3, 36, 200, 200, 90, 20, 2),
    # hymba-1.5b: 25 query heads over 5 KV heads (G = 5), D 64, 1600
    # columns, cache max_seq 1280 + 128 meta rows; structured r=0.05 (bf16),
    # column-blocked bn=64, the parity engine's fp32 r=0 at 1200 + 128 + 16
    ("hymba_serve_structured", 4, 1408, 25, 5, 64, 1600, 1600, 780, 40, 2),
    ("hymba_serve_bare", 4, 1408, 25, 5, 64, 0, 1, 0, 0, 2),
    ("hymba_bn64", 4, 1408, 25, 5, 64, 1600, 64, 30, 4, 2),
    ("hymba_parity_fp32", 2, 1344, 25, 5, 64, 1600, 1600, 1, 1600, 4),
    ("hymba_parity_bare", 2, 1344, 25, 5, 64, 0, 1, 0, 0, 4),
    ("phase_hymba_window_sink", 4, 1408, 25, 5, 64, 1600, 1600, 780, 40, 4),
]


def _check_layout(plan, H, KH, D, P, R, itemsize, proj):
    """Each region starts 16-byte aligned and holds what the kernel puts
    there before the next region starts (the attended vectors and gathered
    lanes may sit inside the K/V ring, which is dead by then)."""
    G = H // KH
    gc = G // plan.groups
    units = plan.slots * KH * plan.groups
    pairs = -(-units // plan.cluster)
    isz, row_bytes, dq, *offsets = plan.layout
    at = dict(zip(tuning.K2_REGIONS, offsets))
    assert isz >= gc * (D + 2) and isz % 4 == 0
    assert row_bytes >= D * itemsize + 16 and row_bytes % 16 == 0
    assert dq >= D and dq % 4 == 0
    need = {
        "wring": plan.wstages * tuning.K2_THREADS * 16 if proj else 0,
        "kv": plan.stages * 2 * tuning.K2_TILE * row_bytes,
        "idx": 2 * plan.chunk * 4 if proj else 0,
        "vec": plan.slots * H * D * itemsize if proj else 0,
        "xg": plan.chunk * tuning.K2_MAX_SLOTS * 4 if proj else 0,
        "part": plan.items(KH) * isz * 4,
        "gath": pairs * plan.splits * isz * 4 if plan.splits > 1 else 0,
        "coef": pairs * (plan.splits + 1) * gc * 4,
        "qs": gc * dq * 4,
        "sc": tuning.K2_WARPS * gc * tuning.K2_TILE * 4,
        "corr": gc * 4,
        "red": tuning.K2_WARPS * plan.slots * plan.cols * 4 if proj else 0,
    }
    spans = sorted((at[n], at[n] + need[n], n) for n in tuning.K2_REGIONS if need[n])
    assert all(o % 16 == 0 for o in offsets)
    assert max(end for _, end, _ in spans) <= plan.smem <= tuning.SMEM_PER_BLOCK
    for i, (lo1, hi1, n1) in enumerate(spans):
        for lo2, hi2, n2 in spans[i + 1:]:
            if lo2 < hi1:  # only a late region (vec, xg) inside the dead K/V ring
                assert {n1, n2} in ({"kv", "vec"}, {"kv", "xg"}), (n1, n2)
                late = n2 if n1 == "kv" else n1
                assert at["kv"] <= at[late] and at[late] + need[late] <= at["kv"] + need["kv"]


def _check_plan(B, S, H, KH, D, n_cols, bn, P, R, itemsize):
    plan = tuning.k2_plan(B, S, H, KH, D, n_cols, bn, P, R, itemsize)
    proj = n_cols > 0
    assert plan == tuning.k2_plan.__wrapped__(B, S, H, KH, D, n_cols, bn, P, R, itemsize)
    assert 1 <= plan.cluster <= tuning.MAX_CLUSTER
    assert 1 <= plan.slots <= min(B, tuning.K2_MAX_SLOTS)
    assert (H // KH) % plan.groups == 0
    assert plan.stages in (2, 3)
    assert plan.items(KH) >= 1
    assert plan.wstages in tuning.K2_W_STAGES
    _check_layout(plan, H, KH, D, P, R, itemsize, proj)
    n_blocks = -(-n_cols // bn) if proj else 1
    x, y = plan.grid(B, n_blocks, bn, proj)
    assert x % plan.cluster == 0 and y <= tuning.MAX_GRID_Y
    # every slot in exactly one slot group
    assert sorted(s for g in range(y) for s in range(g * plan.slots, (g + 1) * plan.slots)
                  if s < B) == list(range(B))
    if proj:
        # whole 16-byte vectors (or single columns), at most 32 threads a row
        assert plan.tn in (1, 16 // itemsize) and bn % plan.tn == 0
        assert plan.cols % plan.tn == 0 and plan.cols // plan.tn <= 32
        assert plan.cols & (plan.cols - 1) == 0 and plan.cols < 2 * bn
        # the block's lanes whole, or in chunks a thread's lanes never straddle
        assert plan.chunk >= max(P + R, 1) or plan.chunk % tuning.K2_THREADS == 0
        # the column tiles cover every output column once
        tiles_per_block = -(-bn // plan.cols)
        cols = [b * bn + c0 + c for t in range(x) if (b := t // tiles_per_block) < n_blocks
                for c0 in [(t % tiles_per_block) * plan.cols] for c in range(plan.cols)
                if c0 + c < bn]
        assert sorted(cols) == list(range(n_blocks * bn))
    # the work items: every (slot, unit, split) on one rank
    n_items = plan.slots * KH * plan.groups * plan.splits
    items = [(rank + plan.cluster * i) for rank in range(plan.cluster)
             for i in range(plan.items(KH))]
    assert sorted(i for i in items if i < n_items) == list(range(n_items))
    return plan


@pytest.mark.parametrize("shape", K2_SHAPES, ids=[s[0] for s in K2_SHAPES])
def test_k2_plan_fits_and_partitions(shape):
    _check_plan(*shape[1:])


def test_k2_plan_serving_shape():
    """The serve engine's fused launch: all four slots in one cluster of 8
    (the segments read once a launch), one (slot, KV head) pair a rank, 96
    column tiles of 16 (two bf16 vectors a row); the bare form a cluster per
    slot, a rank per KV head, the keys in one range as in the fused form."""
    plan = _check_plan(4, 256, *QWEN.values(), D_MODEL, D_MODEL, 700, 136, 2)
    assert (plan.cluster, plan.slots, plan.splits, plan.cols, plan.tn) == (8, 4, 1, 16, 8)
    assert (plan.stages, plan.wstages) == (3, 8)
    assert plan.grid(4, 1, D_MODEL, True) == (96, 1)
    bare = _check_plan(4, 256, *QWEN.values(), 0, 1, 0, 0, 2)
    assert (bare.cluster, bare.slots, bare.splits) == (2, 1, 1)
    assert bare.grid(4, 1, 1, False) == (2, 4)


@pytest.mark.parametrize("shape", K2_SHAPES, ids=[s[0] for s in K2_SHAPES])
def test_k2_forms_cut_keys_alike(shape):
    """The bare and the fused form of one (B, S, KH) cut every pair's keys in
    the same ranges, so the fused form attends bit for bit as the bare one
    (its bf16 output is held to the projection of the bare form's rows)."""
    _, B, S, H, KH, D, n_cols, bn, P, R, itemsize = shape
    bare = tuning.k2_plan(B, S, H, KH, D, 0, 1, 0, 0, itemsize)
    fused = tuning.k2_plan(B, S, H, KH, D, n_cols or 64, bn, P, R, itemsize)
    assert bare.splits == fused.splits


@pytest.mark.parametrize("bad", [
    dict(itemsize=8), dict(D=257), dict(D=0), dict(KH=5), dict(H=0), dict(B=0), dict(S=0),
    dict(bn=0), dict(P=-1),
])
def test_k2_plan_refuses_out_of_range(bad):
    args = dict(B=4, S=256, H=12, KH=2, D=128, n_cols=D_MODEL, bn=D_MODEL, P=700, R=136,
                itemsize=2)
    args.update(bad)
    with pytest.raises(ValueError):
        tuning.k2_plan(**args)


def test_k2_plan_refuses_what_no_block_holds():
    """One slot's attended vectors alone outgrow 227 KB (fp32, H·D = 65536;
    the previous design refused it too): no plan.  Lanes, heads and splits
    never do: they are chunked, grouped and cut down to fit."""
    with pytest.raises(ValueError, match="no K2 plan fits"):
        tuning.k2_plan(4, 256, 256, 1, 256, 16384, 16384, 16000, 16000, 4)
    _check_plan(4, 256, 64, 1, 256, 16384, 16384, 16000, 16000, 4)


def _previous_design_served(H: int, D: int) -> bool:
    """The previous kernel's shared memory (fp32 whatever the dtype: two
    H·D vectors, H·32 scores, 3·H softmax sums, 2 · 4 · 64 projection
    partials) within 227 KB, at D ≤ 256."""
    return D <= 256 and 4 * (2 * H * D + 35 * H + 2 * 4 * 64) <= 227 * 1024


def _largest_h(D: int, KH: int) -> int:
    return max(h for h in range(KH, 4096, KH) if _previous_design_served(h, D))


# (B, S, KH or 0 for MHA, D): the previous design's widest heads at each D
EDGE = [(B, S, KH, D) for D in (8, 34, 64, 128, 200, 256) for KH in (1, 2, 4, 0)
        for B, S in ((1, 4096), (4, 256))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,KH,D", EDGE)
def test_k2_plan_serves_what_the_previous_design_served(B, S, KH, D, itemsize):
    """At the widest H that the previous kernel held in shared memory, both
    forms get a plan: structured (one block, lanes H·D), column-blocked
    bn = 64 and bn = 1, and the bare form; a plan cuts the G heads of a KV
    head into groups, the lanes into chunks and the key splits down where
    it must."""
    H = _largest_h(D, KH or 1)
    KH = KH or H
    HD = H * D
    P = HD * 9 // 20
    for n_cols, bn, P_, R in ((0, 1, 0, 0), (HD, HD, P, HD - 2 * P), (1536, 64, 700, 136),
                              (1536, 1, 760, 16)):
        _check_plan(B, S, H, KH, D, n_cols, bn, P_, R, itemsize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k3_form_choice(dtype, D):
    """bf16 at a head dim that is a multiple of 16 runs on the tensor cores;
    fp32 (TF32 would miss its 1e-5 gate) and bf16 at D = 8 (below wgmma's
    depth of 16) on the FMA form."""
    want = "tensor_core" if dtype == torch.bfloat16 and D % 16 == 0 else "fma"
    assert kernel_form(dtype, D) == want
