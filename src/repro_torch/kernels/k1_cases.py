"""K1's check cases: the shapes at which the paired GEMM is held to its plain
version on the card (``chip_smoke.py``'s kernel phase and
``tests/test_torch_cuda.py``), and whose launch plans the CPU tests check
(``tests/test_torch_tuning.py``).

A case is ``(name, blocked, M, P, R, N or (B, bn, n_cols), pool, activation,
residual?)``: ``M`` rows, ``P`` pairs and ``R`` residual lanes (``K = 2P +
R``), a structured ``N`` or a column-blocked ``(B, bn, n_cols)``.
"""
from __future__ import annotations

# K1 at decode and prefill rows (the skinny form): qwen2-1.5b's K = 1536 /
# 8960 (and a ragged 1535), N = 256 / 1536 / 8960, structured and blocked
# bn=64, residual on and off, P = 0, R = 0 and P + R = 0.  The serve engine's
# six decoder weights (their P and R at r=0.05 with the seeded weights) at a
# 20-token prefill: two passes of 16 rows over the cluster's ring and gather.
# Past 64 rows: w_down's rows are too long for the tall form's stages, so the
# skinny form runs 7 passes (the last one short); wq takes the tall form.
# Then olmoe-1b-7b's expert grid, deepseek-v2-lite-16b's weights, and
# mamba2-2.7b's and hymba-1.5b's (below).
K1_SKINNY_CASES = [
    ("skinny_M1_K1536_N256", False, 1, 690, 156, 256, "none", "none", False),
    ("skinny_M4_K1536_N1536_res", False, 4, 690, 156, 1536, "none", "none", True),
    ("skinny_M4_K8960_N1536_res", False, 4, 4030, 900, 1536, "none", "none", True),
    ("skinny_M16_K1536_N8960", False, 16, 690, 156, 8960, "none", "silu", False),
    ("skinny_M4_K1535_ragged", False, 4, 701, 133, 1536, "none", "none", False),
    ("skinny_M4_P0", False, 4, 0, 1536, 256, "none", "none", True),
    ("skinny_M4_R0", False, 4, 768, 0, 1536, "none", "none", False),
    ("skinny_M4_PR0", False, 4, 0, 0, 256, "none", "none", True),
    ("skinny_bn64_M4_res", True, 4, 300, 100, (24, 64, 1536), "none", "none", True),
    ("skinny_bn64_M1_K8960", True, 1, 4000, 900, (4, 64, 256), "none", "none", False),
    ("skinny_bn64_M16", True, 16, 300, 100, (140, 64, 8960), "none", "none", False),
    ("skinny_bn64_P0", True, 4, 0, 300, (4, 64, 250), "none", "none", True),
    ("prefill_M20_wq", False, 20, 767, 62, 1536, "none", "none", False),
    ("prefill_M20_wk", False, 20, 765, 106, 256, "none", "none", False),
    ("prefill_M20_wv", False, 20, 768, 82, 256, "none", "none", False),
    ("prefill_M20_w_gate", False, 20, 766, 70, 8960, "none", "none", False),
    ("prefill_M20_w_up", False, 20, 767, 94, 8960, "none", "none", False),
    ("prefill_M20_w_down_res", False, 20, 4478, 316, 1536, "none", "none", True),
    ("passes_M100_w_down_res", False, 100, 4478, 316, 1536, "none", "none", True),
    ("tall_M100_wq", False, 100, 767, 62, 1536, "none", "none", False),
] + [
    # olmoe-1b-7b's experts on the expert grid: one block per expert, 64
    # blocks of 1024 columns (gate/up, K = 2048) or 2048 (down, K = 1024).
    # Decode rows (M = 4, every expert on every token) at the pairs r=0.05
    # leaves on seeded weights, and r=0 (no pairs) at the parity engine's 2
    # rows; routed prefill rows, one expert's capacity a row block: C = 4
    # for a 24-token prompt, C = 10 for a 64-token one.
    ("expert_gate_M4", True, 4, 1018, 12, (64, 1024, 65536), "none", "silu", False),
    ("expert_down_M4", True, 4, 500, 24, (64, 2048, 131072), "none", "none", False),
    ("expert_gate_r0_M2", True, 2, 0, 2048, (64, 1024, 65536), "none", "silu", False),
    ("expert_down_r0_M2", True, 2, 0, 1024, (64, 2048, 131072), "none", "none", False),
    ("expert_gate_C10", True, 10, 1018, 12, (64, 1024, 65536), "none", "silu", False),
    ("expert_down_C10", True, 10, 500, 24, (64, 2048, 131072), "none", "none", False),
] + [
    # deepseek-v2-lite-16b at its pairs at r=0.05 on seeded weights: MLA's
    # wq (N = 3072), w_dkv (512) and w_kr (64) at 4 decode rows; the dense
    # first layer's down-projection (K = 10944, residual fused) at 4 decode
    # rows (skinny, split-K) and a 64-token prefill; the shared experts'
    # gate (N = 2816); the expert grid at 1408 columns an expert (gate on 4
    # shared rows and a 24-token prompt's capacity of 3, down with K = 1408).
    ("mla_wq_M4", False, 4, 1015, 18, 3072, "none", "none", False),
    ("mla_w_dkv_M4", False, 4, 992, 64, 512, "none", "none", False),
    ("mla_w_kr_M4", False, 4, 1015, 18, 64, "none", "none", False),
    ("mlp0_down_K10944_M4_res", False, 4, 5466, 12, 2048, "none", "none", True),
    ("mlp0_down_K10944_M64_res", False, 64, 5466, 12, 2048, "none", "none", True),
    ("shared_gate_M4", False, 4, 996, 56, 2816, "none", "silu", False),
    ("expert1408_gate_M4", True, 4, 965, 118, (64, 1408, 90112), "none", "silu", False),
    ("expert1408_gate_C3", True, 3, 965, 118, (64, 1408, 90112), "none", "silu", False),
    ("expert1408_down_M4", True, 4, 694, 20, (64, 2048, 131072), "none", "none", False),
] + [
    # mamba2-2.7b's SSM projections at their pairs at r=0.05 on seeded
    # weights: w_x (w_z alike, N = 5120), w_B (w_C alike, N = 128), w_dt
    # (N = 80) and w_out (K = 5120) at 4 decode rows; w_x and w_out at a
    # 300-token prompt's rows
    ("mamba_w_x_M4", False, 4, 1256, 48, 5120, "none", "none", False),
    ("mamba_w_B_M4", False, 4, 1269, 22, 128, "none", "none", False),
    ("mamba_w_dt_M4", False, 4, 1279, 2, 80, "none", "none", False),
    ("mamba_w_out_M4", False, 4, 2533, 54, 2560, "none", "none", False),
    ("mamba_w_x_M300", False, 300, 1256, 48, 5120, "none", "none", False),
    ("mamba_w_out_M300", False, 300, 2533, 54, 2560, "none", "none", False),
    # hymba-1.5b the same way: wq (N = 1600), wk (N = 320, no residual
    # lanes), the MLP's gate (N = 5504) and down (K = 5504, residual fused),
    # the SSM block's w_z (N = 3200), w_B (N = 16), w_dt (N = 50) and w_out
    # (K = 3200) at 4 decode rows; the column-blocked engine's fused QKV (35
    # blocks of 64); gate and w_B at 1328 prefill rows (128 meta + 1200)
    ("hymba_wq_M4", False, 4, 784, 32, 1600, "none", "none", False),
    ("hymba_wk_M4", False, 4, 800, 0, 320, "none", "none", False),
    ("hymba_w_gate_M4", False, 4, 770, 60, 5504, "none", "silu", False),
    ("hymba_w_down_M4_res", False, 4, 2706, 92, 1600, "none", "none", True),
    ("hymba_w_z_M4", False, 4, 793, 14, 3200, "none", "none", False),
    ("hymba_w_B_M4", False, 4, 766, 68, 16, "none", "none", False),
    ("hymba_w_dt_M4", False, 4, 795, 10, 50, "none", "none", False),
    ("hymba_w_out_M4", False, 4, 1564, 72, 1600, "none", "none", False),
    ("hymba_qkv_bn64_M4", True, 4, 780, 40, (35, 64, 2240), "none", "none", False),
    ("hymba_w_gate_M1328", False, 1328, 770, 60, 5504, "none", "silu", False),
    ("hymba_w_B_M1328", False, 1328, 766, 68, 16, "none", "none", False),
]


def k1_cases() -> list[tuple]:
    """K1's cases in the kernel phase: (name, blocked, M, P, R, N or (B, bn,
    n_cols), pool, activation, dtype, residual dtype), dtypes by name."""
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [
            ("dense_P0", False, 1000, 0, 150, 16, "none", "relu", dt, None),
            ("structured", False, 777, 37, 76, 120, "none", "none", dt, None),
            ("R0", False, 129, 64, 0, 33, "none", "relu", dt, None),
            ("pool_max2", False, 515, 9, 7, 6, "max2", "relu", dt, None),
            ("pool_avg2", False, 300, 20, 110, 16, "avg2", "tanh", dt, None),
            ("residual_f32", False, 257, 12, 30, 40, "none", "gelu", dt, "float32"),
            ("residual_bf16", False, 257, 12, 30, 40, "max2", "silu", dt, "bfloat16"),
            ("ragged_M1", False, 1, 3, 2, 7, "none", "none", dt, None),
            ("empty_PR0", False, 300, 0, 0, 16, "max2", "gelu", dt, "float32"),
            ("blocked_bn1", True, 501, 11, 3, (6, 1, 6), "max2", "relu", dt, None),
            ("blocked_bn4_short", True, 333, 20, 110, (4, 4, 14), "none", "relu", dt, "float32"),
            ("blocked_bn4_avg2", True, 200, 5, 15, (4, 4, 13), "avg2", "none", dt, None),
            ("blocked_empty", True, 100, 0, 0, (3, 4, 10), "none", "silu", dt, None),
        ]
        cases += [(*case[:8], dt, dt if case[8] else None) for case in K1_SKINNY_CASES]
    for act in ("none", "relu", "gelu", "silu", "tanh"):
        # inputs scaled by 0.1 in the phase: pre-activations of order one,
        # where the saturating activations are not flat
        cases.append((f"act_{act}", False, 640, 30, 65, 24, "none", act, "float32", None))
    return cases
