"""The port's CUDA kernels on the card (``cuda`` marker; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it also runs where only
the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same CUDA tensors:
the paired GEMM in fp32 to 1e-5 relative to the largest output, the decode
attention in fp32 to 2e-5 (the JAX decode tests' tolerance), both in bf16
to 2 output ulps of the fp32 oracle (the plain version without its final
cast); the flash-attention forward in fp32 to 1e-5 and in bf16 to 1 output
ulp (one rounding of its fp32 result).  The paper's path: 16
training steps on the card against the CPU, Fig. 8's conv→pool counts and
its r = 0 measured path through K1.  The MoE path: every expert's GEMM in
one K1 launch over the expert grid, and the olmoe smoke engine at r = 0.
The MLA path: the deepseek smoke engine at r = 0 on both expert branches.
The SSM and hybrid paths: the mamba2 and hymba smoke engines at r = 0 (a
2-token prompt, shorter than the conv tail, and prompts whose window drops
keys), and K2 at hymba's heads (G = 5 over 5 KV heads) with its window and
sinks.  The rest of the zoo (qwen3, granite, mistral, whisper with its
stub frames and K3 on the encoder, internvl2 with its stub patches): each
smoke engine at r = 0.  The LM training path: K1's differentiable GEMMs forward and
backward against their plain versions, and a training step of the qwen2
smoke model on the card against the CPU under every K1 policy (loss within
1e-5, gradients within rtol 1e-4, atol 1e-5), launching K1 as
``analysis.train_launches`` says; the expert grid's and the fused decode
attention's differentiable ops forward and backward against their plain
compositions, and a training step of the olmoe and deepseek smoke models
(the experts on the expert grid) on the card against the CPU.  K1's tile
cache: every candidate plan (``tuning.candidate_plans``) at qwen2's
decode shapes against the plain version, with the shared memory the
planner models; the smoke engine serving the plans of a cache, with the
tokens of the engine without it; a refused cached plan raising with its key.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import fig8
from repro_torch.configs import get_smoke_config
from repro_torch.core.pairing import pair_rows_blocked
from repro_torch.core.transform import _stack_blocked, build_conv_pairings
from repro_torch.data.mnist import batches, load_mnist, pad_to_32
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.k1_cases import K1_SKINNY_CASES
from repro_torch.kernels.ref import bf16_ulps, rel_err
from repro_torch.models import lm as M
from repro_torch.models.lenet import init_lenet, lenet_apply, lenet_loss
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.loop import train
from repro_torch.train.optimizer import adamw, cosine_schedule

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K1_SKINNY_CASES,
                         ids=[c[0] for c in K1_SKINNY_CASES])
def test_kernel_at_decode_rows(cuda, dtype, case):
    """K1's skinny form (and the tall one at P + R = 0 and past 64 rows) at
    qwen2's decode and prefill shapes: one launch, the plain version's
    values, the same bits from a second launch (the cluster adds its partial
    sums in order), and the shared memory the plan models."""
    name, blocked, M, P, R, N, pool, act, residual = case
    g = torch.Generator(device=cuda).manual_seed(11)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    if blocked:
        B, bn, n_cols = N
        x, kmat, w_res = rnd(B, M, 2 * P + R), rnd(B, P, bn), rnd(B, R, bn)
        kmat[-1, :, n_cols - (B - 1) * bn:] = 0  # the short block's padded columns
        w_res[-1, :, n_cols - (B - 1) * bn:] = 0
    else:
        n_cols = N
        x, kmat, w_res = rnd(M, 2 * P + R), rnd(P, N), rnd(R, N)
    bias = rnd(n_cols, dt=torch.float32)
    res = rnd(M, n_cols) if residual else None
    kw = dict(residual=res, activation=act)
    if blocked:
        launch = lambda: pm.paired_matmul_blocked_cuda(x, kmat, w_res, bias, n_cols=n_cols, **kw)
        want = pm.paired_matmul_blocked_plain(x, kmat, w_res, bias, n_cols=n_cols,
                                              out_dtype=torch.float32, **kw)
    else:
        launch = lambda: pm.paired_matmul_cuda(x, kmat, w_res, bias, **kw)
        want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
    got = launch()
    assert pm.launch_count() == 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, n_cols)
    _check(got, want, dtype)
    assert torch.equal(launch(), got)
    plan = pm.launch_plan(x, kmat, w_res)
    assert pm.kernel_smem(plan, P, R, 1, x.element_size()) == plan.smem


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
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("block_n", [0, 3])
def test_expert_dense_on_the_card(cuda, monkeypatch, dtype, per_expert, block_n):
    """Every expert's GEMM as one K1 launch over the expert grid equals the
    plain version of the same call on the CPU copies of its operands, without
    the final cast (fp32 1e-5, bf16 2 ulps of that fp32 oracle)."""
    import functools

    from repro_torch.core.pairing import pair_rows_structured
    from repro_torch.core.transform import _stack_structured

    g = torch.Generator().manual_seed(7)
    E, K, F, Mr = 8, 40, 12, 5
    w = torch.randn(E, K, F, generator=g) * 0.3
    # r = 0.3: structured pairing finds pairs on rows this short
    if block_n:
        meta = _stack_blocked([pair_rows_blocked(w[e].double().numpy(), 0.3, block_n)
                               for e in range(E)])
    else:
        meta = _stack_structured([pair_rows_structured(w[e].double().numpy(), 0.3)
                                  for e in range(E)])
    assert meta["pair_mask"].sum() > 0
    meta = {k: torch.as_tensor(v, device=cuda) for k, v in meta.items()}
    meta.update({k: meta[k].long() for k in ("I", "J", "resid")})
    x = torch.randn(*((E, Mr, K) if per_expert else (Mr, K)), generator=g).to(cuda, dtype)
    seg = ops.lm_expert_segments(w.to(cuda, dtype), meta, block_n)
    got = ops.expert_dense(x, seg, activation="silu", x_per_expert=per_expert)
    assert pm.LAUNCHES == {"paired_matmul_blocked": 1}  # pairs in the blocks: not P == 0
    assert got.shape == (Mr, E, F) and got.dtype == dtype
    monkeypatch.setattr(pm, "paired_matmul_blocked_plain", functools.partial(
        pm.paired_matmul_blocked_plain, out_dtype=torch.float32))
    seg_cpu = ops.PairedSegments(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in seg))
    want = ops.expert_dense(x.cpu(), seg_cpu, activation="silu", x_per_expert=per_expert)
    _check(got.cpu(), want, dtype)


@pytest.mark.parametrize("prompt", [5, 11])
def test_moe_engine_paired_fused_matches_plain_engine(cuda, prompt):
    """olmoe smoke at r=0, fp32: the paired expert GEMMs and the fused
    decode attention give the plain engine's tokens, logits within 1e-5; a
    decode layer launches 6 K1 (3 QKV, 3 expert projections) and 1 K2."""
    from repro_torch.analysis import decode_launches

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    base = dict(q_chunk=16, k_chunk=16)
    knobs = M.PerfKnobs(**base, gemm="pallas_paired", attn="pallas_fused")
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**base))
    fused = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=knobs)
    prompts = {s: np.random.default_rng(s).integers(0, cfg.vocab, size=prompt) for s in (0, 1)}
    for slot, p in prompts.items():
        assert plain.add_request(slot, p) == fused.add_request(slot, p)
    pm.reset_launches()
    da.reset_launches()
    for _ in range(4):
        np.testing.assert_array_equal(plain.step(), fused.step())
        assert rel_err(fused.last_logits, plain.last_logits) <= RTOL
    want = decode_launches(cfg, "moe", knobs)
    assert pm.launch_count() == want["paired_matmul"] * 4 * cfg.n_layers
    assert da.launch_count() == want["decode_attention"] * 4 * cfg.n_layers


@pytest.mark.parametrize("prompt", [5, 11])
def test_mla_engine_paired_matches_plain_engine(cuda, prompt):
    """deepseek smoke (MLA, shared experts, a dense first layer) at r=0,
    fp32: the paired engine gives the plain engine's tokens, logits within
    1e-5, the 5-token prompt on the dense expert branch, the 11-token one
    routed; a decode step launches 7 K1 in the dense layer and 10 in each
    MoE layer, and no K2 (MLA's decode attention is latent einsums)."""
    from repro_torch.analysis import decode_launches

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    base = dict(q_chunk=16, k_chunk=16)
    knobs = M.PerfKnobs(**base, gemm="pallas_paired", attn="pallas_fused")
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=knobs)
    prompts = {s: np.random.default_rng(s).integers(0, cfg.vocab, size=prompt) for s in (0, 1)}
    for slot, p in prompts.items():
        assert plain.add_request(slot, p) == paired.add_request(slot, p)
    pm.reset_launches()
    da.reset_launches()
    for _ in range(4):
        np.testing.assert_array_equal(plain.step(), paired.step())
        assert rel_err(paired.last_logits, plain.last_logits) <= RTOL
    want = sum(decode_launches(cfg, cfg.layer_kind(i), knobs)["paired_matmul"]
               for i in range(cfg.n_layers))
    assert want == 7 + 10 * (cfg.n_layers - 1)
    assert pm.launch_count() == want * 4
    assert da.launch_count() == 0


@pytest.mark.parametrize("arch,prompts", [("mamba2-2.7b", (2, 37)), ("hymba-1.5b", (5, 30))])
@pytest.mark.parametrize("block_n", [0, 16])
def test_ssm_and_hybrid_engines_paired_match_plain_engine(cuda, arch, prompts, block_n):
    """mamba2 and hymba smoke at r=0, fp32: the paired engine (fused decode
    attention for hymba) gives the plain engine's tokens, logits within
    1e-5; the launches of a decode step are ``decode_launches``' (6 K1 an
    SSM layer; 12 K1 and a K2 a hybrid one, 10 K1 with column blocks)."""
    from repro_torch.analysis import decode_launches

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    base = dict(q_chunk=8, k_chunk=8)
    knobs = M.PerfKnobs(**base, gemm="pallas_paired", attn="pallas_fused", pair_block_n=block_n)
    plain = ServeEngine(cfg, model, max_seq=48, batch_size=2, knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=48, batch_size=2, knobs=knobs)
    for slot, n in enumerate(prompts):
        p = np.random.default_rng(slot).integers(0, cfg.vocab, size=n)
        assert plain.add_request(slot, p) == paired.add_request(slot, p)
    pm.reset_launches()
    da.reset_launches()
    for _ in range(4):
        np.testing.assert_array_equal(plain.step(), paired.step())
        assert rel_err(paired.last_logits, plain.last_logits) <= RTOL
    want = [decode_launches(cfg, cfg.layer_kind(i), knobs) for i in range(cfg.n_layers)]
    assert pm.launch_count() == 4 * sum(w["paired_matmul"] for w in want)
    assert da.launch_count() == 4 * sum(w["decode_attention"] for w in want)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-3-2b", "mistral-large-123b",
                                  "whisper-base", "internvl2-2b"])
def test_zoo_engines_paired_match_plain_engine(cuda, arch):
    """The zoo's smoke configs at r=0, fp32: the paired engine with fused
    decode attention gives the plain engine's tokens, logits within 1e-5,
    with whisper's stub frames and internvl2's stub patches; the prefill
    launches K1 (and whisper's K3) as ``prefill_launches`` says, a decode
    step as ``decode_launches`` says."""
    from repro_torch.analysis import decode_launches, prefill_launches
    from repro_torch.launch.inputs import make_batch

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    base = dict(q_chunk=8, k_chunk=8)
    knobs = M.PerfKnobs(**base, gemm="pallas_paired", attn="pallas_fused")
    plain = ServeEngine(cfg, model, max_seq=48, batch_size=2, knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=48, batch_size=2, knobs=knobs)
    stubs = make_batch(cfg, 2, 1, "prefill", seed=0, device=cuda)
    pm.reset_launches()
    fa.reset_launches()
    for slot, n in enumerate((cfg.vision_prefix + 3, cfg.vision_prefix + 20)):
        p = np.random.default_rng(slot).integers(0, cfg.vocab, size=n)
        extras = {k: v[slot:slot + 1] for k, v in stubs.items() if k in M.EXTRAS}
        assert plain.add_request(slot, p, extras) == paired.add_request(slot, p, extras)
    want = prefill_launches(cfg, knobs)
    assert pm.launch_count() == 2 * want["paired_matmul"]
    assert fa.launch_count() == 2 * want["flash_attention"]
    assert (fa.launch_count() > 0) == (cfg.encoder is not None)
    pm.reset_launches()
    da.reset_launches()
    for _ in range(4):
        np.testing.assert_array_equal(plain.step(), paired.step())
        assert rel_err(paired.last_logits, plain.last_logits) <= RTOL
    per = [decode_launches(cfg, cfg.layer_kind(i), knobs) for i in range(cfg.n_layers)]
    assert pm.launch_count() == 4 * sum(w["paired_matmul"] for w in per)
    assert da.launch_count() == 4 * sum(w["decode_attention"] for w in per)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_hymba_heads(cuda, dtype):
    """K2 at hymba-1.5b's heads (H 25 over KH 5, D 64) with its window of
    1024 and 128 sinks, fused with a structured 1600-column out-projection
    and no residual: slots whose window drops keys, one that attends every
    key, one at the first position."""
    g = torch.Generator(device=cuda).manual_seed(8)
    B, S, H, KH, D, N = 4, 1408, 25, 5, 64, 1600
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    q, kc, vc = rnd(B, 1, H, D).to(dtype), rnd(B, S, KH, D).to(dtype), rnd(B, S, KH, D).to(dtype)
    pos = torch.tensor([1359, 1200, 500, 0], dtype=torch.int32, device=cuda)
    kw = dict(window=1024, n_sink=128)
    got = da.decode_attention_cuda(q, kc, vc, pos, **kw)
    _check(got, da.decode_attention_plain(q, kc, vc, pos, out_dtype=torch.float32, **kw),
           dtype, ATTN_RTOL)
    seg = _outproj(rnd(H * D, N) * 0.1, 0.3, 0)
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dtype),
            seg.w_res.to(dtype), None)
    fused = da.fused_decode_attention_cuda(*args, n_cols=N, **kw)
    if dtype == torch.float32:
        want = da.fused_decode_attention_plain(*args, n_cols=N, out_dtype=dtype, **kw)
    else:
        want = da.outproj_plain(got, *args[4:], n_cols=N, out_dtype=torch.float32)
    assert fused.dtype == dtype and fused.shape == (B, N)
    _check(fused, want, dtype, ATTN_RTOL)
    assert torch.equal(da.fused_decode_attention_cuda(*args, n_cols=N, **kw), fused)


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


def test_flash_attention_tensor_core_form_reads_strided_views(cuda):
    """The tensor-core form's strided reads: q a (B, S, H, D) view of a
    (B, H, S, D) tensor, k sliced from a wider head axis and v a view of a
    (B, KH, S, D) tensor, so that no two of the nine strides agree where a
    mix-up could hide; within one bf16 ulp of the plain version and equal to
    the contiguous copies' result."""
    g = torch.Generator(device=cuda).manual_seed(16)
    B, Sq, Sk, H, KH, D = 2, 96, 160, 12, 2, 128
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    q = rnd(B, H, Sq, D).transpose(1, 2)
    k = rnd(B, Sk, 5, D)[:, :, 1:3]
    v = rnd(B, KH, Sk, D).transpose(1, 2)
    assert len({q.stride()[:3], k.stride()[:3], v.stride()[:3]}) == 3
    assert fa.kernel_form(q.dtype, D) == "tensor_core"
    for causal in (True, False):
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert bf16_ulps(got, want) <= 1.0
        assert torch.equal(got, fa.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_serving_shape(cuda, dtype):
    """K2 at qwen2-1.5b's serving shape (B 4, H 12, KH 2, D 128, S 256, slots
    at positions 8-51, structured out-projection): both forms against their
    plain versions, a second launch bit-identical (the cluster merges its
    partials in rank order)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, S, H, KH, D, N = 4, 256, 12, 2, 128, 1536
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    q, kc, vc = rnd(B, 1, H, D).to(dtype), rnd(B, S, KH, D).to(dtype), rnd(B, S, KH, D).to(dtype)
    pos = torch.tensor([8, 23, 37, 51], dtype=torch.int32, device=cuda)
    seg = _outproj(rnd(H * D, N) * 0.1, 0.3, 0)
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dtype),
            seg.w_res.to(dtype), rnd(B, N).to(dtype))
    bare = da.decode_attention_cuda(q, kc, vc, pos)
    _check(bare, da.decode_attention_plain(q, kc, vc, pos, out_dtype=torch.float32), dtype,
           ATTN_RTOL)
    got = da.fused_decode_attention_cuda(*args, n_cols=N)
    if dtype == torch.float32:
        want = da.fused_decode_attention_plain(*args, n_cols=N, out_dtype=dtype)
    else:
        want = da.outproj_plain(bare, *args[4:], n_cols=N, out_dtype=torch.float32)
    _check(got, want, dtype, ATTN_RTOL)
    assert torch.equal(da.decode_attention_cuda(q, kc, vc, pos), bare)
    assert torch.equal(da.fused_decode_attention_cuda(*args, n_cols=N), got)


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 512, 512), (True, 333, 333), (False, 200, 512)])
def test_flash_attention_tensor_core_form(cuda, causal, Sq, Sk):
    """K3's tensor-core form (bf16, D 128) at qwen2's heads: within one bf16
    ulp of the plain version (p kept in fp32 as a bf16 hi + lo pair)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
               for shape in ((2, Sq, 12, 128), (2, Sk, 2, 128), (2, Sk, 2, 128)))
    assert fa.kernel_form(q.dtype, 128) == "tensor_core"
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert bf16_ulps(got, want) <= 1.0
    assert torch.equal(fa.flash_attention_fwd(q, k, v, causal=causal), got)


@pytest.mark.parametrize("name,dtype,S,H,D,block_n,N", [
    # unpaired, H·D = 1024 at D 256: the plan takes the 4-deep weight ring
    ("shallow_weight_ring", torch.float32, 64, 4, 256, None, 1024),
    # 68-byte rows (element copies, not 16-byte ones), D % 4 != 0, G = 3
    ("unaligned_rows", torch.bfloat16, 77, 6, 34, 0, 150),
    # G = 48 at D = 256 (H·D = 24576): the heads in groups, the lanes in
    # chunks, one slot a cluster, shallow rings
    ("wide_heads_grouped", torch.float32, 300, 96, 256, 0, 300),
    # G = 32 at D = 128, bf16: the lanes in chunks, four slots a cluster
    ("wide_heads_chunked", torch.bfloat16, 300, 64, 128, 0, 512),
])
def test_decode_attention_plan_edges(cuda, name, dtype, S, H, D, block_n, N):
    """K2 on the paths the serving shapes do not take, against the plain
    versions, with a bit-identical relaunch."""
    g = torch.Generator(device=cuda).manual_seed(14)
    B, KH = 4, 2
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    q, kc, vc = rnd(B, 1, H, D).to(dtype), rnd(B, S, KH, D).to(dtype), rnd(B, S, KH, D).to(dtype)
    pos = torch.tensor([3, S // 2, S - 1, 40], dtype=torch.int32, device=cuda)
    seg = _outproj(rnd(H * D, N) * 0.1, 0.3, block_n)
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dtype),
            seg.w_res.to(dtype), rnd(B, N).to(dtype))
    Bw, P, bn = seg.kmat.shape
    plan = da.launch_plan(q, kc, N, bn, P, seg.w_res.shape[1])
    if name == "shallow_weight_ring":
        assert plan.wstages == 4
    if name == "wide_heads_grouped":
        assert plan.groups > 1 and plan.chunk < P + seg.w_res.shape[1]
        assert da.launch_plan(q, kc).groups > 1
    if name == "wide_heads_chunked":
        assert plan.chunk < P + seg.w_res.shape[1]
    bare = da.decode_attention_cuda(q, kc, vc, pos)
    _check(bare, da.decode_attention_plain(q, kc, vc, pos, out_dtype=torch.float32), dtype,
           ATTN_RTOL)
    got = da.fused_decode_attention_cuda(*args, n_cols=N)
    if dtype == torch.float32:
        want = da.fused_decode_attention_plain(*args, n_cols=N, out_dtype=dtype)
    else:
        want = da.outproj_plain(bare, *args[4:], n_cols=N, out_dtype=torch.float32)
    _check(got, want, dtype, ATTN_RTOL)
    assert torch.equal(da.decode_attention_cuda(q, kc, vc, pos), bare)
    assert torch.equal(da.fused_decode_attention_cuda(*args, n_cols=N), got)


def test_flash_attention_tensor_core_form_copies_misaligned_views(cuda):
    """The tensor-core form reads 16-byte rows: a bf16 view that starts off a
    16-byte boundary is copied first and gives the aligned result."""
    g = torch.Generator(device=cuda).manual_seed(15)
    shape = (2, 96, 12, 128)
    buf = torch.randn(2 * 96 * 12 * 128 + 1, generator=g, device=cuda).to(torch.bfloat16)
    q = buf[1:].view(shape)
    assert q.data_ptr() % 16
    k, v = (torch.randn(2, 96, 2, 128, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    got = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, fa.flash_attention_fwd(q.clone(), k, v))


@pytest.fixture(scope="module")
def mnist_small():
    """1024 training and 64 test images of the synthetic MNIST, 32×32."""
    x, y, _ = load_mnist("train", synthetic_n=1024, seed=0)
    tx, ty, _ = load_mnist("test", synthetic_n=64, seed=0)
    return pad_to_32(x), y, pad_to_32(tx), ty


def test_training_on_the_card_matches_the_cpu(cuda, mnist_small):
    """16 AdamW steps of the trainer's recipe from the same init on the card
    and on the CPU: every loss within 1e-4 relative, params within 1e-4."""
    x, y, _, _ = mnist_small

    def run(device):
        opt = adamw(cosine_schedule(1e-3, 16, warmup_steps=50))
        return train(init_lenet(0, device=device), lenet_loss, opt,
                     batches(x, y, 128, seed=0, epochs=2), log_every=0, verbose=False)

    (p_gpu, i_gpu), (p_cpu, i_cpu) = run(cuda), run("cpu")
    assert i_gpu["steps"] == i_cpu["steps"] == 16
    np.testing.assert_allclose(i_gpu["losses"], i_cpu["losses"], rtol=1e-4)
    for layer, sub in p_cpu.items():
        for k, t in sub.items():
            assert p_gpu[layer][k].is_cuda
            np.testing.assert_allclose(p_gpu[layer][k].cpu().numpy(), t.numpy(), rtol=0,
                                       atol=1e-4)


def test_fused_pool_path_counts_on_the_card(cuda, mnist_small):
    """Fig. 8's conv→pool audit through K1: 3 launches and no standalone
    pool on both fused layouts, 2 pools unfused, r = 0 within 1e-5."""
    out = fig8.fused_pool_path(init_lenet(0), mnist_small[2], batch=32)
    v = out["variants"]
    for tag in ("paired_fused", "paired_fused_blocked"):
        assert (v[tag]["k1_launches"], v[tag]["k1_calls"], v[tag]["pool_ops"]) == (3, 3, 0)
        assert v[tag]["rel_err_vs_torch"] <= RTOL and v[tag]["ms"] > 0
    assert (v["paired_unfused"]["k1_launches"], v["paired_unfused"]["pool_ops"]) == (3, 2)
    assert (v["torch"]["k1_launches"], v["torch"]["pool_ops"]) == (0, 2)


@pytest.mark.parametrize("mode,block_n", [("structured", 0), ("column_blocked", 4),
                                          ("column_blocked", 1)])
def test_measured_conv_path_at_r0_through_k1(cuda, mnist_small, mode, block_n):
    out = fig8.measured_conv_path(init_lenet(0), mnist_small[2], 0.0, batch=32, mode=mode,
                                  block_n=block_n)
    assert out["k1_launches"] == 3
    assert out["rel_err_vs_conv2d"] <= RTOL
    assert out["total_baseline_lanes"] == 405600


def test_trace_step_sees_the_whole_step(cuda):
    """The padded, marker-fenced trace that ``chip_smoke.py`` profiles steps
    with keeps every kernel of a 2100-kernel step and both markers."""
    from repro_torch.benchmarks.profiler_window import probe

    (row,) = probe([0.1], reps=3)
    assert (row["traces"], row["cut"]) == (3, 0)


# ---------------------------------------------------------------------------
# LM training: K1 under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["dense", "structured", "blocked"])
def test_k1_functions_forward_and_backward(cuda, dtype, form):
    """``ops.fused_dense`` and ``ops.fused_paired_dense`` on the card: the
    output within 1e-5 relative (fp32) or 2 ulps of the fp32 oracle (bf16),
    one launch; the gradients equal those of the plain version's autograd
    (the backward is torch.matmul of the same folded weight) within 1e-5
    relative in fp32, and no launch in the backward."""
    from repro_torch.core.pairing import pair_rows_structured

    gen = torch.Generator(device="cuda").manual_seed(0)
    M_, K, N = 96, 72, 40
    x = torch.randn(M_, K, generator=gen, device="cuda").to(dtype).requires_grad_()
    w0 = torch.randn(K, N, generator=gen, device="cuda") * 0.1
    w64 = w0.double().cpu().numpy()
    w = w0.to(dtype).clone().requires_grad_()
    res = torch.randn(M_, N, generator=gen, device="cuda").to(dtype).requires_grad_()

    def oracle_gemm(xg, kmat, w_res, bias, residual, n_cols, act):
        """K1's plain version without its final cast: the bf16 oracle."""
        if kmat.ndim == 3:
            return pm.paired_matmul_blocked_plain(xg, kmat, w_res, bias, n_cols=n_cols,
                                                  residual=residual, activation=act,
                                                  out_dtype=torch.float32)
        return pm.paired_matmul_plain(xg, kmat, w_res, bias, residual=residual, activation=act,
                                      out_dtype=torch.float32)

    if form == "dense":
        fn = lambda x, w, r: ops.fused_dense(x, w, activation="silu")
        plain = lambda x, w, r: pm.ACTIVATIONS["silu"](torch.matmul(x, w))
        oracle = lambda x, w, r: oracle_gemm(x, w.new_zeros((0, N)), w, None, None, N, "silu")
        live = (x, w)
    else:
        if form == "structured":
            sp = pair_rows_structured(w64, 0.05)
            meta = {"I": sp.I, "J": sp.J, "resid": sp.resid,
                    "pair_mask": np.ones(sp.n_pairs), "resid_mask": np.ones(len(sp.resid))}
            bn = 0
        else:
            meta, bn = {k: v[0] for k, v in _stack_blocked([pair_rows_blocked(w64, 0.05, 16)]
                                                         ).items()}, 16
        meta = {k: torch.as_tensor(v, device="cuda").to(
            torch.float32 if k.endswith("mask") else torch.int64) for k, v in meta.items()}
        fn = lambda x, w, r: ops.fused_paired_dense(x, w, meta, residual=r, pair_block_n=bn)
        plain = lambda x, w, r: ops.fused_paired_dense_ref(x, w, meta, residual=r,
                                                           pair_block_n=bn)
        oracle = lambda x, w, r: ops._paired_dense(x, ops.lm_paired_segments(w, meta, bn),
                                                   None, "none", r, oracle_gemm)
        live = (x, w, res)
    y = fn(x, w, res)
    assert pm.launch_count() == 1
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    grads = torch.autograd.grad(y, live, dy)
    assert pm.launch_count() == 1
    want = plain(x, w, res)
    want_grads = torch.autograd.grad(want, live, dy)
    if dtype == torch.float32:
        assert rel_err(y, want) <= RTOL
        for g, r in zip(grads, want_grads, strict=True):
            assert rel_err(g, r) <= RTOL
    else:
        assert bf16_ulps(y, oracle(*(t.detach() for t in (x, w, res)))) <= BF16_ULPS
        for g, r in zip(grads, want_grads, strict=True):
            assert g.dtype == r.dtype and torch.isfinite(g).all()


@pytest.mark.parametrize("gemm,block_n", [("pallas", 0), ("pallas_paired", 0),
                                          ("pallas_paired", 16)])
def test_lm_training_step_on_the_card_matches_the_cpu(cuda, gemm, block_n):
    from repro_torch.analysis import train_launches
    from repro_torch.core.transform import pair_lm_params

    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    values = M.lm_value_tree(M.init_lm(cfg, 0, device="cpu"))
    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, xent_chunk=8, gemm=gemm, pair_block_n=block_n)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 12))

    def run(device):
        model = M.lm_params_from_numpy(_numpy_tree(values), cfg, device=device)
        if gemm == "pallas_paired":
            mode = "column_blocked" if block_n else "structured"
            model, _ = pair_lm_params(model, 0.05, mode=mode, block_n=block_n)
        model.requires_grad_(True)
        t = torch.as_tensor(tokens, device=device)
        before = pm.launch_count()
        loss, _ = M.lm_loss(cfg, model, {"tokens": t, "labels": t}, knobs=knobs)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        return float(loss), grads, pm.launch_count() - before

    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = run(cuda), run("cpu")
    assert (n_gpu, n_cpu) == (train_launches(cfg, knobs), 0)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for name, g in g_cpu.items():
        np.testing.assert_allclose(g_gpu[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _numpy_tree(tree):
    """A value tree of tensors as numpy arrays (``lm_params_from_numpy``'s
    input)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("block_n", [0, 3])
def test_expert_grid_function_forward_and_backward(cuda, dtype, per_expert, block_n):
    """``ops.fused_paired_expert_dense`` on the card, structured and blocked
    within each expert (bn 3 leaves a short last block of 13 columns): one
    K1 launch forward, none backward; the output within 1e-5 relative of its
    plain reference (fp32) or 2 ulps of K1's fp32 oracle (bf16); ``dx`` and
    ``dw`` within 1e-5 relative of autograd of the reference in fp32."""
    from repro_torch.core.pairing import pair_rows_structured
    from repro_torch.core.transform import _stack_structured

    g = torch.Generator().manual_seed(9)
    E, K, F, Mr = 8, 40, 13, 6
    w0 = torch.randn(E, K, F, generator=g) * 0.3
    if block_n:
        meta = _stack_blocked([pair_rows_blocked(w0[e].double().numpy(), 0.3, block_n)
                               for e in range(E)])
    else:
        meta = _stack_structured([pair_rows_structured(w0[e].double().numpy(), 0.3)
                                  for e in range(E)])
    assert meta["pair_mask"].sum() > 0
    meta = {k: torch.as_tensor(v, device=cuda) for k, v in meta.items()}
    meta.update({k: meta[k].long() for k in ("I", "J", "resid")})
    x = torch.randn(*((E, Mr, K) if per_expert else (Mr, K)), generator=g).to(cuda, dtype)
    x.requires_grad_()
    w = w0.to(cuda, dtype).requires_grad_()
    kw = dict(activation="silu", x_per_expert=per_expert, pair_block_n=block_n)
    y = ops.fused_paired_expert_dense(x, w, meta, **kw)
    assert pm.LAUNCHES == {"paired_matmul_blocked": 1} and y.shape == (Mr, E, F)
    dy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    grads = torch.autograd.grad(y, (x, w), dy)
    assert pm.launch_count() == 1
    want = ops.fused_paired_expert_dense_ref(x, w, meta, **kw)
    want_grads = torch.autograd.grad(want, (x, w), dy)
    if dtype == torch.float32:
        assert rel_err(y, want) <= RTOL
        for got, ref in zip(grads, want_grads, strict=True):
            assert rel_err(got, ref) <= RTOL
    else:
        def oracle_gemm(xg, kmat, w_res, bias, residual, n_cols, act):
            return pm.paired_matmul_blocked_plain(xg, kmat, w_res, n_cols=n_cols,
                                                  activation=act, out_dtype=torch.float32)

        seg = ops.lm_expert_segments(w.detach(), meta, block_n)
        oracle = ops._expert_grid(x.detach(), seg, "silu", per_expert, oracle_gemm)
        assert bf16_ulps(y, oracle) <= BF16_ULPS
        for got, ref in zip(grads, want_grads, strict=True):
            assert got.dtype == ref.dtype and torch.isfinite(got).all()


@pytest.mark.parametrize("block_n,window,n_sink", [(None, 0, 0), (0, 0, 0), (4, 16, 3)])
def test_fused_attn_decode_grads_on_the_card(cuda, block_n, window, n_sink):
    """``ops.fused_attn_decode`` on the card, fp32: one K2 launch forward,
    none backward; the output within 2e-5 and the gradients of q, the
    caches, w and the residual within 1e-5 relative of autograd of the plain
    composition (``fused_attn_decode_ref``)."""
    from repro_torch.core.pairing import pair_rows_structured

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, KH, D, N = 3, 77, 6, 2, 64, 100
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    w = rnd(H * D, N) * 0.03
    w64 = w.double().cpu().numpy()
    if block_n is None:
        meta, bn = None, 0
    elif block_n:
        meta, bn = {k: v[0] for k, v in _stack_blocked([pair_rows_blocked(w64, 0.05, block_n)]
                                                     ).items()}, block_n
    else:
        sp = pair_rows_structured(w64, 0.05)
        meta, bn = {"I": sp.I, "J": sp.J, "resid": sp.resid, "pair_mask": np.ones(sp.n_pairs),
                    "resid_mask": np.ones(len(sp.resid))}, 0
    if meta is not None:
        meta = {k: torch.as_tensor(v, device="cuda").to(
            torch.float32 if k.endswith("mask") else torch.int64) for k, v in meta.items()}
        assert meta["pair_mask"].sum() > 0
    live = [rnd(B, 1, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D), w, rnd(B, 1, N)]
    live = [t.requires_grad_() for t in live]
    pos = torch.tensor([0, 40, S - 1], dtype=torch.int32, device="cuda")
    kw = dict(pair_block_n=bn, window=window, n_sink=n_sink)
    q, kc, vc, tw, res = live
    y = ops.fused_attn_decode(q, kc, vc, pos, tw, meta, residual=res, **kw)
    assert da.launch_count() == 1
    dy = rnd(*y.shape)
    grads = torch.autograd.grad(y, live, dy)
    assert da.launch_count() == 1 and pm.launch_count() == 0
    want = ops.fused_attn_decode_ref(q, kc, vc, pos, tw, meta, residual=res, **kw)
    assert rel_err(y, want) <= ATTN_RTOL
    for got, ref in zip(grads, torch.autograd.grad(want, live, dy), strict=True):
        assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("arch,block_n", [("olmoe-1b-7b", 0), ("olmoe-1b-7b", 16),
                                          ("deepseek-v2-lite-16b", 0)])
def test_moe_training_step_on_the_card_matches_the_cpu(cuda, arch, block_n):
    """A training step's loss and gradients of the MoE smoke models under
    ``gemm="pallas_paired"`` at r = 0.05, fp32, on the routed branch (2 ×
    12 tokens): the card's (the experts on K1's expert grid) against the
    CPU's (its plain version) within 1e-5 (loss) and rtol 1e-4 / atol 1e-5,
    K1 launched as ``analysis.train_launches`` says."""
    from repro_torch.analysis import train_launches
    from repro_torch.core.transform import pair_lm_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    values = M.lm_value_tree(M.init_lm(cfg, 0, device="cpu"))
    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, xent_chunk=8, gemm="pallas_paired",
                        pair_block_n=block_n)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    assert tokens.size * cfg.moe.top_k > 2 * cfg.moe.n_experts  # routed

    def run(device):
        model = M.lm_params_from_numpy(_numpy_tree(values), cfg, device=device)
        mode = "column_blocked" if block_n else "structured"
        model, _ = pair_lm_params(model, 0.05, mode=mode, block_n=block_n)
        model.requires_grad_(True)
        t = torch.as_tensor(tokens, device=device)
        before = pm.launch_count()
        loss, _ = M.lm_loss(cfg, model, {"tokens": t, "labels": t}, knobs=knobs)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        return float(loss), grads, pm.launch_count() - before

    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = run(cuda), run("cpu")
    assert (n_gpu, n_cpu) == (train_launches(cfg, knobs), 0)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for name, g in g_cpu.items():
        np.testing.assert_allclose(g_gpu[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# K1's tile cache: every candidate plan, cached plans on the engine
# ---------------------------------------------------------------------------

# qwen2-1.5b's decoder GEMMs at 4 decode rows (their pairs at r=0.05), the
# fused wo/w_down residual among them, and a column-blocked bn=64 one
QWEN_DECODE = [(c[0], c[2], c[3], c[4], c[5], c[8]) for c in K1_SKINNY_CASES
               if c[0].startswith("prefill_M20_")] + [
    ("skinny_bn64_M4_res", 4, 300, 100, (24, 64, 1536), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QWEN_DECODE, ids=lambda c: c[0])
def test_every_candidate_plan_matches_the_plain_version(cuda, case, dtype):
    """Each of ``tuning.candidate_plans`` at qwen2's decode shapes launches,
    lays out the shared memory the planner models, and gives the plain
    version's result."""
    from repro_torch.kernels import tuning

    _, _, P, R, N, with_res = case
    M = 4
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    B, bn, n_cols = N if isinstance(N, tuple) else (1, N, N)
    lead = (B,) if B > 1 else ()
    x, kmat, w_res = rnd(*lead, M, 2 * P + R), rnd(*lead, P, bn), rnd(*lead, R, bn)
    res = rnd(M, n_cols) if with_res else None
    if B > 1:
        run = lambda p: pm.paired_matmul_blocked_cuda(x, kmat, w_res, n_cols=n_cols,
                                                      residual=res, plan=p)
        want = pm.paired_matmul_blocked_plain(x, kmat, w_res, n_cols=n_cols, residual=res,
                                              out_dtype=torch.float32)
    else:
        run = lambda p: pm.paired_matmul_cuda(x, kmat, w_res, residual=res, plan=p)
        want = pm.paired_matmul_plain(x, kmat, w_res, residual=res, out_dtype=torch.float32)
    cands = tuning.candidate_plans(M, P, R, B, bn, 1, x.element_size())
    assert len(cands) > 1
    for p in cands:
        _check(run(p), want, dtype)
        assert pm.kernel_smem(p, P, R, 1, x.element_size()) == p.smem
    key = pm.launch_key(x, kmat, w_res, residual=res is not None)
    assert {k for k, _ in pm.launches_by_plan()} == {key}
    assert set(p for _, p in pm.launches_by_plan()) == set(cands)


def test_cached_plans_are_launched_and_refusals_name_the_key(cuda, tmp_path):
    """The qwen2 smoke engine with a tile cache of its problems (each at its
    last candidate plan) launches the cached plans and gives the tokens of
    the engine without it; a plan the
    kernel refuses, launched under the cache that holds it, raises naming
    the key."""
    from repro_torch.kernels import tuning

    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = M.init_lm(cfg, 0, device=cuda)
    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, gemm="pallas_paired")
    prompts = {0: np.arange(5) % cfg.vocab, 1: (np.arange(9) * 7) % cfg.vocab}
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=knobs)
    want = plain.generate(prompts, 4)
    cache = tuning.TileCache(tmp_path / "tc.json")
    for key, plan in list(pm.launches_by_plan()):
        M_, P, R, B, bn, pool, item, _ = tuning.key_problem(key)
        cands = tuning.candidate_plans(M_, P, R, B, bn, tuning.POOL_WINDOWS[pool], item)
        cache.put(key, cands[-1])  # another plan than the heuristic's, where there is one
    cache.save()
    cached = ServeEngine(cfg, plain.model, max_seq=32, batch_size=2,
                         knobs=dataclasses.replace(knobs, tile_cache=str(cache.path)))
    pm.reset_launches()
    assert cached.generate(prompts, 4) == want
    for key, plan in pm.launches_by_plan():
        *launch, residual = tuning.key_problem(key)
        with tuning.use_tile_cache(cache):
            assert plan == tuning.resolve_plan(*launch, residual=residual)
    x = torch.zeros(4, 10, device=cuda)
    kmat, w_res = torch.zeros(3, 16, device=cuda), torch.zeros(4, 16, device=cuda)
    bad = dataclasses.replace(pm.launch_plan(x, kmat, w_res), cols=3)
    cache.put(pm.launch_key(x, kmat, w_res), bad)
    with tuning.use_tile_cache(cache), pytest.raises(RuntimeError, match="M4-N16-K10"):
        pm.paired_matmul_cuda(x, kmat, w_res, plan=bad)



# problems (M, P, R, n_blocks, bn, window, itemsize) the plan grid below is
# checked on: decode and prefill rows, column blocks, a pooled tall one, the
# empty contraction
CHECK_PROBLEMS = [(4, 700, 100, 1, 1536, 1, 2), (20, 300, 100, 24, 64, 1, 4),
                  (5000, 10, 5, 1, 16, 4, 4), (1024, 600, 336, 1, 256, 1, 2),
                  (64, 0, 8, 1, 32, 1, 4)]


@pytest.mark.parametrize("problem", CHECK_PROBLEMS, ids=str)
def test_host_refusal_is_the_kernels_check(cuda, problem):
    """``tuning.refusal`` (the host's copy of the C entry point's checks)
    gives the kernel's own verdict (``paired_matmul_check``, nothing
    launched) on a grid of plans, both forms, taken and refused."""
    from repro_torch.kernels import tuning

    grid = itertools.product(("skinny", "tall"), (1, 4, 16, 32, 64), (1, 4, 8, 16, 64, 256),
                             (1, 4, 8), (1, 2, 8, 9), (1, 8, 16), (1, 2), (1, 3, 5))
    taken = differ = 0
    for fields in grid:
        p = tuning.Plan(*fields, smem=0)
        host = tuning.refusal(p, *problem) is None
        differ += host != pm.kernel_accepts(p, *problem)
        taken += host
    assert differ == 0 and taken > 0
