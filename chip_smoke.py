#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Two paths run through the port (``src/repro_torch``): the paper's workload,
LeNet-5 with its three conv layers on the paired subtractor GEMM kernel (K1),
and the paired LM serving path of qwen2-1.5b, every decoder GEMM on K1 and
decode attention with the paired out-projection on the decode-attention
kernel (K2).  Phases, each printing one JSON line; any failure exits
non-zero and prints no result:

1. build      — compile both CUDA sources from ``src/repro_torch/kernels/csrc``
                (one nvcc each, in parallel): seconds, registers, spills;
2. kernel     — K1 against its plain PyTorch version on the card, in every
                form (dense, structured, blocked at bn=1 and bn=4 with a
                short last block, max2/avg2 pooling, fp32/bf16 residuals, all
                activations, ragged edges, the empty contraction P + R = 0):
                fp32 ≤ 1e-5 relative to the largest output, bf16 ≤ 2 output
                ulps of the fp32 oracle;
3. decode_attention — K2 against its plain version, bare and fused, fp32
                and bf16: G ∈ {1, 6}, D ∈ {64, 128}, S not a multiple of the
                32-key tile, slots at 0 / mid-cache / S−1, windows with and
                without sinks, structured / blocked bn=1 / bn=64 (short last
                block) / unpaired out-projections, residual present and
                absent: fp32 ≤ 2e-5 relative, bf16 ≤ 2 output ulps (the
                fused form against the plain projection of the bare
                kernel's bf16 rows: see fused_decode_attention_plain);
4. layers     — K1 at LeNet's shapes (1000 images, every layer and pairing
                mode) against its plain version, timed beside the plain
                version, ``F.conv2d`` on the folded weights and its
                memory/operation bound;
5. serve      — LeNet's main path: seeded weights, the synthetic MNIST test
                split, pairings at r ∈ {0, 0.05} × {structured,
                column_blocked bn=4, per_column}, four requests of 1000 images
                with the pool fused and unfused: r=0 logits match
                ``F.conv2d`` ≤ 1e-5 with identical argmax; r=0.05 logits match
                the folded-weight conv; exactly 3 kernel launches per forward;
6. lm_parity  — qwen2-1.5b at full width, 2 layers, fp32: the plain engine
                against the paired (column-blocked bn=64, r=0) engine with
                fused decode attention, batch 2, prompts of 5 and 11 tokens,
                6 tokens per slot: identical tokens, logits ≤ 1e-5; 5 kernel
                launches per decode layer (one fused QKV K1, one K2, three
                MLP K1), counted by the wrappers and by ``torch.profiler``;
7. lm_serve   — qwen2-1.5b at full width and depth (28 layers), bf16,
                structured pairing at r=0.05, through the launcher's
                ``serve``: batch 4, prompts of 8/12/16/20 tokens, max_seq
                256, 32 tokens per slot; pairing seconds, prefill ms per
                request, decode ms per step, tokens/s, 7 launches per decode
                layer (3 QKV K1, one K2, 3 MLP K1), a ``torch.profiler`` split
                of one decode step, and K1 and K2 timed at the serving shapes
                beside their plain versions, library calls and bounds;
8. the kernels table, the card's name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FMA-unit FLOP/s and
# dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
FP32_RTOL = 1e-5
ATTN_RTOL = 2e-5  # the JAX decode-attention tests' tolerance
BF16_MAX_ULPS = 2.0
REQUESTS, REQUEST_IMAGES = 4, 1000
MODES = (("structured", 0), ("column_blocked", 4), ("per_column", 1))
ROUNDINGS = (0.0, 0.05)
HEADLINE = ("per_column", 0.05)  # the paper's own pairing at its headline rounding

failures: list[str] = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (no host overhead)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def request_stats(fn, n: int = 40, warmup: int = 3) -> dict:
    """Per-call wall times on the card's clock: median, p75 (the highest
    percentile with at least ten samples above it) and max, over ``n``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return {"median": times[n // 2], "p75": times[(3 * n) // 4 - 1], "max": times[-1], "n": n}


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paired_matmul as pm

    t0 = time.perf_counter()
    infos = _build.build_all()  # one nvcc per source, in parallel
    pm._kernel()  # load the libraries and bind their entry points
    da._kernel()
    sources = {}
    for name, info in infos.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", info["log"])]
        sources[name] = {
            "seconds": info["seconds"], "built": info["built"],
            "kernels_compiled": len(regs), "max_registers": max(regs, default=None),
            "spill_bytes": sum(spills),
        }
    out = {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc": _build.nvcc_version(),
        "sources": sources,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version, every form
# ---------------------------------------------------------------------------


def phase_kernel() -> dict:
    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    cases = []
    # (name, blocked, M, P, R, N or (B, bn, n_cols), pool, act, dtype, residual dtype)
    f32, bf = torch.float32, torch.bfloat16
    for dt in (f32, bf):
        cases += [
            ("dense_P0", False, 1000, 0, 150, 16, "none", "relu", dt, None),
            ("structured", False, 777, 37, 76, 120, "none", "none", dt, None),
            ("R0", False, 129, 64, 0, 33, "none", "relu", dt, None),
            ("pool_max2", False, 515, 9, 7, 6, "max2", "relu", dt, None),
            ("pool_avg2", False, 300, 20, 110, 16, "avg2", "tanh", dt, None),
            ("residual_f32", False, 257, 12, 30, 40, "none", "gelu", dt, f32),
            ("residual_bf16", False, 257, 12, 30, 40, "max2", "silu", dt, bf),
            ("ragged_M1", False, 1, 3, 2, 7, "none", "none", dt, None),
            ("empty_PR0", False, 300, 0, 0, 16, "max2", "gelu", dt, f32),
            ("blocked_bn1", True, 501, 11, 3, (6, 1, 6), "max2", "relu", dt, None),
            ("blocked_bn4_short", True, 333, 20, 110, (4, 4, 14), "none", "relu", dt, f32),
            ("blocked_bn4_avg2", True, 200, 5, 15, (4, 4, 13), "avg2", "none", dt, None),
            ("blocked_empty", True, 100, 0, 0, (3, 4, 10), "none", "silu", dt, None),
        ]
    for act in ("none", "relu", "gelu", "silu", "tanh"):
        # inputs scaled by 0.1 below: pre-activations of order one, where
        # the saturating activations are not flat
        cases.append((f"act_{act}", False, 640, 30, 65, 24, "none", act, f32, None))

    results, max_abs, max_rel, max_ulps = [], 0.0, 0.0, 0.0
    for name, blocked, M, P, R, N, pool, act, dt, res_dt in cases:
        W = (4,) if pool != "none" else ()
        if blocked:
            B, bn, n_cols = N
            x = rnd(B, *W, M, 2 * P + R, dtype=dt)
            kmat, w_res = rnd(B, P, bn, dtype=dt), rnd(B, R, bn, dtype=dt)
            kmat[-1, :, n_cols - (B - 1) * bn:] = 0  # the short block's padded columns
            w_res[-1, :, n_cols - (B - 1) * bn:] = 0
        else:
            n_cols = N
            x = rnd(*W, M, 2 * P + R, dtype=dt)
            if name.startswith("act_"):
                x = x * 0.1
            kmat, w_res = rnd(P, N, dtype=dt), rnd(R, N, dtype=dt)
        bias = rnd(n_cols)
        residual = None if res_dt is None else rnd(M, n_cols, dtype=res_dt)
        kw = dict(residual=residual, activation=act, pool=pool)
        if blocked:
            got = pm.paired_matmul_blocked_cuda(x, kmat, w_res, bias, n_cols=n_cols, **kw)
            want = pm.paired_matmul_blocked_plain(
                x, kmat, w_res, bias, n_cols=n_cols, out_dtype=torch.float32, **kw
            )
        elif name.startswith("dense"):
            got = pm.dense_matmul_cuda(x, w_res, bias, residual=residual, activation=act)
            want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
        else:
            got = pm.paired_matmul_cuda(x, kmat, w_res, bias, **kw)
            want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        row = {"case": name, "dtype": str(dt).removeprefix("torch."), "shape": list(got.shape)}
        if dt == f32:
            row["rel_err"] = rel_err(got, want)
            row["max_abs_err"] = float((got - want).abs().max())
            max_abs = max(max_abs, row["max_abs_err"])
            max_rel = max(max_rel, row["rel_err"])
            check(row["rel_err"] <= FP32_RTOL, f"kernel {name} fp32 rel err {row['rel_err']:.3g}")
        else:
            row["ulps"] = bf16_ulps(got, want)
            max_ulps = max(max_ulps, row["ulps"])
            check(row["ulps"] <= BF16_MAX_ULPS, f"kernel {name} bf16 {row['ulps']:.3g} ulps")
        check(bool(torch.isfinite(got).all()), f"kernel {name} non-finite output")
        results.append(row)
    out = {
        "phase": "kernel",
        "cases": len(results),
        "fp32_max_rel_err": max_rel,
        "fp32_max_abs_err": max_abs,
        "bf16_max_ulps": max_ulps,
        "tolerance": {"fp32_rel": FP32_RTOL, "bf16_ulps": BF16_MAX_ULPS},
        "results": results,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 3: K2 against its plain version
# ---------------------------------------------------------------------------


def _outproj_segments(w2, rounding: float, block_n):
    """The decode kernel's out-projection segments of ``w2`` (K, N): paired
    per ``block_n`` columns (0 → structured), or unpaired (None)."""
    import torch

    from repro_torch.core.pairing import pair_rows_blocked, pair_rows_structured
    from repro_torch.core.transform import _stack_blocked, _stack_structured
    from repro_torch.kernels import ops

    if block_n is None:
        return ops.attn_outproj_segments(w2, None)
    w64 = w2.double().cpu().numpy()
    if block_n:
        stacked = _stack_blocked([pair_rows_blocked(w64, rounding, block_n)])
    else:
        stacked = _stack_structured([pair_rows_structured(w64, rounding)])
    meta = {k: torch.as_tensor(v[0], device=w2.device) for k, v in stacked.items()}
    meta.update({k: meta[k].long() for k in ("I", "J", "resid")})
    return ops.attn_outproj_segments(w2, meta, block_n)


def phase_decode_attention() -> dict:
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    B, KH = 4, 2
    # (name, G, D, S, window, n_sink, out-projection block_n (0 structured,
    #  None unpaired), N, residual)
    cases = [
        ("qwen_heads_structured", 6, 128, 300, 0, 0, 0, 1536, True),
        ("mha_bn64_short_block", 1, 64, 77, 0, 0, 64, 1000, False),
        ("window_bn1", 6, 64, 77, 16, 0, 1, 200, True),
        ("window_sink_unpaired", 1, 128, 300, 40, 4, None, 700, True),
        ("window_sink_structured", 6, 128, 77, 16, 3, 0, 320, False),
    ]
    results, max_abs, max_rel, max_ulps = [], 0.0, 0.0, 0.0
    for name, G, D, S, window, n_sink, block_n, N, has_res in cases:
        H = G * KH
        # weights of std 0.1 against r=0.3: 94-99% of lanes pair in every mode
        seg = _outproj_segments(rnd(H * D, N) * 0.1, 0.3, block_n)
        q, kc, vc, res = rnd(B, 1, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D), rnd(B, N)
        pos = torch.tensor([0, S // 2, S - 1, 5], dtype=torch.int32, device="cuda")
        kw = dict(window=window, n_sink=n_sink)
        for dt in (torch.float32, torch.bfloat16):
            q_, kc_, vc_ = q.to(dt), kc.to(dt), vc.to(dt)
            proj = (seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dt), seg.w_res.to(dt),
                    res.to(dt) if has_res else None)
            bare = da.decode_attention_cuda(q_, kc_, vc_, pos, **kw)
            fused = da.fused_decode_attention_cuda(q_, kc_, vc_, pos, *proj, n_cols=N, **kw)
            f32 = dict(out_dtype=torch.float32)
            forms = {
                "bare": (bare, da.decode_attention_plain(q_, kc_, vc_, pos, **kw, **f32)),
                # bf16: the projection of the kernel's own rounded rows (see
                # fused_decode_attention_plain); fp32: the whole plain version
                "fused": (fused, da.outproj_plain(bare, *proj, n_cols=N, **f32)
                          if dt == torch.bfloat16 else
                          da.fused_decode_attention_plain(q_, kc_, vc_, pos, *proj, n_cols=N,
                                                          **kw, **f32)),
            }
            torch.cuda.synchronize()
            for form, (got, want) in forms.items():
                row = {"case": name, "form": form, "dtype": str(dt).removeprefix("torch."),
                       "shape": list(got.shape)}
                label = f"decode_attention {name} {form} {row['dtype']}"
                if dt == torch.float32:
                    row["rel_err"] = rel_err(got, want)
                    row["max_abs_err"] = float((got - want).abs().max())
                    max_abs, max_rel = max(max_abs, row["max_abs_err"]), max(max_rel, row["rel_err"])
                    check(row["rel_err"] <= ATTN_RTOL, f"{label} rel err {row['rel_err']:.3g}")
                else:
                    row["ulps"] = bf16_ulps(got, want)
                    max_ulps = max(max_ulps, row["ulps"])
                    check(row["ulps"] <= BF16_MAX_ULPS, f"{label} {row['ulps']:.3g} ulps")
                check(bool(torch.isfinite(got).all()), f"{label} non-finite output")
                results.append(row)
    out = {
        "phase": "decode_attention", "cases": len(results),
        "fp32_max_rel_err": max_rel, "fp32_max_abs_err": max_abs, "bf16_max_ulps": max_ulps,
        "tolerance": {"fp32_rel": ATTN_RTOL, "bf16_ulps": BF16_MAX_ULPS},
        "results": results,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# main-path set-up
# ---------------------------------------------------------------------------


def setup():
    import torch

    from repro_torch.core.transform import build_conv_pairings
    from repro_torch.data.mnist import load_mnist, pad_to_32
    from repro_torch.kernels.paired_conv import folded_conv_weight
    from repro_torch.models.lenet import LENET_CONV_POSITIONS, init_lenet

    t0 = time.perf_counter()
    params = init_lenet(0)  # the entry points default to the card
    images, labels, source = load_mnist("test", synthetic_n=REQUESTS * REQUEST_IMAGES, seed=0)
    images = pad_to_32(images)[: REQUESTS * REQUEST_IMAGES]
    labels = labels[: REQUESTS * REQUEST_IMAGES]
    t_data = time.perf_counter() - t0
    pairings, folded = {}, {}
    t0 = time.perf_counter()
    for r in ROUNDINGS:
        for mode, bn in MODES:
            pr = build_conv_pairings(
                params, r, mode=mode, block_n=bn, positions=LENET_CONV_POSITIONS
            )
            pairings[mode, r] = pr
            folded[mode, r] = {
                k: {"w": folded_conv_weight(v["w"], pr[k]) if k in pr else v["w"], "b": v["b"]}
                for k, v in params.items()
            }
    t_pair = time.perf_counter() - t0
    requests = [
        torch.as_tensor(images[i * REQUEST_IMAGES : (i + 1) * REQUEST_IMAGES],
                        dtype=torch.float32, device="cuda")
        for i in range(REQUESTS)
    ]
    return {
        "params": params, "images": images, "labels": labels, "source": source,
        "pairings": pairings, "folded": folded, "requests": requests,
        "seconds": {"data": t_data, "pairing": t_pair},
    }


# ---------------------------------------------------------------------------
# phase 4: K1 at LeNet's shapes
# ---------------------------------------------------------------------------


def _layer_inputs(params, x):
    """Inputs of conv1..conv3 for a request, from the F.conv2d path."""
    import torch.nn.functional as F

    from repro_torch.kernels.paired_conv import pool2_reference
    from repro_torch.models.lenet import _torch_conv

    def conv_pool(name, x):
        w, b = params[name]["w"], params[name]["b"]
        return pool2_reference(F.relu(_torch_conv(x, w, b)), "max2")

    x2 = conv_pool("conv1", x)
    return {"conv1": x, "conv2": x2, "conv3": conv_pool("conv2", x2)}


def _live_blocks(pairing) -> list[tuple[int, int, int]]:
    """(pairs, residual lanes, columns) of each column block of a pairing,
    without the lanes that pad blocks to a common split."""
    from repro_torch.core.pairing import BlockedPairing

    blocks = pairing.blocks if isinstance(pairing, BlockedPairing) else [pairing]
    return [(sp.n_pairs, len(sp.resid), sp.shape[1]) for sp in blocks]


def _bound(pairing, rows: int, k: int, n_out: int, n_cols: int, itemsize: int):
    """Least bytes and operations of one launch over ``rows`` GEMM rows.

    Bytes: the ``rows × k`` im2col operand read once (not the B-fold,
    lane-padded copy the blocked forms build), the live weights, the fp32
    bias and the ``n_out`` outputs written once.  Operations: one subtract
    per pair and one multiply-add (2 FLOP) per live lane and column.
    """
    blocks = _live_blocks(pairing)
    weights = sum((p + r) * c for p, r, c in blocks)
    nbytes = (rows * k + weights + n_out) * itemsize + n_cols * 4
    flops = sum(rows * (2 * c * (p + r) + p) for p, r, c in blocks)
    return nbytes, flops


def _measure_layer(x, w, b, w_folded, layer, pool) -> dict:
    """One conv layer at the main path's shapes: the kernel against its plain
    version on the operands ``paired_conv`` builds, their device times, the
    im2col + gather time, ``F.conv2d`` on the folded weights, and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.pairing import BlockedPairing
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.paired_conv import conv_gemm_operands
    from repro_torch.kernels.ref import rel_err

    xg, kmat, w_res, out_shape = conv_gemm_operands(x, w, layer, pool=pool)
    xg = xg.contiguous()
    kw = dict(activation="relu", pool=pool)
    if isinstance(layer.pairing, BlockedPairing):
        kw["n_cols"] = out_shape[-1]
        kern, plain = pm.paired_matmul_blocked_cuda, pm.paired_matmul_blocked_plain
    else:
        kern, plain = pm.paired_matmul_cuda, pm.paired_matmul_plain
    got, want = kern(xg, kmat, w_res, b, **kw), plain(xg, kmat, w_res, b, **kw)
    torch.cuda.synchronize()
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w_folded.permute(3, 2, 0, 1).contiguous()
    rows = xg.shape[-2] * (4 if pool != "none" else 1)
    k = w.shape[0] * w.shape[1] * w.shape[2]  # im2col lanes (kh, kw, cin)
    nbytes, flops = _bound(layer.pairing, rows, k, got.numel(), got.shape[-1],
                           xg.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    ms = graph_ms(lambda: kern(xg, kmat, w_res, b, **kw))
    plain_ms = graph_ms(lambda: plain(xg, kmat, w_res, b, **kw))
    return {
        "x_shape": list(xg.shape), "out_shape": list(got.shape),
        "rel_err": rel_err(got, want), "max_abs_err": float((got - want).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "kernel_over_plain": ms / plain_ms,
        "library_ms": graph_ms(lambda: F.conv2d(x_nchw, w_oihw, b)),
        "operands_ms": request_stats(
            lambda: conv_gemm_operands(x, w, layer, pool=pool))["median"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def phase_layers(ctx) -> dict:
    params = ctx["params"]
    inputs = _layer_inputs(params, ctx["requests"][0])
    rows_out = []
    for mode, _ in MODES:
        r = 0.05
        pr, folded = ctx["pairings"][mode, r], ctx["folded"][mode, r]
        for fused in (True, False):
            for name in ("conv1", "conv2", "conv3"):
                pool = "max2" if fused and name != "conv3" else "none"
                row = {"mode": mode, "rounding": r, "fused_pool": fused, "layer": name}
                row.update(_measure_layer(
                    inputs[name], params[name]["w"], params[name]["b"],
                    folded[name]["w"], pr[name], pool,
                ))
                check(row["rel_err"] <= FP32_RTOL,
                      f"layer {mode} {name} pool={pool} rel err {row['rel_err']:.3g}")
                rows_out.append(row)
    max_abs = max(row["max_abs_err"] for row in rows_out)
    # not a gate: the kernel is simple and right first, fast later (PERF.md)
    slower = [f"{row['mode']} {row['layer']} fused={row['fused_pool']}"
              for row in rows_out if row["kernel_over_plain"] > 1]
    out = {"phase": "layers", "images": REQUEST_IMAGES, "max_abs_err": max_abs,
           "kernel_slower_than_plain": slower, "rows": rows_out}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5: serving LeNet — the first main path
# ---------------------------------------------------------------------------


def phase_serve(ctx) -> dict:
    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import rel_err
    from repro_torch.models.lenet import lenet_accuracy, lenet_apply

    params, requests = ctx["params"], ctx["requests"]
    labels = torch.as_tensor(ctx["labels"], device="cuda")
    with torch.no_grad():
        ref = [lenet_apply(params, x) for x in requests]
        folded_ref = {
            key: [lenet_apply(fp, x) for x in requests] for key, fp in ctx["folded"].items()
        }
    configs = [(mode, r, fused) for r in ROUNDINGS for mode, _ in MODES for fused in (True, False)]

    pm.reset_launches()  # counts from here on are the main path's
    served = []
    with torch.no_grad():
        for mode, r, fused in configs:
            pr = ctx["pairings"][mode, r]
            hits, errs, argmax_same, per_forward = 0, [], True, set()
            for i, x in enumerate(requests):
                before = pm.launch_count()
                logits = lenet_apply(params, x, conv_impl="paired", paired=pr, fuse_pool=fused)
                per_forward.add(pm.launch_count() - before)
                want = ref[i] if r == 0 else folded_ref[mode, r][i]
                errs.append(rel_err(logits, want))
                argmax_same &= bool((logits.argmax(-1) == want.argmax(-1)).all())
                batch_labels = labels[i * REQUEST_IMAGES : (i + 1) * REQUEST_IMAGES]
                hits += int((logits.argmax(-1) == batch_labels).sum())
                check(bool(torch.isfinite(logits).all()) and logits.shape == (REQUEST_IMAGES, 10),
                      f"serve {mode} r={r} fused={fused}: bad logits")
            served.append({
                "mode": mode, "rounding": r, "fused_pool": fused,
                "accuracy": hits / (REQUESTS * REQUEST_IMAGES),
                "rel_err_vs": "F.conv2d" if r == 0 else "F.conv2d on folded weights",
                "max_rel_err": max(errs), "argmax_identical": argmax_same,
                "launches_per_forward": sorted(per_forward),
            })
            check(max(errs) <= FP32_RTOL,
                  f"serve {mode} r={r} fused={fused} rel err {max(errs):.3g}")
            check(per_forward == {3}, f"serve {mode} r={r} fused={fused} launches {per_forward}")
            if r == 0:
                check(argmax_same, f"serve {mode} r=0 fused={fused}: argmax differs from F.conv2d")
    # the accuracy entry point, over the same requests
    pr = ctx["pairings"]["structured", 0.0]
    acc = lenet_accuracy(params, ctx["images"], ctx["labels"], batch=REQUEST_IMAGES,
                         conv_impl="paired", paired=pr, fuse_pool=True)
    launches = dict(pm.LAUNCHES)
    total = pm.launch_count()
    check(total == (len(configs) + 1) * REQUESTS * 3,
          f"main path launched the kernel {total} times")
    acc_served = next(s["accuracy"] for s in served if s["mode"] == "structured"
                      and s["rounding"] == 0 and s["fused_pool"])
    check(acc == acc_served, f"lenet_accuracy {acc} != served accuracy {acc_served}")

    # ms per request of 1000 images, one request at a time (closed loop,
    # host overhead included), after warm-up
    x = requests[0]
    with torch.no_grad():
        request_ms = {
            "torch_conv2d": request_stats(lambda: lenet_apply(params, x)),
            "im2col": request_stats(lambda: lenet_apply(params, x, conv_impl="im2col")),
        }
        for mode, r, fused in configs:
            if r != 0.05:
                continue
            pr = ctx["pairings"][mode, r]
            request_ms[f"paired_{mode}_{'fused' if fused else 'unfused'}"] = request_stats(
                lambda pr=pr, fused=fused: lenet_apply(
                    params, x, conv_impl="paired", paired=pr, fuse_pool=fused)
            )

    ledger = []
    for (mode, r), pr in ctx["pairings"].items():
        counts = [layer.measured_op_counts() for layer in pr.values()]
        ledger.append({
            "mode": mode, "rounding": r,
            "baseline_lanes": sum(c["baseline_lanes"] for c in counts),
            "lanes_saved": sum(c["lanes_saved"] for c in counts),
            "subs_executed": sum(c["subs_executed"] for c in counts),
        })
        check(ledger[-1]["baseline_lanes"] == 405600, f"ledger baseline {ledger[-1]}")
    out = {
        "phase": "serve", "source": ctx["source"], "requests": REQUESTS,
        "images_per_request": REQUEST_IMAGES, "set_up_seconds": ctx["seconds"],
        "main_path_launches": total, "launches_by_form": launches,
        "accuracy_entry_point": acc, "served": served, "ms_per_request": request_ms,
        "table1_ledger": ledger,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: the LM serving path
# ---------------------------------------------------------------------------

K1_KERNEL, K2_KERNEL = "paired_matmul_kernel", "decode_attention_kernel"


def _reset_launches() -> None:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paired_matmul as pm

    pm.reset_launches()
    da.reset_launches()


def profile_step(eng) -> dict:
    """One decode step of ``eng`` under ``torch.profiler``: device ms and
    launches of K1, K2 and every other kernel, and the step's wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {k: {"ms": 0.0, "launches": 0} for k in ("K1", "K2", "other")}
    for ev in prof.key_averages():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        key = "K1" if K1_KERNEL in ev.key else "K2" if K2_KERNEL in ev.key else "other"
        split[key]["ms"] += us / 1e3
        split[key]["launches"] += ev.count
    device_ms = sum(v["ms"] for v in split.values())
    return {"wall_ms": wall, "device_ms": device_ms if device_ms else "not measured",
            "idle_share": 1 - device_ms / wall if device_ms else "not measured", **split}


def phase_lm_parity() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2, dtype="float32")
    model = M.init_lm(cfg, 0)
    base = dict(q_chunk=32, k_chunk=32)
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**base))
    fused = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused", pair_block_n=64))
    pairing_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg.vocab, size=5), 1: rng.integers(0, cfg.vocab, size=11)}
    errs = []
    for prompt in prompts.values():
        tokens = torch.as_tensor(prompt[None], device="cuda")
        want = M.prefill(cfg, plain.model, tokens, knobs=plain.knobs)[0]
        errs.append(rel_err(M.prefill(cfg, fused.model, tokens, knobs=fused.knobs)[0], want))

    _reset_launches()  # the path's own counts from here
    toks = {name: {s: [eng.add_request(s, p)] for s, p in prompts.items()}
            for name, eng in (("plain", plain), ("fused", fused))}
    before = kernel_launches()
    for _ in range(5):
        for name, eng in (("plain", plain), ("fused", fused)):
            nxt = eng.step()
            for s in prompts:
                toks[name][s].append(int(nxt[s]))
        errs.append(rel_err(fused.last_logits, plain.last_logits))
    decode = {k: v - before[k] for k, v in kernel_launches().items()}
    launches = kernel_launches()
    per_layer = {k: v / (5 * cfg.n_layers) for k, v in decode.items()}
    prof = profile_step(fused)
    prof_per_layer = {k: prof[k]["launches"] / cfg.n_layers for k in ("K1", "K2")}
    check(toks["fused"] == toks["plain"], f"lm_parity tokens differ: {toks}")
    check(max(errs) <= FP32_RTOL, f"lm_parity logits rel err {max(errs):.3g}")
    check(per_layer == {"paired_matmul": 4, "decode_attention": 1},
          f"lm_parity launches per decode layer {per_layer}")
    check(prof_per_layer == {"K1": 4, "K2": 1} or prof["device_ms"] == "not measured",
          f"lm_parity profiler launches per decode layer {prof_per_layer}")
    out = {
        "phase": "lm_parity", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "pairing": "column_blocked bn=64, r=0", "pairing_s": pairing_s,
        "tokens": toks["fused"], "tokens_identical": toks["fused"] == toks["plain"],
        "max_logit_rel_err": max(errs), "main_path_launches": launches,
        "decode_launches_per_layer": per_layer, "profiled_step": prof,
        "profiled_launches_per_layer": prof_per_layer,
    }
    emit(out)
    return out


def _k1_at(block, name, x, residual=None) -> dict:
    """K1 on one decoder weight of the serving engine (its real segments),
    for activations ``x`` (M, K): device ms beside the plain version,
    ``torch.matmul`` on the folded weight, and the bound."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import bf16_ulps

    dt = x.dtype
    w = block.matrix(name, dt)
    meta = block.pairing[name]
    seg = ops.lm_paired_segments(w, meta)
    xg = x[:, seg.perm].contiguous()
    kmat, w_res = seg.kmat.contiguous(), seg.w_res.contiguous()
    folded = ops.fold_lm_weight(w, meta)
    got = pm.paired_matmul_cuda(xg, kmat, w_res, residual=residual)
    want = pm.paired_matmul_plain(xg, kmat, w_res, residual=residual, out_dtype=torch.float32)
    M, K = x.shape
    P, N = kmat.shape
    R = w_res.shape[0]
    p_live, r_live = int(meta["pair_mask"].sum()), int(meta["resid_mask"].sum())
    item = x.element_size()
    nbytes = (M * K + (p_live + r_live) * N + M * N * (2 if residual is not None else 1)) * item
    flops = M * (2 * N * (p_live + r_live) + p_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    lib = (lambda: torch.matmul(x, folded) + residual) if residual is not None else (
        lambda: torch.matmul(x, folded))
    ms = graph_ms(lambda: pm.paired_matmul_cuda(xg, kmat, w_res, residual=residual))
    plain_ms = graph_ms(lambda: pm.paired_matmul_plain(xg, kmat, w_res, residual=residual))
    return {
        "weight": name, "M": M, "K": K, "N": N, "P": P, "R": R, "pairs_live": p_live,
        "ulps": bf16_ulps(got, want), "ms": ms, "plain_ms": plain_ms,
        "library_ms": graph_ms(lib), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "kernel_over_bound": ms / max(t_bytes, t_ops),
    }


def _k2_at(eng) -> dict:
    """K2 at the serving shapes: layer 0's cache and out-projection segments
    of the engine, the slots at their positions; device ms beside the plain
    version, the library pair of calls, and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bf16_ulps

    cfg, attn = eng.cfg, eng.model.layers[0].attn
    dt = eng.cache["k"].dtype
    B, H, D, KH = eng.batch_size, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    w = attn.matrix("wo", dt)
    meta = attn.pairing["wo"]
    seg = ops.attn_outproj_segments(w, meta)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dt)
    res = torch.randn(B, cfg.d_model, generator=gen, device="cuda").to(dt)
    kc, vc = eng.cache["k"][0], eng.cache["v"][0]
    pos = torch.as_tensor(eng.pos, device="cuda")
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat, seg.w_res, res)
    got = da.fused_decode_attention_cuda(*args, n_cols=seg.n_cols)
    want = da.outproj_plain(da.decode_attention_cuda(q, kc, vc, pos), *args[4:],
                            n_cols=seg.n_cols, out_dtype=torch.float32)
    folded = ops.fold_lm_weight(w, meta)
    mask = (torch.arange(kc.shape[1], device="cuda")[None, :] <= pos[:, None].long())

    def library():  # two calls: no single PyTorch call computes K2
        o = F.scaled_dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                           vc.transpose(1, 2), attn_mask=mask[:, None, None],
                                           enable_gqa=True)
        return torch.matmul(o.reshape(B, H * D), folded) + res

    live_keys = int((pos.long() + 1).clamp(max=kc.shape[1]).sum())
    p_live, r_live = int(meta["pair_mask"].sum()), int(meta["resid_mask"].sum())
    N, item = seg.n_cols, q.element_size()
    nbytes = (q.numel() + 2 * live_keys * KH * D + (p_live + r_live) * N + 2 * B * N) * item \
        + (2 * p_live + r_live) * 4
    flops = 4 * live_keys * H * D + B * (2 * N * (p_live + r_live) + p_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    ms = graph_ms(lambda: da.fused_decode_attention_cuda(*args, n_cols=seg.n_cols))
    return {
        "B": B, "H": H, "KH": KH, "D": D, "S": kc.shape[1], "pos": eng.pos.tolist(),
        "N": N, "pairs_live": p_live, "resid_live": r_live, "ulps": bf16_ulps(got, want),
        "ms": ms,
        "plain_ms": graph_ms(lambda: da.fused_decode_attention_plain(*args, n_cols=seg.n_cols)),
        "library_ms": graph_ms(library),
        "library_calls": "F.scaled_dot_product_attention(enable_gqa=True) + "
                         "torch.matmul(folded wo) + residual add",
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "kernel_over_bound": ms / max(t_bytes, t_ops), "bytes": nbytes, "flops": flops,
    }


def phase_lm_serve() -> dict:
    import numpy as np
    import torch

    from repro_torch.launch.serve import kernel_launches, serve

    steps, batch = 32, 4
    _reset_launches()  # the path's own counts from here
    rec = serve(arch="qwen2-1.5b", batch=batch, max_seq=256, steps=steps,
                pair_rounding=0.05, gemm="pallas_paired", attn="pallas_fused")
    launches = kernel_launches()
    eng = rec["engine"]
    cfg, L = eng.cfg, eng.cfg.n_layers
    dec = rec["launches"]["decode"]
    per_layer = {k: v / ((steps - 1) * L) for k, v in dec.items()}
    toks = rec["outputs"]
    check(per_layer == {"paired_matmul": 6, "decode_attention": 1},
          f"lm_serve launches per decode layer {per_layer}")
    check(all(len(t) == steps and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
          "lm_serve: tokens out of range")
    check(bool(np.isfinite(eng.last_logits).all())
          and eng.last_logits.shape == (batch, cfg.vocab), "lm_serve: bad logits")
    prof = profile_step(eng)
    prof_per_layer = {k: prof[k]["launches"] / L for k in ("K1", "K2")}
    check(prof_per_layer == {"K1": 6, "K2": 1} or prof["device_ms"] == "not measured",
          f"lm_serve profiler launches per decode layer {prof_per_layer}")
    layer0 = eng.model.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = lambda k: torch.randn(batch, k, generator=gen, device="cuda").to(torch.bfloat16)
    d, f = cfg.d_model, cfg.d_ff
    k1 = [_k1_at(layer0.attn, "wq", x(d)), _k1_at(layer0.attn, "wk", x(d)),
          _k1_at(layer0.mlp, "w_gate", x(d)), _k1_at(layer0.mlp, "w_down", x(f), x(d))]
    k2 = _k2_at(eng)
    for row in k1:
        check(row["ulps"] <= BF16_MAX_ULPS, f"lm_serve K1 {row['weight']} {row['ulps']:.3g} ulps")
    check(k2["ulps"] <= BF16_MAX_ULPS, f"lm_serve K2 {k2['ulps']:.3g} ulps")
    step_ms = sorted(rec["step_ms"])
    rp = eng.pair_report
    out = {
        "phase": "lm_serve", "arch": cfg.name, "layers": L, "dtype": cfg.dtype,
        "batch": batch, "max_seq": 256, "tokens_per_slot": steps,
        "pairing": {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
                    "pair_fraction": rp.pair_fraction, "seconds": rec["pairing_s"]},
        "prefill_ms": rec["prefill_ms"],
        "decode_ms": {"median": step_ms[len(step_ms) // 2],
                      "p90": step_ms[int(0.9 * (len(step_ms) - 1))], "n": len(step_ms)},
        "tokens_per_s": rec["tokens_per_s"], "seconds": rec["seconds"],
        "main_path_launches": launches, "prefill_launches": rec["launches"]["prefill"],
        "decode_launches_per_layer": per_layer, "profiled_step": prof,
        "profiled_launches_per_layer": prof_per_layer, "k1_decode_shapes": k1, "k2": k2,
        "tokens": {s: t[:8] for s, t in toks.items()},
    }
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build = phase_build()
    kernel = phase_kernel()
    attn = phase_decode_attention()
    ctx = setup()
    layers = phase_layers(ctx)
    lenet = phase_serve(ctx)
    parity = phase_lm_parity()
    lm = phase_lm_serve()

    head = [row for row in layers["rows"]
            if (row["mode"], row["rounding"]) == HEADLINE and row["fused_pool"]]
    paths = {"lenet_serve": lenet["main_path_launches"],
             "lm_parity": parity["main_path_launches"]["paired_matmul"],
             "lm_serve": lm["main_path_launches"]["paired_matmul"]}
    k2_paths = {"lm_parity": parity["main_path_launches"]["decode_attention"],
                "lm_serve": lm["main_path_launches"]["decode_attention"]}
    k2 = lm["k2"]
    emit({"kernels": [{
        "name": "paired_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paired_matmul.cu",
        "replaces": "src/repro/kernels/paired_matmul.py:158",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": max(kernel["fp32_max_abs_err"], layers["max_abs_err"]),
        # one fused LeNet forward of 1000 images, per_column pairing at
        # r=0.05: the sum over its three launches
        "ms": sum(row["ms"] for row in head),
        "plain_ms": sum(row["plain_ms"] for row in head),
        "kernel_over_plain": sum(r["ms"] for r in head) / sum(r["plain_ms"] for r in head),
        "bound_ms": sum(row["bound_ms"] for row in head),
        "bound_by": "bytes" if sum(r["bytes"] / HBM_BYTES_PER_S for r in head)
        >= sum(r["flops"] / FP32_FLOP_PER_S for r in head) else "operations",
        "library_ms": sum(row["library_ms"] for row in head),
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": attn["fp32_max_abs_err"],
        # one fused launch at the serving shapes: qwen2-1.5b layer 0, bf16,
        # batch 4, structured out-projection at r=0.05
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "kernel_over_plain": k2["ms"] / k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library_calls": k2["library_calls"],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(build {build['seconds']:.1f} s)", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
