#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

The main path is the paper's workload: LeNet-5 with its three conv layers
run through the paired subtractor GEMM kernel (``src/repro_torch``).  Phases,
each printing one JSON line; any failure exits non-zero and prints no result:

1. build   — compile the CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. kernel  — the kernel against its plain PyTorch version on the card, in
             every form (dense, structured, blocked at bn=1 and bn=4 with a
             short last block, max2/avg2 pooling, fp32/bf16 residuals, all
             activations, ragged edges, the empty contraction P + R = 0):
             fp32 ≤ 1e-5 relative to the largest output, bf16 ≤ 2 output
             ulps of the fp32 oracle;
3. layers  — the kernel at the main path's own shapes (1000 images, every
             layer and pairing mode) against its plain version, timed beside
             the plain version, ``F.conv2d`` on the folded weights and its
             memory/operation bound (the distinct im2col operand, live
             weights and output; not the blocked forms' replicated copy);
4. serve   — seeded LeNet, the synthetic MNIST test split, pairings at
             r ∈ {0, 0.05} × {structured, column_blocked bn=4, per_column},
             four requests of 1000 images through ``lenet_apply`` with the
             pool fused and unfused: r=0 logits match ``F.conv2d`` ≤ 1e-5
             with identical argmax; r=0.05 logits match the folded-weight
             conv; every forward makes exactly 3 kernel launches;
5. the kernels table, the card's name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FMA-unit FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP32_RTOL = 1e-5
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
    from repro_torch.kernels import paired_matmul as pm

    t0 = time.perf_counter()
    info = _build.build("paired_matmul")
    pm._kernel()  # load the library and bind its entry points
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", info["log"])]
    out = {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "built": info["built"],
        "nvcc": _build.nvcc_version(),
        "kernels_compiled": len(regs),
        "max_registers": max(regs, default=None),
        "spill_bytes": sum(spills),
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version, every form
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
# phase 3: the kernel at the main path's shapes
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
# phase 4: serving — the main path
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
    ctx = setup()
    layers = phase_layers(ctx)
    serve = phase_serve(ctx)

    head = [row for row in layers["rows"]
            if (row["mode"], row["rounding"]) == HEADLINE and row["fused_pool"]]
    emit({"kernels": [{
        "name": "paired_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paired_matmul.cu",
        "replaces": "src/repro/kernels/paired_matmul.py:158",
        "launches": serve["main_path_launches"],
        "max_abs_err": max(kernel["fp32_max_abs_err"], layers["max_abs_err"]),
        # one fused forward of 1000 images, per_column pairing at r=0.05:
        # the sum over its three launches
        "ms": sum(row["ms"] for row in head),
        "plain_ms": sum(row["plain_ms"] for row in head),
        "kernel_over_plain": sum(r["ms"] for r in head) / sum(r["plain_ms"] for r in head),
        "bound_ms": sum(row["bound_ms"] for row in head),
        "bound_by": "bytes" if sum(r["bytes"] / HBM_BYTES_PER_S for r in head)
        >= sum(r["flops"] / FP32_FLOP_PER_S for r in head) else "operations",
        "library_ms": sum(row["library_ms"] for row in head),
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
