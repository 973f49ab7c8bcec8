"""Fig. 8: power/area saving against accuracy per rounding size, LeNet-5.

The port of the LeNet parts of ``benchmarks/fig8.py``.  For each rounding:
pair the conv weights per filter (Algorithm 1), snap pairs to their common
magnitude (``fold_columns``), score the test split with ``F.conv2d`` on the
folded weights (what the subtractor dataflow computes), and price the op
mix with the paper's 65 nm ASIC model.  Beside that curve, the paired conv
path is run and measured: K1 on the card, its plain version on the CPU.

Three substitutions for the reference's TPU machinery: the tile configs of
``choose_blocks`` become K1's launch plans (``kernels/tuning.plan``); the
host timer ``measure`` becomes CUDA-event timing on the card
(``common.device_ms``; ``None`` on the CPU); the jaxpr schedule audit
becomes counts of K1 launches, K1 calls and standalone pools
(``repro_torch.analysis``).  The LM parts (``_train_tiny_lm``,
``lm_paired_decode_bench``) wait for the port's LM training.

Paper headline at rounding 0.05: 32.03 % power, 24.59 % area, 0.1 %
accuracy loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import counting
from repro_torch.benchmarks.common import device_ms, fmt_table, full_fp32, write_result
from repro_torch.core.cost_model import AsicCostModel, OpCounts
from repro_torch.core.pairing import (
    column_pairing_for_conv,
    fold_columns,
    pair_columns,
    pairing_op_counts,
)
from repro_torch.core.transform import build_conv_pairings
from repro_torch.kernels import tuning
from repro_torch.kernels.paired_matmul import POOL_WINDOW
from repro_torch.kernels.ref import rel_err
from repro_torch.models.lenet import (
    LENET_CONV_POSITIONS,
    LENET_CONV_SHAPES,
    lenet_accuracy,
    lenet_apply,
)

ROUNDINGS = [0.0, 0.0001, 0.005, 0.01, 0.015, 0.02, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3]
QUICK_ROUNDINGS = [0.0, 0.01, 0.05, 0.3]
HEADLINE_ROUNDING = 0.05
PAPER_HEADLINE = {"rounding": 0.05, "power_saving_%": 32.03, "area_saving_%": 24.59,
                  "acc_loss_%": 0.1}
POOLED = ("conv1", "conv2")  # the layers a 2×2 max-pool follows
R0_RTOL = 1e-5


def _conv_numpy(params, name) -> np.ndarray:
    return params[name]["w"].detach().cpu().double().numpy()


def _device(params) -> torch.device:
    return params["fc2"]["w"].device


def paired_lenet(params, rounding: float):
    """Fold the conv weights at ``rounding``; returns ``(params', OpCounts)``."""
    new = dict(params)
    mults = adds = subs = 0
    for name, (shape, pos) in LENET_CONV_SHAPES.items():
        k = _conv_numpy(params, name)
        cp = column_pairing_for_conv(k, rounding)
        folded = fold_columns(k.reshape(-1, shape[-1]), cp).reshape(shape)
        w = params[name]["w"]
        new[name] = {**params[name], "w": torch.as_tensor(
            folded.astype(np.float32), device=w.device)}
        c = pairing_op_counts(k.size, cp.total_pairs, pos)
        mults += c["mults"]
        adds += c["adds"]
        subs += c["subs"]
    return new, OpCounts(mults=mults, adds=adds, subs=subs)


@full_fp32()
@torch.no_grad()
def measured_conv_path(params, test_x, rounding: float, batch: int = 32,
                       mode: str = "structured", block_n: int = 0) -> dict:
    """Run LeNet through the paired conv path and measure what it executed.

    Builds the per-layer artifacts the kernel consumes (``mode``/``block_n``
    pick the point of the pairing spectrum: structured, column-blocked, or
    per-column at ``block_n=1``), runs the forward on ``batch`` test images,
    and reports per layer the baseline lanes (the paper's multiplies), the
    lanes after pairing and the subtracts per image, the K1 launches of the
    forward, and the logits' deviation from ``F.conv2d``.
    """
    arts = build_conv_pairings(params, rounding, positions=LENET_CONV_POSITIONS,
                               mode=mode, block_n=block_n)
    xb = torch.as_tensor(test_x[:batch], dtype=torch.float32, device=_device(params))
    y_ref = lenet_apply(params, xb)
    with counting() as counts:
        y = lenet_apply(params, xb, conv_impl="paired", paired=arts)
    per_layer = {}
    for name, art in arts.items():
        kh, kw, cin, cout = art.kernel_shape
        per_layer[name] = {"K": kh * kw * cin, "N": cout, "positions": art.positions,
                           "n_pairs": art.n_pairs, **art.measured_op_counts()}
    total_baseline = sum(v["baseline_lanes"] for v in per_layer.values())
    assert total_baseline == 405600, (
        f"kernel baseline lanes {total_baseline} != paper's 405600 multiplies")
    return {
        "rounding": rounding,
        "batch": batch,
        "mode": mode,
        "block_n": block_n,
        "per_layer": per_layer,
        "total_baseline_lanes": total_baseline,
        "total_paired_lanes": sum(v["paired_lanes"] for v in per_layer.values()),
        "total_subs_per_image": sum(v["subs_executed"] for v in per_layer.values()),
        "k1_launches": counts["k1_launches"],
        "max_abs_err_vs_conv2d": float((y - y_ref).abs().max()),
        # relative to the logit scale: the stable gate (absolute fp32 error
        # grows with batch and accumulation order; relative does not)
        "rel_err_vs_conv2d": rel_err(y, y_ref),
    }


def pairing_block_sweep(params, rounding: float, block_ns=None) -> dict:
    """Pairing rate against block size at one rounding: the spectrum the
    column-blocked kernel opens between structured and per-column pairing
    (``lanes_saved / baseline_lanes`` and subtracts per image for each
    ``block_n``; ``structured`` is the ∞-block end)."""
    if block_ns is None:
        block_ns = (1, 2, 4, 8, 16)
    points = {}

    def record(tag, arts):
        counts = [a.measured_op_counts() for a in arts.values()]
        baseline = sum(c["baseline_lanes"] for c in counts)
        saved = sum(c["lanes_saved"] for c in counts)
        points[tag] = {"lanes_saved": saved, "pair_rate": saved / baseline,
                       "subs_per_image": sum(c["subs_executed"] for c in counts)}

    record("structured", build_conv_pairings(params, rounding, positions=LENET_CONV_POSITIONS))
    for bn in block_ns:
        record(f"block_{bn}", build_conv_pairings(
            params, rounding, positions=LENET_CONV_POSITIONS, mode="column_blocked",
            block_n=bn))

    # the analytic per-column rate (Algorithm 1, not executed) for comparison
    analytic_pairs = baseline = 0
    for name, (shape, pos) in LENET_CONV_SHAPES.items():
        k = _conv_numpy(params, name)
        analytic_pairs += pair_columns(k.reshape(-1, shape[-1]), rounding).total_pairs * pos
        baseline += k.size * pos
    points["analytic_per_column"] = {"lanes_saved": analytic_pairs,
                                     "pair_rate": analytic_pairs / baseline}
    # block_n=1 *is* the analytic pairing, executed
    assert points["block_1"]["lanes_saved"] == analytic_pairs, (
        points["block_1"]["lanes_saved"], analytic_pairs)
    return {"rounding": rounding, "points": points}


@full_fp32()
@torch.no_grad()
def fused_pool_path(params, test_x, batch: int = 32) -> dict:
    """The fused conv→pool path against the unfused schedules, counted.

    Four variants of one LeNet forward on ``batch`` test images, at r = 0:
    ``torch`` (``F.conv2d`` and a standalone 2×2 pool), ``paired_unfused``
    (K1, the pool still standalone), ``paired_fused`` (K1 with the pool in
    its epilogue: one store per conv layer) and ``paired_fused_blocked``
    (the same through the column-blocked layout, block_n=4).  Each variant
    records its ``repro_torch.analysis`` counts (K1 launches and calls,
    standalone pools), its device ms on the card, and its relative error
    against ``torch``.  Gates: both fused variants run 3 K1 calls (and, on
    the card, 3 launches), no standalone pool, and match ``torch`` within
    1e-5; the unfused one runs the 2 pools.
    """
    arts = build_conv_pairings(params, 0.0, positions=LENET_CONV_POSITIONS)
    barts = build_conv_pairings(params, 0.0, positions=LENET_CONV_POSITIONS,
                                mode="column_blocked", block_n=4)
    dev = _device(params)
    xb = torch.as_tensor(test_x[:batch], dtype=torch.float32, device=dev)
    variants = {
        "torch": dict(conv_impl="torch"),
        "paired_unfused": dict(conv_impl="paired", paired=arts),
        "paired_fused": dict(conv_impl="paired", paired=arts, fuse_pool=True),
        "paired_fused_blocked": dict(conv_impl="paired", paired=barts, fuse_pool=True),
    }
    out: dict = {}
    y_ref = lenet_apply(params, xb)
    for name, kw in variants.items():
        with counting() as counts:
            y = lenet_apply(params, xb, **kw)
        out[name] = {
            **counts,
            "ms": device_ms(lambda kw=kw: lenet_apply(params, xb, **kw), dev),
            "rel_err_vs_torch": rel_err(y, y_ref),
        }
    want_launches = 3 if dev.type == "cuda" else 0
    for tag in ("paired_fused", "paired_fused_blocked"):
        v = out[tag]
        assert v["pool_ops"] == 0 and v["k1_calls"] == 3, (
            f"{tag}: {v['pool_ops']} standalone pools, {v['k1_calls']} K1 calls "
            "(want 0 and one a conv layer)")
        assert v["k1_launches"] == want_launches, (
            f"{tag}: {v['k1_launches']} K1 launches on {dev}, want {want_launches}")
        assert v["rel_err_vs_torch"] <= R0_RTOL, (
            f"{tag} at rounding 0 must match F.conv2d: rel err {v['rel_err_vs_torch']:.2e}")
    assert out["paired_unfused"]["pool_ops"] == 2  # the two pooled layers
    return {"batch": batch, "device": str(dev), "variants": out}


def kernel_plans(params, rounding: float, batch: int) -> dict:
    """K1's launch plan for each conv layer of the fused per-column forward
    at ``rounding`` over ``batch`` images: what the card runs, recorded
    so runs are reproducible (the reference records TPU tile configs)."""
    arts = build_conv_pairings(params, rounding, positions=LENET_CONV_POSITIONS,
                               mode="per_column")
    plans = {}
    for name, art in arts.items():
        bp = art.pairing
        window = POOL_WINDOW if name in POOLED else 1
        M = batch * art.positions // window
        plan = tuning.plan(M, bp.Pmax, bp.Rmax, bp.n_blocks, bp.block_n, window, 4)
        plans[name] = {"M": M, "P": bp.Pmax, "R": bp.Rmax, "blocks": bp.n_blocks,
                       "window": window, **dataclasses.asdict(plan)}
    return plans


def run(quick: bool = False, *, trained=None, device=None) -> dict:
    """``trained`` is ``get_trained_lenet``'s result; without it the default
    trainer runs (or reads its cache) on ``device``."""
    if trained is None:
        from repro_torch.train.lenet_trainer import get_trained_lenet

        trained = get_trained_lenet(device=device)
    params, test_x, test_y, info = trained
    base_acc = info["test_acc"]
    model = AsicCostModel()
    base_ops = OpCounts(mults=405600, adds=405600, subs=0)

    rows = []
    with full_fp32():
        for r in QUICK_ROUNDINGS if quick else ROUNDINGS:
            p2, ops = paired_lenet(params, r)
            acc = lenet_accuracy(p2, test_x, test_y)
            rows.append({
                "rounding": r,
                "subs": ops.subs,
                "power_saving_%": 100 * model.power_saving(base_ops, ops),
                "area_saving_%": 100 * model.area_saving(base_ops, ops),
                "accuracy_%": 100 * acc,
                "acc_loss_%": 100 * (base_acc - acc),
            })

    # weight distribution of conv3 (paper Fig. 3 / Fig. 4)
    w3 = _conv_numpy(params, "conv3").ravel()
    hist, edges = np.histogram(w3, bins=40)
    dist = {"mean": float(w3.mean()), "std": float(w3.std()),
            "frac_positive": float((w3 > 0).mean()), "hist_counts": hist.tolist(),
            "hist_edges": edges.tolist()}

    batch = 16 if quick else 32
    h = HEADLINE_ROUNDING
    measured = {
        "r0": measured_conv_path(params, test_x, 0.0, batch=batch),
        "headline": measured_conv_path(params, test_x, h, batch=batch),
        # structured pairing needs a larger rounding than per-column pairing
        # before it engages on trained weights
        "r_structured": measured_conv_path(params, test_x, 0.3, batch=batch),
        "r0_blocked": measured_conv_path(params, test_x, 0.0, batch=batch,
                                         mode="column_blocked", block_n=4),
        "headline_blocked": measured_conv_path(params, test_x, h, batch=batch,
                                               mode="column_blocked", block_n=4),
        "headline_per_column": measured_conv_path(params, test_x, h, batch=batch,
                                                  mode="column_blocked", block_n=1),
    }
    for tag in ("r0", "r0_blocked"):
        assert measured[tag]["rel_err_vs_conv2d"] <= R0_RTOL, (
            f"paired conv ({tag}) at rounding 0 must match F.conv2d: relative err "
            f"{measured[tag]['rel_err_vs_conv2d']:.2e}")

    block_sweep = pairing_block_sweep(params, h, block_ns=(1, 4) if quick else None)
    fused = fused_pool_path(params, test_x, batch=batch)
    headline = next(row for row in rows if row["rounding"] == h)

    out = {
        "rows": rows,
        "baseline_accuracy": base_acc,
        "data_source": info["source"],
        "device": str(_device(params)),
        "kernel_plans": kernel_plans(params, h, batch),
        "measured_conv_path": measured,
        "pairing_block_sweep": block_sweep,
        "fused_pool_path": fused,
        "conv3_weight_distribution": dist,
        "headline": headline,
        "paper_headline": PAPER_HEADLINE,
    }
    print(fmt_table(rows, list(rows[0].keys()), "Fig. 8: trade-off per rounding size"))
    print(f"headline @ r={h}: power saving {headline['power_saving_%']:.2f} %, area saving "
          f"{headline['area_saving_%']:.2f} %, accuracy loss {headline['acc_loss_%']:.2f} % "
          f"(paper: {PAPER_HEADLINE['power_saving_%']} / {PAPER_HEADLINE['area_saving_%']} / "
          f"{PAPER_HEADLINE['acc_loss_%']})")
    for tag in ("headline", "r_structured", "headline_blocked", "headline_per_column"):
        m = measured[tag]
        mode = m["mode"] if m["block_n"] == 0 else f"blocked(n={m['block_n']})"
        print(f"measured paired-conv path [{mode}] @ r={m['rounding']}: "
              f"{m['total_baseline_lanes']} baseline lanes/image → {m['total_paired_lanes']} "
              f"paired, {m['total_subs_per_image']} subs/image, {m['k1_launches']} K1 launches")
    print("pairing rate vs block size @ r=0.05: " + ", ".join(
        f"{tag}={p['pair_rate']:.3f}" for tag, p in block_sweep["points"].items()))
    print(f"r=0 err vs F.conv2d: abs {measured['r0']['max_abs_err_vs_conv2d']:.2e} "
          f"rel {measured['r0']['rel_err_vs_conv2d']:.2e}")
    for name, v in fused["variants"].items():
        ms = "not measured (CPU)" if v["ms"] is None else f"{v['ms']:.4f} ms/batch"
        print(f"conv→pool [{name:>20s}]: {ms}, {v['pool_ops']} standalone pools, "
              f"{v['k1_calls']} K1 calls ({v['k1_launches']} launched), "
              f"rel err {v['rel_err_vs_torch']:.1e}")
    print(f"conv3 weights: mean {dist['mean']:+.4f} std {dist['std']:.4f} positive fraction "
          f"{dist['frac_positive']:.3f} (paper Fig. 3/4: roughly zero-centred, enabling "
          "opposite-sign pairs)")
    write_result("fig8", out)
    return out
