"""Table I: add/sub/mult counts against the rounding size, LeNet-5.

The port of ``benchmarks/table1.py``.  The paper counts the three conv
layers only (its baseline: 405 600 multiplies = 117 600 + 240 000 + 48 000
MACs), pairing weights within each filter.  ``run`` prints the ledger of the
trained LeNet beside the paper's, and what the kernel path executes at each
rounding across the pairing-mode spectrum: ``structured`` (one shared-row
pairing for all output channels), ``column_blocked`` over
``KERNEL_BLOCK_NS`` and, at ``block_n = 1``, the paper's per-column
pairing, whose lanes saved must equal the analytic subtraction count.

Asserted at every rounding: adds == mults, adds + subs == 405 600, kernel
baseline lanes == 405 600, blocked(1) lanes saved == the analytic subs.
The ordering structured ≤ blocked(8) ≤ … ≤ per-column is reported as
``spectrum_ordered``, not asserted: it fails on trained weights at some
roundings (the reference asserts it and fails there too).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cost_model import paper_table1
from repro_torch.core.pairing import sweep_rounding
from repro_torch.core.transform import build_conv_pairings
from repro_torch.benchmarks.common import fmt_table, write_result
from repro_torch.models.lenet import LENET_CONV_POSITIONS, LENET_CONV_SHAPES

ROUNDINGS = [0.0, 0.0001, 0.005, 0.01, 0.015, 0.02, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3]
QUICK_ROUNDINGS = [0.0, 0.01, 0.05, 0.3]
# column-blocked kernel ledger block sizes: 1 == per-column (the paper),
# larger blocks trade pairing rate for activation bandwidth
KERNEL_BLOCK_NS = (1, 2, 4, 8)
QUICK_BLOCK_NS = (1, 4)
BASELINE_MACS = 405600


def conv_matrices(params) -> tuple[list[np.ndarray], list[int]]:
    """The three conv kernels as (K, N) float64 matrices, and their output
    positions per image."""
    weights, positions = [], []
    for name, (shape, pos) in LENET_CONV_SHAPES.items():
        k = params[name]["w"].detach().cpu().double().numpy()
        weights.append(k.reshape(-1, shape[-1]))
        positions.append(pos)
    return weights, positions


def measured_ledger(arts: dict) -> dict:
    """What the kernel path executes per image for one set of artifacts."""
    counts = {n: a.measured_op_counts() for n, a in arts.items()}
    return {
        "per_layer": {n: {"n_pairs": arts[n].n_pairs, **c} for n, c in counts.items()},
        "subs_per_image": sum(c["subs_executed"] for c in counts.values()),
        "lanes_saved": sum(c["lanes_saved"] for c in counts.values()),
    }


def kernel_ledgers(params, roundings, block_ns) -> dict:
    """``{rounding: structured ledger + {"blocked": {bn: ledger}}}``."""
    rows = {}
    for r in roundings:
        entry = measured_ledger(build_conv_pairings(params, r, positions=LENET_CONV_POSITIONS))
        entry["blocked"] = {
            bn: measured_ledger(build_conv_pairings(
                params, r, positions=LENET_CONV_POSITIONS, mode="column_blocked", block_n=bn))
            for bn in block_ns
        }
        rows[r] = entry
    return rows


def run(quick: bool = False, *, trained=None, device=None) -> dict:
    """``trained`` is ``get_trained_lenet``'s result; without it the default
    trainer runs (or reads its cache) on ``device``."""
    if trained is None:
        from repro_torch.train.lenet_trainer import get_trained_lenet

        trained = get_trained_lenet(device=device)
    params, _, _, info = trained

    weights, positions = conv_matrices(params)
    roundings = QUICK_ROUNDINGS if quick else ROUNDINGS
    block_ns = QUICK_BLOCK_NS if quick else KERNEL_BLOCK_NS
    ours = sweep_rounding(weights, positions, roundings)
    paper = {row["rounding"]: row for row in paper_table1()}
    kernel_rows = kernel_ledgers(params, roundings, block_ns)

    rows = []
    for r in ours:
        p = paper.get(r["rounding"], {})
        k = kernel_rows[r["rounding"]]
        rows.append({
            "rounding": r["rounding"],
            "adds": r["adds"],
            "subs": r["subs"],
            "mults": r["mults"],
            "total": r["total"],
            "paper_subs": p.get("subs", "-"),
            "paper_total": p.get("total", "-"),
            "kernel_subs": k["subs_per_image"],
            "kernel_lanes_saved": k["lanes_saved"],
            **{f"b{bn}_lanes_saved": k["blocked"][bn]["lanes_saved"] for bn in block_ns},
        })

    # structural invariants of Table I
    for r in ours:
        assert r["adds"] == r["mults"], r
        assert r["adds"] + r["subs"] == BASELINE_MACS, (r, "baseline MACs must be 405600")
    analytic = {row["rounding"]: row for row in ours}
    spectrum_ordered = {}
    for r, k in kernel_rows.items():
        baseline = sum(c["baseline_lanes"] for c in k["per_layer"].values())
        assert baseline == BASELINE_MACS, (r, "kernel baseline lanes must be 405600")
        # the executed per-column pairing (block_n=1) IS the analytic ledger
        b1 = k["blocked"][1]["lanes_saved"]
        assert b1 == analytic[r]["subs"], (
            f"r={r}: blocked(1) kernel ledger {b1} != analytic per-column subs "
            f"{analytic[r]['subs']}"
        )
        saved = [k["lanes_saved"]] + [
            k["blocked"][bn]["lanes_saved"] for bn in sorted(block_ns, reverse=True)
        ]
        spectrum_ordered[r] = all(a <= b for a, b in zip(saved, saved[1:], strict=False))

    out = {
        "rows": rows,
        "kernel_measured": kernel_rows,
        "spectrum_ordered": spectrum_ordered,
        "train_info": {k: v for k, v in info.items() if k != "losses"},
    }
    print(fmt_table(rows, list(rows[0].keys()), "Table I: op counts vs rounding (ours vs paper)"))
    unordered = [r for r, ok in spectrum_ordered.items() if not ok]
    print(f"pairing-mode spectrum ordered at {len(roundings) - len(unordered)} of "
          f"{len(roundings)} roundings" + (f" (not at r = {unordered})" if unordered else ""))
    write_result("table1", out)
    return out
