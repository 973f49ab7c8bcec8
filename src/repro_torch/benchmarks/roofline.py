"""Roofline assembly: the dry run's records as the roofline table of one
H100, and K1's tile sweep on the card.

The port of ``benchmarks/roofline.py``.  :func:`load_cells` reads the dry
run's records (``launch.dryrun``, ``benchmarks/results/torch_dryrun/``);
:func:`roofline_row` turns one into the three terms of one rank (one card)
a step: compute, memory and collective seconds over
``core.cost_model.H100_SXM``'s data-sheet peaks, the dominant bound, the
useful-FLOP share and whether the rank's peak fits the card's 80 GB, for
every (arch × shape) of the single-pod mesh (the multi-pod cells prove the
pod axis shards and are listed by status).  These are predictions from
shapes, made without a card; a roofline share belongs beside the card's
``power.limit``.

:func:`kernel_block_sweep` autotunes K1 on the card: for each of
:data:`KERNEL_SWEEP_SHAPES` every candidate launch plan
(``kernels.tuning.candidate_plans``) is held to K1's plain version at 1e-5
relative (fp32) before it is timed, ``tuning.autotune_plans`` writes the
fastest into the ``TileCache`` at the path given, and the heuristic's plan
and ms stand beside the winner's, the bound and ``torch.matmul`` on the
folded weight.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline            # the table
    PYTHONPATH=src python -m repro_torch.benchmarks.roofline --sweep \\
        --tile-cache .cache/roofline_tiles.json                        # + K1 on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import zlib
from pathlib import Path

from repro_torch.benchmarks.common import RESULTS_DIR, fmt_table, write_result
from repro_torch.core.cost_model import H100_SXM

DRYRUN_DIR = RESULTS_DIR / "torch_dryrun"

# (label, M, N, K, pair_fraction, pool): pair_fraction of K lanes pair off
# in I/J halves; the rest stay residual.  The JAX sweep's shapes: a decode
# row, a LeNet-ish conv-as-GEMM, a d_model-scale FFN, and the fused
# conv→pool instance (window-major: M counts *pooled* rows).
KERNEL_SWEEP_SHAPES = [
    ("decode_row", 8, 512, 4096, 0.5, "none"),
    ("conv_gemm", 256, 120, 400, 0.4, "none"),
    ("conv_pool_gemm", 196, 16, 150, 0.4, "max2"),
    ("ffn_proj", 128, 1024, 8192, 0.25, "none"),
]

#: K1's fp32 tolerance against its plain version (relative to the largest output)
SWEEP_RTOL = 1e-5


def load_cells(mesh: str = "pod16x16", tag: str = "", root: Path | None = None) -> list[dict]:
    """The dry run's records of ``mesh``; without a ``tag`` the tagged
    (experiment) records are left out."""
    cells = []
    for p in sorted((root or DRYRUN_DIR).glob(f"*__{mesh}{'__' + tag if tag else ''}.json")):
        d = json.loads(p.read_text())
        if tag == "" and d.get("cell", "").count("__") > 2:
            continue  # skip tagged (perf-experiment) results in the baseline table
        cells.append(d)
    return cells


def roofline_row(d: dict) -> dict:
    """One record's row: the H100 terms of one rank, or its status."""
    arch, shape = d["cell"].split("__")[:2]
    if d.get("status") == "skipped":
        return {"arch": arch, "shape": shape, "bound": "skipped", "note": d["reason"][:40]}
    if d.get("status") != "ok":
        return {"arch": arch, "shape": shape, "bound": "FAILED", "note": d.get("error", "")[:40]}
    terms = H100_SXM.terms(
        d["cost"]["flops"], d["cost"]["bytes_accessed"], d["collectives"]["total_bytes"]
    )
    peak = d["memory"]["peak_device_bytes"]
    return {
        "arch": d["arch"],
        "shape": d["shape"],
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "t_collective_s": terms["t_collective_s"],
        "bound": terms["bound"],
        "t_bound_s": terms["t_bound_s"],
        "useful": d["model"].get("useful_flops_ratio", 0.0),
        "peak_GB": peak / 1e9,
        "fits": "Y" if peak < H100_SXM.hbm_bytes else "OVER",
    }


def _folded(kmat, w_res):
    """The dense (K, N) weight the paired operands stand for: x @ W =
    (x_I − x_J) @ kmat + x_R @ w_res."""
    import torch

    return torch.cat([kmat, -kmat, w_res], dim=0)


def kernel_block_sweep(cache_path: str | Path) -> tuple[list[dict], dict]:
    """Autotune K1 on the card at each sweep shape; winners into the cache.

    Every candidate plan is checked against K1's plain version (fp32, ≤
    :data:`SWEEP_RTOL` relative to the largest output; an assertion, as the
    JAX sweep's) before ``tuning.autotune_plans`` times it (CUDA-graph
    replays) and writes the fastest to the ``TileCache`` at ``cache_path``.
    Returns (a row a shape: the heuristic's plan and ms, the winner's, the
    bound, ``torch.matmul`` on the folded weight; the summary with the cache's
    path)."""
    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels import tuning
    from repro_torch.kernels.ref import rel_err

    cache = tuning.TileCache(cache_path)
    rows = []
    for label, M, N, K, frac, pool in KERNEL_SWEEP_SHAPES:
        P = int(K * frac / 2)
        R = K - 2 * P
        window = tuning.POOL_WINDOWS[pool]
        gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(label.encode()))
        rnd = lambda *s, gen=gen: torch.randn(*s, generator=gen, device="cuda")
        x = rnd(*((4,) if window == 4 else ()), M, K)
        kmat, w_res = rnd(P, N), rnd(R, N)
        want = pm.paired_matmul_plain(x, kmat, w_res, pool=pool)

        def runner(plan, x=x, kmat=kmat, w_res=w_res, pool=pool):
            return pm.paired_matmul_cuda(x, kmat, w_res, pool=pool, plan=plan)

        cands = tuning.candidate_plans(M, P, R, 1, N, window, 4)
        worst = 0.0
        for plan in cands:
            err = rel_err(runner(plan), want)
            assert err <= SWEEP_RTOL, f"{label} {plan}: rel err {err:.2e}"
            worst = max(worst, err)
        best, records = tuning.autotune_plans(runner, M, P, R, 1, N, pool, 4, cache=cache,
                                              candidates=cands)
        heur = next(r for r in records if r["heuristic"])
        win = min(records, key=lambda r: r["time_s"])
        x2, w = x.reshape(-1, K), _folded(kmat, w_res)
        lib_s = tuning.measure(lambda x2=x2, w=w: torch.matmul(x2, w))
        nbytes = (x.numel() + (P + R) * N + M * N) * 4
        flops = window * M * (2 * N * (P + R) + P)
        t_bytes, t_ops = nbytes / H100_SXM.hbm_bw, flops / H100_SXM.peak_flops_fp32
        rows.append({
            "shape": label, "MNK": f"{M}x{N}x{K}", "pairs": P, "pool": pool,
            "candidates": len(cands), "max_rel_err": worst,
            "heuristic": {k: heur[k] for k in tuning.PLAN_FIELDS},
            "heuristic_ms": heur["time_s"] * 1e3,
            "winner": dataclasses.asdict(best), "winner_ms": win["time_s"] * 1e3,
            "heuristic_matches": bool(win["heuristic"]),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "matmul_ms": lib_s * 1e3,
        })
    return rows, {"cache_path": str(cache.path), "entries": len(cache)}


def run(*, sweep: bool = False, cache_path: str | Path = ".cache/roofline_tiles.json",
        root: Path | None = None) -> dict:
    """The roofline table of the single-pod cells and the multi-pod cells'
    status; with ``sweep`` K1's tile sweep on the card first."""
    out: dict = {"peaks": dataclasses.asdict(H100_SXM)}
    if sweep:
        rows, summary = kernel_block_sweep(cache_path)
        print(fmt_table(rows, ["shape", "MNK", "pairs", "pool", "candidates", "heuristic_ms",
                               "winner_ms", "bound_ms", "matmul_ms"],
                        "K1 tile sweep (fp32; the heuristic's plan and the measured winner)"))
        print(f"[roofline] tile cache: {summary['entries']} measured winners → "
              f"{summary['cache_path']}")
        out["kernel_block_sweep"], out["kernel_autotune"] = rows, summary
    cells = load_cells(root=root)
    rows = [roofline_row(d) for d in cells]
    if not rows:
        print("[roofline] no dry-run records — run repro_torch.launch.dryrun for the arch x "
              "shape table")
    else:
        cols = ["arch", "shape", "t_compute_s", "t_memory_s", "t_collective_s", "bound",
                "useful", "peak_GB", "fits"]
        print(fmt_table(rows, cols, "Roofline (single-pod 16x16, one rank a card, per step; "
                                    "H100 SXM data-sheet peaks)"))
        n_over = sum(1 for r in rows if r.get("fits") == "OVER")
        n_fail = sum(1 for r in rows if r.get("bound") == "FAILED")
        print(f"[roofline] {len(rows)} cells; {n_fail} failed; {n_over} over 80 GB")
    multi = {d["cell"]: d["status"] for d in load_cells("pod2x16x16", root=root)}
    out.update(rows=rows, multi_pod=multi)
    write_result("roofline", out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true", help="autotune K1 on the card first")
    ap.add_argument("--tile-cache", default=".cache/roofline_tiles.json",
                    help="where the sweep writes its winners")
    args = ap.parse_args(argv)
    run(sweep=args.sweep, cache_path=args.tile_cache)


if __name__ == "__main__":
    main()
