"""Benchmark harness of the port: one module per paper table or figure, the
beyond-paper benches and the roofline.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] [--only NAME]... \\
        [--family ARCH] [--device cpu|cuda]

The port of ``benchmarks/run.py``, in its order: the LeNet benches
reproduce the paper's own results (Table I, Fig. 8); ``lm_paired`` and
``pairing_rate_lm`` carry the technique to the LMs, ``model_zoo`` runs
every config family through the paired path, ``serving`` the hardened
front end, ``mesh_decode`` the tensor-parallel decode (gloo ranks), and
``roofline`` assembles the dry run's records (and, on the card, sweeps
K1's tiles).  Everything runs on the GPU unless ``--device cpu`` is given.

Besides each bench's own ``torch_<name>.json``, the harness writes one
``benchmarks/results/torch_BENCH_<name>.json`` a bench: its status, wall
seconds, the kernel launches it made (by kernel) and its
``perf_summary``.  A failing bench prints its traceback and is recorded
with ``status: "error"``; the exit code is 1 when any selected bench
failed, else 0.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.benchmarks import (
    common,
    fig8,
    mesh_decode,
    model_zoo,
    pairing_rate_lm,
    roofline,
    serving,
    table1,
)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import kernel_launches


def _roofline(quick: bool, device: str, family: str | None) -> dict:
    # K1's tile sweep needs the card; its winners go beside the results
    return roofline.run(sweep=device == "cuda",
                        cache_path=common.RESULTS_DIR / "torch_roofline_tiles.json")


#: (name, description, fn(quick, device, family)) in the JAX harness's order
BENCHES = [
    ("table1", "paper Table I",
     lambda quick, device, family: table1.run(quick, device=device)),
    ("fig8", "paper Fig. 8",
     lambda quick, device, family: fig8.run(quick, device=device)),
    ("lm_paired", "beyond paper: paired LM decode",
     lambda quick, device, family: fig8.run_lm_paired(quick, device=device)),
    ("pairing_rate_lm", "beyond paper: per-GEMM pairing rates of the ten LMs",
     lambda quick, device, family: pairing_rate_lm.run(quick, device=device)),
    ("model_zoo", "paired path across all ten config families",
     lambda quick, device, family: model_zoo.run(quick, family, device=device)),
    ("serving", "hardened front end: load sweep + chaos, degraded-path parity",
     lambda quick, device, family: serving.run(quick, device=device)),
    ("mesh_decode", "sharded paired decode: mesh parity + per-shard ledgers",
     lambda quick, device, family: mesh_decode.run(n_steps=4 if quick else 10,
                                                   device=device)),
    ("roofline", "dry-run analysis", _roofline),
]


def main(argv: list[str] | None = None) -> int:
    names = [name for name, _, _ in BENCHES]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", action="append", default=None, metavar="NAME",
                    help="run only the named bench (repeatable): " + ", ".join(names))
    ap.add_argument("--family", default=None, metavar="ARCH",
                    help="restrict the model_zoo bench to one config family "
                         "(the other benches ignore it)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="the GPU unless cpu is asked for")
    args = ap.parse_args(argv)
    if args.only:
        unknown = sorted(set(args.only) - set(names))
        if unknown:
            ap.error(f"unknown bench name(s) {unknown}; choose from {sorted(names)}")
    model_zoo.families(family=args.family)  # raises on an unknown family
    device = resolve_device(args.device).type
    selected = [b for b in BENCHES if not args.only or b[0] in args.only]

    n_fail = 0
    for name, desc, fn in selected:
        print(f"\n{'=' * 70}\n== {name} ({desc})\n{'=' * 70}")
        t0, before = time.time(), kernel_launches()
        try:
            res, error = fn(args.quick, device, args.family), None
            print(f"[{name}] done in {time.time() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 — record the bench's failure, run the rest
            print(f"[{name}] FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
            res, error = {}, f"{type(e).__name__}: {e}"
            n_fail += 1
        common.write_result(f"BENCH_{name}", {
            "bench": name,
            "status": "error" if error else "ok",
            "error": error,
            "wall_clock_s": time.time() - t0,
            "quick": args.quick,
            "device": device,
            "kernel_launches": {k: v - before[k] for k, v in kernel_launches().items()},
            "summary": res.get("perf_summary", {}) if isinstance(res, dict) else {},
        })
    print(f"\n[benchmarks] {len(selected) - n_fail}/{len(selected)} benches succeeded")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
