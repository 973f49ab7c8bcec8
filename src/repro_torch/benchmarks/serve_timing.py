"""Serve timing of one LM arch on the card, as one JSON line: the seconds the
engine takes to build (pairing its weights), and the prefill and decode wall
times of ``launch.serve.serve`` at the lm_serve phase's settings of
``chip_smoke.py`` (bf16, structured r=0.05, K1 + K2, batch 4, max_seq 256).

It imports the ``repro_torch`` found under ``--src``, so two trees can be
compared on one card, each in its own process, e.g. a checkout of the parent
commit against the working tree, and the working tree with and without a
tile cache:

    python src/repro_torch/benchmarks/serve_timing.py --src OTHER/src --tag parent
    python src/repro_torch/benchmarks/serve_timing.py --src src --tag change
    python src/repro_torch/benchmarks/serve_timing.py --src src --tag cached \\
        --tile-cache .cache/tile_cache.json
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the directory holding repro_torch")
    ap.add_argument("--tag", default="", help="a name for this run in the JSON line")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=32, help="tokens a slot")
    ap.add_argument("--tile-cache", default="", help="serve K1's plans from this cache")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--device", default=None, help="default: the card; cpu runs the plain "
                                                   "versions")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.launch.serve import serve

    kw = {"tile_cache": args.tile_cache} if args.tile_cache else {}
    rec = serve(arch=args.arch, batch=args.batch, max_seq=args.max_seq, steps=args.steps,
                pair_rounding=0.05, gemm="pallas_paired", attn="pallas_fused",
                layers=args.layers, smoke=args.smoke, device=args.device, **kw)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:  # no nvidia-smi: a CPU run
        smi = ""
    steps = rec["step_ms"]
    out = {
        "tag": args.tag, "src": args.src, "arch": args.arch,
        "layers": rec["engine"].cfg.n_layers, "tile_cache": args.tile_cache or None,
        "card": smi.splitlines()[0] if smi else "not measured",
        "engine_build_s": rec["pairing_s"], "prefill_ms": rec["prefill_ms"],
        # the first two steps warm the allocator and the kernels' first launches
        "decode_ms_median": statistics.median(steps[2:]) if len(steps) > 2 else None,
        "decode_ms": steps,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
