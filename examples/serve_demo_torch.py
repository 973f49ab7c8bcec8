"""Batched serving demo of the PyTorch port with the paper's technique
applied to the weights.

Builds a small LM (the arch's reduced config, random weights from seed 0),
folds its decoder weights per column at a chosen rounding
(``core.transform.fold_lm_params``) and serves batched greedy generations
from the KV-cache engine, folded beside original, showing that the folded
weights are a drop-in replacement at inference time, as the paper deploys
them.  ``--gemm pallas`` runs the engines' GEMMs on the paired kernel's
dense form (K1).

The port of ``examples/serve_demo.py``, which folds the JAX value tree
through ``pair_model_params``; on an LM tree that pairs the wrong axes, so
the port folds each layer's (K, N) matrix per column instead.

Run:  PYTHONPATH=src python examples/serve_demo_torch.py [--rounding 0.01]
      (on the CPU add --device cpu)
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.transform import fold_lm_params
from repro_torch.device import resolve_device
from repro_torch.models import lm as M
from repro_torch.serving.engine import ServeEngine


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--rounding", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--gemm", choices=("xla", "pallas"), default="xla",
                    help="the engines' GEMMs: torch.matmul, or K1's dense form")
    ap.add_argument("--device", default=None, help="default the GPU")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    dev = resolve_device(args.device)
    model = M.init_lm(cfg, 0, device=dev)
    paired, report = fold_lm_params(model, args.rounding)
    s = report.savings()
    print(f"[serve] paired {report.total_pairs} pairs "
          f"({100 * report.pair_fraction:.1f}% of weights) at rounding {args.rounding} "
          f"→ modeled power saving {100 * s['power_saving']:.1f}%, "
          f"area saving {100 * s['area_saving']:.1f}%")

    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm=args.gemm)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, size=(6 + 3 * i,)).astype(np.int32)
               for i in range(2)}
    base = ServeEngine(cfg, model, max_seq=64, batch_size=2, knobs=knobs)
    pair = ServeEngine(cfg, paired, max_seq=64, batch_size=2, knobs=knobs)
    out_base = base.generate(dict(prompts), args.steps)
    out_pair = pair.generate(dict(prompts), args.steps)

    agree = {}
    for slot in prompts:
        agree[slot] = sum(a == b for a, b in zip(out_base[slot], out_pair[slot], strict=True))
        print(f"slot {slot}: original {out_base[slot]}")
        print(f"        paired   {out_pair[slot]}  ({agree[slot]}/{args.steps} tokens agree)")
    return {"report": report, "original": out_base, "paired": out_pair, "agree": agree}


if __name__ == "__main__":
    main()
