"""Quickstart of the PyTorch port: the paper's technique in 40 lines.

Takes a weight matrix, runs the paper's Algorithm-1 pairing at a few
rounding sizes, prints the op-count ledger and the modelled ASIC savings,
and evaluates the structured variant through the paired subtractor kernel
(K1) on the GPU, or its plain version with ``--device cpu``.

The port of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.cost_model import AsicCostModel, OpCounts
from repro_torch.core.pairing import fold_columns, pair_columns, pair_rows_structured
from repro_torch.device import resolve_device
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.ops import apply_structured_pairing


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default the GPU; 'cpu' runs K1's plain version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    W = rng.normal(size=(512, 256)) * 0.08  # a layer's weights (K=512 in, N=256 out)
    x = torch.as_tensor(rng.normal(size=(4, 512)), dtype=torch.float32, device=dev)
    model = AsicCostModel()
    base = OpCounts(mults=W.size, adds=W.size, subs=0)

    print("rounding |  pairs | weight-err |  power-saving |  area-saving")
    for r in [0.001, 0.005, 0.02, 0.05]:
        cp = pair_columns(W, r)
        Wf = fold_columns(W, cp)
        new = OpCounts(W.size - cp.total_pairs, W.size - cp.total_pairs, cp.total_pairs)
        print(f"  {r:6.3f} | {cp.total_pairs:6d} | {np.abs(Wf - W).max():10.5f} | "
              f"{100 * model.power_saving(base, new):12.2f}% | "
              f"{100 * model.area_saving(base, new):11.2f}%")

    # Structured pairing needs row-level antisymmetry (shared across outputs);
    # iid-random weights have none, so build a matrix with that structure the
    # way trained networks often do (negated feature detectors + noise).
    Ws = np.concatenate([W[:256], -W[:256] + rng.normal(size=(256, 256)) * 0.002])
    sp = pair_rows_structured(Ws, rounding=0.01)
    before = pm.launch_count()
    y_kernel = apply_structured_pairing(x, sp)
    launches = pm.launch_count() - before
    y_exact = x @ torch.as_tensor(Ws, dtype=torch.float32, device=dev)
    err = float((y_kernel - y_exact).abs().max())
    print(f"\nstructured pairing: {sp.n_pairs} shared pairs "
          f"→ contraction {Ws.shape[0]} → {Ws.shape[0] - sp.n_pairs} lanes "
          f"({100 * sp.n_pairs / Ws.shape[0]:.0f}% fewer)")
    print(f"{'kernel' if launches else 'plain version'} on {dev} vs exact matmul max err: "
          f"{err:.5f} (bounded by rounding)")
    return {"device": str(dev), "pairs": sp.n_pairs, "max_err": err, "launches": launches}


if __name__ == "__main__":
    main()
