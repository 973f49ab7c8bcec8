"""End-to-end paper reproduction on the PyTorch port: train LeNet-5, pair
its weights, and reproduce the paper's Table I and Fig. 8 (its power, area
and accuracy trade-off), on the GPU unless asked for the CPU.

Run from the repository root:

    python3 examples/lenet_mnist_torch.py [--quick] [--device cpu]

The trained weights are cached under ``.cache/`` (``lenet_torch_*.npz``);
the results go to ``benchmarks/results/torch_{table1,fig8}.json``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.benchmarks import fig8, table1  # noqa: E402
from repro_torch.benchmarks.common import full_fp32  # noqa: E402
from repro_torch.train.lenet_trainer import get_trained_lenet  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="4 roundings, smaller batches")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with full_fp32():  # train and score in fp32, not cuDNN's TF32
        trained = get_trained_lenet(device=args.device)
        info = trained[3]
        print(f"LeNet-5 on {info['source']} MNIST, {trained[0]['fc2']['w'].device}: "
              f"test accuracy {info['test_acc']:.4f}"
              + (" (cached)" if info["cached"] else
                 f" after {info['train_steps']} steps in {info['train_seconds']:.1f} s"))
        if torch.cuda.is_available() and trained[0]["fc2"]["w"].is_cuda:
            print(f"device: {torch.cuda.get_device_name(0)}")
        print("=== Table I: op counts (ours vs paper) ===")
        table1.run(quick=args.quick, trained=trained)
        print("\n=== Fig. 8: power/area/accuracy trade-off ===")
        fig8.run(quick=args.quick, trained=trained)
    return 0


if __name__ == "__main__":
    sys.exit(main())
