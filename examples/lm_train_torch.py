"""End-to-end driver of the PyTorch port: train a ~100M-parameter
qwen2-family model for a few hundred steps on the deterministic token
stream.  The loss must fall well below log(vocab): the stream has learnable
bigram structure.

The port of ``examples/lm_train.py``, on one device and the port's train
step (``repro_torch.launch.steps.build_train_step``); ``--gemm pallas`` or
``pallas_paired`` runs every layer GEMM's forward on the paired kernel (K1).

Run:  PYTHONPATH=src python examples/lm_train_torch.py [--steps 300] [--gemm pallas]
      (on the CPU add --device cpu and fewer --steps)
"""
import argparse
import math
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.transform import pair_lm_params
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as M
from repro_torch.train.optimizer import adamw, cosine_schedule


def config_100m() -> ModelConfig:
    """~100M params, qwen2 family (GQA + QKV bias, tied embeddings)."""
    return ModelConfig(
        name="qwen2-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=2,
        d_ff=2048, vocab=8192, qkv_bias=True, tie_embeddings=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--gemm", choices=M.GEMMS, default="xla")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cfg = config_100m()
    dev = resolve_device(args.device)
    print(f"[lm_train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {dev}")
    model = M.init_lm(cfg, 0, device=dev)
    if args.gemm == "pallas_paired":
        model, _ = pair_lm_params(model, 0.0)
    knobs = M.PerfKnobs(q_chunk=min(256, args.seq), k_chunk=min(256, args.seq), gemm=args.gemm)
    step = build_train_step(cfg, adamw(cosine_schedule(3e-4, args.steps, warmup_steps=20)), knobs)
    opt_state = step.init(model)

    data = token_batches(args.batch, args.seq, cfg.vocab, seed=7)
    t0, first_loss, loss = time.time(), None, float("nan")
    for i in range(args.steps):
        tok, lab = (torch.as_tensor(a, dtype=torch.int64, device=dev) for a in next(data))
        loss = float(step(model, opt_state, i, {"tokens": tok, "labels": lab})["loss"])
        first_loss = first_loss or loss
        if (i + 1) % 25 == 0:
            tps = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i + 1:4d}  loss {loss:.4f}  ({tps:,.0f} tok/s)")
    print(f"[lm_train] loss {first_loss:.3f} → {loss:.3f} "
          f"(uniform would be {math.log(cfg.vocab):.3f}); "
          f"{'LEARNED' if loss < first_loss - 0.5 else 'check hyperparams'}")


if __name__ == "__main__":
    main()
