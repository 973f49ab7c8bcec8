"""LM training driver of the port.

    # on the GPU (the default): qwen2-1.5b at full size, every layer GEMM's
    # forward on the paired kernel (K1), structured pairing at r = 0.05
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 6 --gemm pallas_paired --pair-rounding 0.05

    # on the CPU, the kernels' plain versions, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --steps 2 --gemm pallas_paired --device cpu

The port of ``repro.launch.train`` on one device: ``--mesh`` is dropped,
since tensor and data parallelism are not ported.  Checkpoints (weights and
the optimizer's moments) are written every ``--ckpt-every`` steps; a run
finding one in ``--ckpt-dir`` resumes from it and regenerates the token
stream from the step counter (``data.tokens``), so a killed run continues
as the straight one would.  ``--paired-rounding`` folds the weights at that
rounding before training (the JAX CLI's pairing-aware finetune): the paper's
per-column pairing of each layer's ``(K, N)`` matrix,
``core.transform.fold_lm_params``.  The JAX CLI folds the whole value tree
through ``pair_model_params``, which on an LM tree pairs the wrong axes: the
port departs from it there on purpose.
Beyond the JAX CLI: ``--gemm`` picks the layer GEMMs' route (``xla``:
``torch.matmul``; ``pallas``: K1's dense form; ``pallas_paired``: K1's
paired forms on metadata built by ``pair_lm_params`` at ``--pair-rounding``
and ``--pair-block-n``, as the serving engine builds it), the knobs the JAX
package's train step already takes; without it the CLI reaches no kernel.
Weights are random from seed 0 (``models.lm.init_lm``), fp32 masters,
computed in the config's dtype.  A vision-language model trains on zero
patches and an encoder-decoder model on zero frames, as the JAX CLI does
(:func:`train_extras`).  Every family trains under every ``--gemm``: an MoE
layer's experts run on K1's expert grid under ``pallas_paired``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.transform import fold_lm_params, pair_lm_params
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import paired_mode_of
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as M
from repro_torch.train.checkpoint import latest_step, restore_train_state, save_train_state
from repro_torch.train.optimizer import adamw, cosine_schedule


def train_extras(cfg, batch: int, device) -> dict[str, torch.Tensor]:
    """What the JAX CLI feeds beside the tokens: zero ``patches`` (batch,
    vision_prefix, vision_embed_dim) for a vision-language model, zero
    ``frames`` (batch, encoder frames, d_model) for an encoder-decoder one,
    in the config's dtype."""
    cdt = M.compute_dtype(cfg)
    extras = {}
    if cfg.vision_prefix:
        extras["patches"] = torch.zeros((batch, cfg.vision_prefix, cfg.vision_embed_dim),
                                        dtype=cdt, device=device)
    if cfg.encoder is not None:
        extras["frames"] = torch.zeros((batch, cfg.encoder.frames, cfg.d_model), dtype=cdt,
                                       device=device)
    return extras


def train(
    *,
    arch: str,
    smoke: bool = False,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: str = "",
    ckpt_every: int = 50,
    paired_rounding: float = 0.0,
    log_every: int = 10,
    gemm: str = "xla",
    pair_rounding: float = 0.0,
    pair_block_n: int = 0,
    device: str | None = None,
) -> dict:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint in
    ``ckpt_dir`` if there is one), printing the JAX CLI's log lines.
    Returns the run's record: the model, the optimizer, the train step and
    its knobs, the step it started from, seconds spent pairing, every
    step's metrics (floats) and wall ms (each ends in a device-to-host copy
    of the metrics, so it includes the device work), and wall seconds."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    model = M.init_lm(cfg, 0, device=dev)
    if paired_rounding > 0:
        model, report = fold_lm_params(model, paired_rounding)
        print(f"[train] paired {report.total_pairs} weight pairs "
              f"({100 * report.pair_fraction:.1f}% of weights) "
              f"→ modeled savings {report.savings()}")
    knobs = M.PerfKnobs(q_chunk=min(1024, seq), gemm=gemm, pair_rounding=pair_rounding,
                        pair_block_n=pair_block_n)
    pairing_s = 0.0
    if gemm == "pallas_paired":
        mode, block_n = paired_mode_of(knobs)
        t0 = time.perf_counter()
        model, rp = pair_lm_params(model, pair_rounding, mode=mode, block_n=block_n)
        pairing_s = time.perf_counter() - t0
        print(f"[train] paired-kernel GEMMs ({rp.mode}"
              f"{f', block_n={block_n}' if block_n else ''}, rounding {pair_rounding}): "
              f"{rp.total_pairs} per-column-equivalent pairs across {len(rp.leaves)} "
              f"decoder weights ({100 * rp.pair_fraction:.1f}%); paired in {pairing_s:.1f} s")

    step_fn = build_train_step(
        cfg, adamw(cosine_schedule(lr, steps, warmup_steps=min(100, steps // 10))), knobs)
    opt_state = step_fn.init(model)
    params = dict(model.named_parameters())
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start = restore_train_state(ckpt_dir, params, opt_state)
        print(f"[train] resumed from step {start}")

    data = token_batches(batch, seq, cfg.vocab, seed=1, start_step=start)
    extras = train_extras(cfg, batch, dev)
    history: list[dict[str, float]] = []
    step_ms: list[float] = []
    t0 = time.time()
    for i in range(start, steps):
        tok, lab = next(data)
        b = {"tokens": torch.as_tensor(tok, dtype=torch.int64, device=dev),
             "labels": torch.as_tensor(lab, dtype=torch.int64, device=dev), **extras}
        t_step = time.perf_counter()
        metrics = {k: float(v) for k, v in step_fn(model, opt_state, i, b).items()}
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        history.append(metrics)
        if log_every and (i + 1) % log_every == 0:
            print(f"[train] step {i + 1} loss {metrics['loss']:.4f} xent {metrics['xent']:.4f} "
                  f"({(i + 1 - start) / (time.time() - t0):.2f} it/s)")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, i + 1, params, opt_state)
    seconds = time.time() - t0
    final = f", final loss {history[-1]['loss']:.4f}" if history else ""
    print(f"[train] done: {steps - start} steps in {seconds:.1f}s{final}")
    return {"cfg": cfg, "model": model, "opt_state": opt_state, "step": step_fn,
            "knobs": knobs, "start": start, "pairing_s": pairing_s, "history": history,
            "step_ms": step_ms, "seconds": seconds}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--paired-rounding", type=float, default=0.0,
                    help="fold the weights at this rounding before training "
                         "(per-column pairing of each decoder weight matrix)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--gemm", choices=M.GEMMS, default="xla",
                    help="xla: torch.matmul; pallas: K1's dense form; pallas_paired: "
                         "K1's paired forms on the weights' pairing metadata")
    ap.add_argument("--pair-rounding", type=float, default=0.0,
                    help="rounding size of the pallas_paired pairing metadata")
    ap.add_argument("--pair-block-n", type=int, default=0,
                    help="0 → structured pairing; n >= 1 → column-blocked, one pairing "
                         "per n output columns (1 == per-column)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU ('cpu' runs the kernels' "
                         "plain versions)")
    train(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
