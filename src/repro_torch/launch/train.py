"""LM training driver of the port.

    # on the GPU (the default): qwen2-1.5b at full size, every layer GEMM's
    # forward on the paired kernel (K1), structured pairing at r = 0.05
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 6 --gemm pallas_paired --pair-rounding 0.05

    # on a (data, model) mesh of 1 × 2 ranks: tensor and sequence parallel
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --mesh 1x2 --gemm pallas_paired --pair-rounding 0.05

    # mistral-large-123b at 1 of its 88 layers on 2 × 2 ranks: FSDP (embed
    # over data, as its published config's rules say) beside tensor parallel
    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-large-123b \
        --layers 1 --mesh 2x2 --steps 3 --gemm pallas_paired

    # on the CPU, the kernels' plain versions, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --steps 2 --gemm pallas_paired --device cpu

The port of ``repro.launch.train``.  ``--mesh AxB`` trains on a mesh of
axes (data, model) under the arch's rules (``parallel.rules.arch_rules``:
its published config's, at any ``--smoke`` or ``--layers`` cut), as the
JAX CLI does: one process a rank (``launch.mesh.spawn``, over ``--backend``: gloo,
which lets the ranks share a card, or nccl, a card a rank), the batch's
rows over ``data``, heads, ff, experts and vocab over ``model`` and the
residual stream's positions too (``launch.steps.TrainStep``); every family
trains there (MLA and shared experts, SSM and hybrid layers with their meta
tokens, the encoder-decoder's encoder, the vision prefix; each rank feeds
:func:`train_extras`), and a model whose rules ask for FSDP (``embed`` over
``data``: each layer's blocks gathered over ``data`` before it runs, its
gradient reduce-scattered) trains there too, at any cut.  Each rank builds
only its own shards, from the seed, leaf by leaf, and folds
(``--paired-rounding``) and pairs (``--gemm pallas_paired``) each whole
leaf before it keeps its block.  The
log lines are rank 0's, printed when the ranks end.  Without ``--mesh`` it
trains on one device.  Checkpoints (weights and the optimizer's moments,
whole arrays: a mesh gathers its shards) are written every
``--ckpt-every`` steps; a run finding one in ``--ckpt-dir`` resumes from it
(on any mesh shape, or none: each rank slices the whole arrays) and
regenerates the token stream from the step counter (``data.tokens``), so a
killed run continues as the straight one would.  ``--paired-rounding``
folds the weights at that
rounding before training (the JAX CLI's pairing-aware finetune): the paper's
per-column pairing of each layer's ``(K, N)`` matrix,
``core.transform.fold_lm_params`` (a mesh rank: ``leaf_folder``, on each whole
leaf).  The JAX CLI folds the whole value tree
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
import dataclasses
import math
import time

import torch

from repro_torch.configs import cut_layers, get_config, get_smoke_config
from repro_torch.core.transform import fold_lm_params, leaf_folder, pair_lm_params
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.ops import paired_mode_of
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import build_train_step, held_bytes, largest_leaf_bytes
from repro_torch.models import lm as M
from repro_torch.parallel.collectives import collective_stats, reset_collectives
from repro_torch.parallel.rules import arch_rules
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


def mesh_shape(spec: str) -> tuple[int, int]:
    """``"AxB"`` → (A, B): the JAX CLI's ``--mesh``, axes (data, model)."""
    parts = tuple(int(x) for x in spec.lower().split("x"))
    if len(parts) != 2 or min(parts) < 1:
        raise ValueError(f"--mesh {spec!r}: expected AxB, axes (data, model)")
    return parts


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
    mesh: str = "",
    backend: str = "gloo",
    layers: int = 0,
    dtype: str = "",
) -> dict:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint in
    ``ckpt_dir`` if there is one), printing the JAX CLI's log lines.
    Returns the run's record: the model, the optimizer, the train step and
    its knobs, the step it started from, seconds spent pairing, every
    step's metrics (floats) and wall ms (each ends in a device-to-host copy
    of the metrics, so it includes the device work), and wall seconds; a
    mesh rank on the card built from the seed, its wiring peak beside what
    it holds after it (``launch.steps.wiring_excess``).
    ``layers`` cuts the config's depth and ``dtype`` sets its compute dtype
    (0 / "": the config's); a mesh is sharded by the arch's rules
    (``parallel.rules.arch_rules``), whatever the cut.

    With ``mesh`` (``"AxB"``) every rank of the mesh runs :func:`train_rank`
    in a process of its own; the record is rank 0's (no model, optimizer or
    step: they live in the ranks), with every rank's under ``"ranks"``."""
    kw = dict(arch=arch, smoke=smoke, steps=steps, batch=batch, seq=seq, lr=lr,
              ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, paired_rounding=paired_rounding,
              log_every=log_every, gemm=gemm, pair_rounding=pair_rounding,
              pair_block_n=pair_block_n, layers=layers, dtype=dtype)
    if not mesh:
        return _train(None, device=device, emit=print, **kw)
    ranks = spawn(train_rank, mesh_shape(mesh), backend=backend,
                  device="cpu" if device == "cpu" else "cuda", kwargs=kw, timeout=math.inf)
    for line in ranks[0].pop("lines"):
        print(line)
    return {**ranks[0], "ranks": ranks}


def train_rank(mesh, **kw) -> dict:
    """One rank of a mesh training run (:func:`train`'s ``mesh``): the
    rank's record, its log lines (rank 0's) under ``"lines"``, beside every
    step's collectives (``parallel.collectives``' counter) and K1 launches
    (CUDA tensors only), its wiring seconds and its peak device memory."""
    lines: list[str] = []
    rec = _train(mesh, device=None, emit=lines.append if mesh.rank == 0 else lambda _: None,
                 **kw)
    return {k: v for k, v in rec.items() if k not in ("model", "opt_state", "step")} | {
        "lines": lines, "rank": mesh.rank, "coords": mesh.coords}


def _train(mesh, *, arch, smoke, steps, batch, seq, lr, ckpt_dir, ckpt_every, paired_rounding,
           log_every, gemm, pair_rounding, pair_block_n, device, layers, dtype,
           emit) -> dict:
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers:
        cfg = cut_layers(cfg, layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)  # another job's, in the same process
    # the weights from seed 0: a mesh rank builds only its blocks, folding
    # each whole leaf before it keeps its block
    model = M.init_lm(cfg, 0, device=dev) if mesh is None else 0
    fold, folded = None, None
    if paired_rounding > 0 and mesh is None:
        model, folded = fold_lm_params(model, paired_rounding)
    elif paired_rounding > 0:
        fold, folded = leaf_folder(paired_rounding)
    knobs = M.PerfKnobs(q_chunk=min(1024, seq), gemm=gemm, pair_rounding=pair_rounding,
                        pair_block_n=pair_block_n)
    rules = arch_rules(arch, "train", mesh) if mesh is not None else None
    step_fn = build_train_step(
        cfg, adamw(cosine_schedule(lr, steps, warmup_steps=min(100, steps // 10))), knobs,
        mesh=mesh, rules=rules)
    pairing_s, wiring, wire = 0.0, {}, {}
    rp = None
    if mesh is not None:
        cell = step_fn.shard(model, fold=fold)
        model, rp, wiring = cell.model, cell.pair_report, cell.seconds
        pairing_s = wiring.get("pair", 0.0)
        if dev.type == "cuda":  # built from the seed, leaf by leaf
            wire = {"wire_peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                    "held_bytes": held_bytes(model), "leaf_bytes": largest_leaf_bytes(cfg)}
    if folded is not None:
        emit(f"[train] paired {folded.total_pairs} weight pairs "
             f"({100 * folded.pair_fraction:.1f}% of weights) "
             f"→ modeled savings {folded.savings()}")
    if mesh is None and gemm == "pallas_paired":
        mode, block_n = paired_mode_of(knobs)
        t0 = time.perf_counter()
        model, rp = pair_lm_params(model, pair_rounding, mode=mode, block_n=block_n)
        pairing_s = time.perf_counter() - t0
    if rp is not None:
        block_n = paired_mode_of(knobs)[1]
        emit(f"[train] paired-kernel GEMMs ({rp.mode}"
             f"{f', block_n={block_n}' if block_n else ''}, rounding {pair_rounding}): "
             f"{rp.total_pairs} per-column-equivalent pairs across {len(rp.leaves)} "
             f"decoder weights ({100 * rp.pair_fraction:.1f}%); paired in {pairing_s:.1f} s")
    opt_state = step_fn.init(model)
    params = dict(model.named_parameters())
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start = restore_train_state(ckpt_dir, params, opt_state,
                                    take=None if mesh is None else step_fn.take(model))
        emit(f"[train] resumed from step {start}")

    # the global batch: a mesh's step takes its rank's rows
    data = token_batches(batch, seq, cfg.vocab, seed=1, start_step=start)
    extras = train_extras(cfg, batch, dev)
    history: list[dict[str, float]] = []
    step_ms: list[float] = []
    collectives: list[dict] = []
    k1: list[int] = []
    t0 = time.time()
    for i in range(start, steps):
        tok, lab = next(data)
        b = {"tokens": torch.as_tensor(tok, dtype=torch.int64, device=dev),
             "labels": torch.as_tensor(lab, dtype=torch.int64, device=dev), **extras}
        reset_collectives()
        before = pm.launch_count()
        t_step = time.perf_counter()
        metrics = {k: float(v) for k, v in step_fn(model, opt_state, i, b).items()}
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        k1.append(pm.launch_count() - before)
        collectives.append(collective_stats())
        history.append(metrics)
        if log_every and (i + 1) % log_every == 0:
            emit(f"[train] step {i + 1} loss {metrics['loss']:.4f} xent {metrics['xent']:.4f} "
                 f"({(i + 1 - start) / (time.time() - t0):.2f} it/s)")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, i + 1, params, opt_state,
                             whole=None if mesh is None else step_fn.whole(model),
                             write=mesh is None or mesh.rank == 0)
    seconds = time.time() - t0
    final = f", final loss {history[-1]['loss']:.4f}" if history else ""
    emit(f"[train] done: {steps - start} steps in {seconds:.1f}s{final}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"cfg": cfg, "model": model, "opt_state": opt_state, "step": step_fn,
            "knobs": knobs, "start": start, "pairing_s": pairing_s, "history": history,
            "step_ms": step_ms, "seconds": seconds, "collectives": collectives,
            "k1_launches": k1, "wiring_s": wiring, "peak_bytes": peak, **wire}


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
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 → axes (data, model): one process a rank, tensor, "
                         "sequence and data parallel")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the mesh's collectives: gloo (ranks may share a card, or run on "
                         "the CPU) or nccl (a card a rank)")
    train(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
