"""Mesh training: one rank's train steps, held to the single-rank step.

The training mesh's phase harness (``launch.steps.build_train_step`` with a
``mesh``; the train CLI's ``--mesh``), beside ``mesh_decode.py``.  Each rank
of a ``launch.mesh.spawn`` runs :func:`train_many`: for each job,
:func:`train_job` builds the model from the same weights on every rank,
takes its shards (paired per shard under ``gemm="pallas_paired"``), runs
AdamW steps on the global batches given, and returns its losses, its
collectives and K1 launches a step, its layout and, where asked, its
gradients and weights (gathered whole, or held to a reference saved by the
caller, shard by shard), and its step against the fold oracle (the same
mesh step under ``gemm="xla"`` on the rank's weights folded through its own
pairing metadata).  :func:`partial_sum_check` holds a bf16 row-parallel
partial sum under autograd to the serving path's.  The tests and
``chip_smoke.py`` spawn them.

    # every family's smoke config on a (2, 2) mesh of gloo ranks on the
    # CPU, fp32, held to the single-rank step (the GPU without --device)
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_train --mesh 2,2 --device cpu
    # FSDP: mistral-large-123b (embed over data, as its published config's
    # rules say), the smoke config on the CPU; on the card at full width, 1 layer
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_train --mesh 2,2 \
        --arch mistral-large-123b --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_train --mesh 2,2 \
        --arch mistral-large-123b --layers 1 --seq 128 --batch 8
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import os
import time

import numpy as np
import torch

from repro_torch.analysis import counting, mesh_train_collectives, train_launches
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import paired_matmul as pm
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.steps import build_train_step, held_bytes, largest_leaf_bytes
from repro_torch.models import layers as Lyr
from repro_torch.models import lm as M
from repro_torch.parallel.collectives import all_reduce, collective_stats, reset_collectives
from repro_torch.parallel.sharding import Mesh
from repro_torch.train.optimizer import adamw, sgd

RTOL, ATOL = 1e-4, 1e-5  # losses, gradients and weights, fp32 (the train parity gates)
# AdamW's first step moves a weight by lr·g/(|g| + eps): where |g| is near eps
# it magnifies the gradients' summation-order noise by lr / (4·eps), so the
# parity steps take eps 1e-6 (at the default 1e-8 and lr 1e-3, 1e-9 of noise
# moves a weight by 2.5e-5, past the gate)
PARITY_LR, PARITY_EPS = 1e-4, 1e-6


def knobs_for(rounding: float = 0.0, gemm: str = "pallas_paired", **kw) -> M.PerfKnobs:
    return M.PerfKnobs(q_chunk=16, k_chunk=16, gemm=gemm, pair_rounding=rounding, **kw)


def violation(got, want) -> float:
    """max(|got − want| − (ATOL + RTOL·|want|)): ≤ 0 where every element is
    within the gates; inf where either holds a NaN (so a NaN fails a gate,
    and a Python ``max`` over violations cannot drop it)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    excess = np.abs(got - want) - (ATOL + RTOL * np.abs(want))
    return float(np.max(np.where(np.isnan(excess), np.inf, excess)))


def batch_dict(cfg, item, device) -> dict:
    """A global batch ``(tokens, labels)`` or ``(tokens, labels, extras)``
    (numpy; ``extras`` an encoder-decoder model's ``frames`` or a
    vision-language model's ``patches``) as the step's tensors on
    ``device``, the extras in the compute dtype."""
    tokens, labels, *rest = item
    cdt = M.compute_dtype(cfg)
    return {"tokens": torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=device),
            "labels": torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device),
            **{k: torch.as_tensor(np.asarray(v), device=device).to(cdt)
               for k, v in (rest[0] if rest else {}).items()}}


def fold_model(local: M.LM, knobs: M.PerfKnobs) -> M.LM:
    """A copy of the rank's paired model whose paired weights are folded
    through their own metadata (``ops.fold_lm_weight`` of each layer's
    (K, N) view, ``fold_lm_expert_weight`` of an expert stack), the dense
    weights the paired kernel computes with."""
    folded = copy.deepcopy(local)
    with torch.no_grad():
        for block in folded.modules():
            for name, meta in getattr(block, "pairing", {}).items():
                w = getattr(block, name)
                if isinstance(block, Lyr.MoE) and w.ndim == 3:
                    w.copy_(ops.fold_lm_expert_weight(w, meta, knobs.pair_block_n))
                else:
                    w.copy_(ops.fold_lm_weight(block.matrix(name, w.dtype), meta,
                                               knobs.pair_block_n).reshape(w.shape))
            if hasattr(block, "pairing"):
                block.pairing = {}
    return folded


def _unfold_grads(local: M.LM, folded: M.LM, knobs: M.PerfKnobs) -> dict[str, torch.Tensor]:
    """The folded model's gradients carried back to the live weights
    through each paired weight's fold (its VJP): what the paired step's
    backward computes."""
    out = {}
    for (name, p), (_, q) in zip(local.named_parameters(), folded.named_parameters(),
                                 strict=True):
        out[name] = q.grad
    for prefix, block in local.named_modules():
        for name, meta in getattr(block, "pairing", {}).items():
            w = getattr(block, name).detach().requires_grad_(True)
            full = f"{prefix}.{name}" if prefix else name
            with torch.enable_grad():
                if isinstance(block, Lyr.MoE) and w.ndim == 3:
                    f = ops.fold_lm_expert_weight(w, meta, knobs.pair_block_n)
                else:
                    w2 = w.reshape(-1, w.shape[-1]) if name == "wo" else w.reshape(w.shape[0], -1)
                    f = ops.fold_lm_weight(w2, meta, knobs.pair_block_n).reshape(w.shape)
                (out[full],) = torch.autograd.grad(f, w, out[full])
    return out


def _held_to(step_fn, local: M.LM, got: dict, want: dict) -> float:
    """The largest :func:`violation` of the rank's tensors ``got`` (by
    parameter name) against its blocks of the whole ``want``, computed on
    the rank's device in fp32, a tensor at a time (a NaN: inf)."""
    take = step_fn.take(local)
    worst = -np.inf
    for n, g in got.items():
        g = g.detach()
        w = take(n, want[n]).to(device=g.device, dtype=torch.float32)
        excess = (g.float() - w).abs() - (ATOL + RTOL * w.abs())
        worst = max(worst, float(torch.nan_to_num(excess, nan=np.inf).max()))
    return worst


def _wait_for(path: str, timeout: float = 900.0) -> None:
    """Return once ``path`` exists (another process makes it)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout:.0f} s")
        time.sleep(0.2)


def train_job(mesh: Mesh, cfg, weights, knobs: M.PerfKnobs, batches: list, *,
              lr: float = 1e-4, eps: float = 1e-8, grad_clip: float | None = 1.0,
              gather: bool = False, rules=None, start_after: str | None = None,
              want: str | None = None, fold_oracle: bool = False) -> dict:
    """One rank's steps of ``cfg`` under ``knobs`` on ``mesh`` (under
    ``rules``: ``rules_for(cfg, "train", mesh)`` unless given): the rank's
    part of the model ``weights`` names (the JAX package's value tree of
    numpy arrays, or an ``init_lm`` seed; the same on every rank), built
    leaf by leaf (``TrainStep.shard``), one AdamW step (``lr``, ``eps``,
    ``grad_clip``) on each of ``batches`` (global batches of
    :func:`batch_dict`'s: numpy tokens and labels, and the model's frames
    or patches).  ``start_after``: a file to wait for once the rank's blocks
    are built, before its steps (the caller makes it when the card is free
    for them).

    Returns every step's metrics, collectives (by kind, calls and bytes)
    and K1 launches (calls of its wrappers on the CPU) against what
    ``analysis`` says; the norm the optimizer clipped by in the first step;
    the rank's layout (its ``TensorParallel`` flags, and each weight's,
    gradient's and moments' shape beside its spec); its wiring seconds and
    pairing report; on the card its wiring peak (``wire_peak_bytes``)
    beside what it holds after it and its largest whole leaf's bytes
    (``launch.steps.wiring_excess``), its peak over the steps; each step's
    ms.  ``gather``: the first step's gradients and the weights
    after the last step, gathered whole (numpy, by name).  ``want``: a file
    (``torch.save``) of the single-rank ``{"loss", "xent", "aux", "grads"}``
    (and ``"params"``, the weights after it) of one step on ``batches[0]``,
    each tensor held to the rank's block of it (the largest
    :func:`violation` of each; read through a memory map, once the first
    step is done: the caller may still be writing it, and it appears whole,
    by a rename).
    ``fold_oracle``: first, the same mesh step under ``gemm="xla"`` on the
    rank's folded weights (:func:`fold_model`), its loss and its gradients
    carried back through the fold, held to the paired step's."""
    dev = mesh.device
    step_fn = build_train_step(cfg, adamw(lr, eps=eps, grad_clip=grad_clip), knobs, mesh, rules)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    cell = step_fn.shard(weights)
    wire_s = time.perf_counter() - t0
    local = cell.model
    rec: dict = {"rank": mesh.rank, "coords": dict(mesh.coords), "wire_s": wire_s,
                 "wiring": cell.seconds, "held_bytes": held_bytes(local),
                 "leaf_bytes": largest_leaf_bytes(cfg)}
    if dev.type == "cuda":
        rec["wire_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
    if start_after:
        _wait_for(start_after)
    b0 = batch_dict(cfg, batches[0], dev)
    if fold_oracle:
        folded = fold_model(local, knobs)
        x_step = build_train_step(cfg, sgd(0.0), dataclasses.replace(knobs, gemm="xla"), mesh,
                                  step_fn.rules)
        x_opt = x_step.init(folded)
        rec["oracle"] = {k: float(v) for k, v in x_step(folded, x_opt, 0, b0).items()}
        oracle_grads = _unfold_grads(local, folded, knobs)
        del folded, x_opt
    opt = step_fn.init(local)
    metrics, colls, k1, step_ms = [], [], [], []
    for i, item in enumerate(batches):
        b = b0 if i == 0 else batch_dict(cfg, item, dev)
        reset_collectives()
        t = time.perf_counter()
        with counting() as c:
            before = pm.launch_count()
            m = {k: float(v) for k, v in step_fn(local, opt, i, b).items()}
        step_ms.append((time.perf_counter() - t) * 1e3)  # the metrics' read synchronises
        k1.append(pm.launch_count() - before if dev.type == "cuda" else c["k1_calls"])
        colls.append(collective_stats())
        metrics.append(m)
        if i == 0:
            grads = {n: p.grad for n, p in local.named_parameters()}
            rec["clip_norm"] = None if opt.last_norm is None else float(opt.last_norm)
            if gather:
                gw = step_fn.whole(local)
                rec["grads"] = {n: gw(n, g).cpu().numpy() for n, g in grads.items()}
            if want:
                t_check = time.perf_counter()
                _wait_for(want)
                want_rec = torch.load(want, map_location="cpu", mmap=True)
                rec["grad_violation"] = _held_to(step_fn, local, grads, want_rec["grads"])
                if "params" in want_rec:
                    rec["params_violation"] = _held_to(step_fn, local,
                                                       dict(local.named_parameters()),
                                                       want_rec["params"])
                rec["loss_violation"] = max(violation(m[k], want_rec[k])
                                            for k in ("loss", "xent", "aux"))
                rec["check_s"] = time.perf_counter() - t_check
            if fold_oracle:
                rec["oracle_loss_violation"] = violation(m["loss"], rec["oracle"]["loss"])
                rec["oracle_grad_violation"] = max(
                    violation(grads[n].detach().cpu(), oracle_grads[n].detach().cpu())
                    for n in grads)
    B, S = np.asarray(batches[0][0]).shape
    rec.update(metrics=metrics, collectives=colls, k1=k1, step_ms=step_ms,
               want_collectives=mesh_train_collectives(cfg, knobs, mesh, B, S,
                                                       clip=grad_clip is not None,
                                                       rules=step_fn.rules),
               want_k1=train_launches(cfg, knobs))
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    if gather:
        gw = step_fn.whole(local)
        rec["params"] = {n: gw(n, p).cpu().numpy() for n, p in local.named_parameters()}
    tp = step_fn.layout(B, S)
    specs = step_fn.param_specs(local)
    rec["tp"] = {k: getattr(tp, k) for k in ("vocab_split", "q_split", "kv_split", "ff_split",
                                             "experts_split", "router_split", "batch_split",
                                             "seq_split")}
    rec["fsdp_axes"], rec["top_gathers"] = tp.fsdp_axes, tp.top_gathers
    rec["tp_segments"] = [dict(splits) for _, splits in tp.segment_splits]
    rec["tp_encoder"] = None if tp.encoder_splits is None else dict(tp.encoder_splits)
    rec["shapes"] = {n: {"param": tuple(p.shape), "grad": tuple(p.grad.shape),
                         "moments": [tuple(v.shape) for v in opt.state[p].values()],
                         "spec": tuple(specs[n])}
                     for n, p in local.named_parameters()}
    rec["pair_report"] = None if cell.pair_report is None else {
        "total_pairs": int(cell.pair_report.total_pairs),
        "pair_fraction": float(cell.pair_report.pair_fraction)}
    del local, opt, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def partial_sum_check(mesh: Mesh, cfg, seed: int, batch: int, seq: int) -> dict:
    """A bf16 row-parallel partial sum under autograd against the serving
    path's: layer 0's ``wo`` on the rank's shard (paired at r = 0), over
    random bf16 activations of its heads (seeded by its rank), closed by the
    training layout (reduce-scattered to its positions, the gradient
    tracked) and by the serving one (all-reduced, frozen, forward only).
    Returns both closed outputs' largest error against the fp32 oracle (the
    same product in fp32, all-reduced), on the rank's positions, and
    whether they are the same bits."""
    dev = mesh.device
    knobs = knobs_for(0.0)
    step_fn = build_train_step(cfg, adamw(1e-3), knobs, mesh)
    local = step_fn.shard(seed).model
    local.requires_grad_(True)
    tp = step_fn.layout(batch, seq).layer(0)
    attn = local.layers[0].attn
    gen = torch.Generator(device="cpu").manual_seed(1000 + mesh.rank)
    k = attn.wo.shape[0] * attn.wo.shape[1]
    x = torch.randn(batch, seq, k, generator=gen).to(device=dev, dtype=M.compute_dtype(cfg))
    xt = x.clone().requires_grad_(True)
    y_train = Lyr.row_parallel_dense(attn, "wo", xt, knobs, tp)
    serve_tp = dataclasses.replace(tp, train=False, seq_split=False)
    with torch.no_grad():
        y_serve = Lyr.row_parallel_dense(local.layers[0].attn.copy(frozen=True), "wo", x, knobs,
                                         serve_tp)
        oracle = all_reduce(torch.matmul(x.float(), attn.matrix("wo", torch.float32)),
                            tp.model_group)
    own = slice(tp.r * (seq // tp.n), (tp.r + 1) * (seq // tp.n)) if tp.seq_split else slice(None)
    y_serve, oracle = y_serve[:, own], oracle[:, own]
    err = lambda y: float((y.float() - oracle).abs().max())
    return {"rank": mesh.rank, "train_err": err(y_train.detach()), "serve_err": err(y_serve),
            "same_bits": bool(torch.equal(y_train.detach(), y_serve)),
            "requires_grad": bool(y_train.requires_grad), "seq_split": tp.seq_split}


def train_many(mesh: Mesh, jobs: dict) -> dict:
    """Each job ``name → (fn name, args, kwargs)`` on this rank, in order:
    ``fn`` one of :func:`train_job`, :func:`partial_sum_check`, the train
    CLI's ``launch.train.train_rank`` and ``mesh_decode.serve_rank`` (a
    serving job beside the training ones).  Each record gains ``job_s``,
    the rank's wall seconds for that job."""
    from repro_torch.benchmarks.mesh_decode import serve_rank
    from repro_torch.launch.train import train_rank

    fns = {"train_job": train_job, "partial_sum_check": partial_sum_check,
           "train_rank": train_rank, "serve_rank": serve_rank}
    out = {}
    for name, (fn, args, kwargs) in jobs.items():
        t0 = time.perf_counter()
        out[name] = fns[fn](mesh, *args, **kwargs)
        out[name]["job_s"] = time.perf_counter() - t0
    return out


def smoke_batches(cfg, batch: int, seq: int, n: int, seed: int = 5) -> list:
    """``n`` global batches of seeded random tokens and labels, a few labels
    masked (-1), and, for a model that takes them, seeded random frames or
    patches (``launch.inputs.make_batch``'s stubs, numpy fp32, seed ``seed +
    i`` for batch ``i``): ``(tokens, labels)`` or ``(tokens, labels,
    extras)``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tok = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int64)
        lab = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int64)
        lab[0, 1] = lab[-1, -1] = -1
        stub = make_batch(cfg, batch, seq, "train", seed + i, device="cpu")
        extras = {k: stub[k].float().numpy() for k in M.EXTRAS if k in stub}
        out.append((tok, lab, extras) if extras else (tok, lab))
    return out


def run(mesh_shape=(1, 2), *, device: str | None = None, backend: str = "gloo",
        arch: str = "qwen2-1.5b", batch: int = 4, seq: int = 16, steps: int = 2,
        layers: int = 0) -> dict:
    """The ``arch`` smoke config in fp32 on ``mesh_shape``: every rank's
    ``steps`` AdamW steps (``gemm="pallas_paired"``, r = 0) against the
    single-rank step's losses and updated weights, and its collectives and
    K1 launches a step against ``analysis``; raises on a failed gate.
    ``layers``: the published config at full width cut to that depth
    instead, the losses held (not the weights: they are not gathered whole
    at that size).  Either cut is sharded by the arch's rules
    (``parallel.rules.arch_rules``: mistral-large-123b's FSDP).  Each rank
    builds only its own blocks; its wiring seconds, wiring peak, held bytes
    and peak are returned."""
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.rules import arch_rules

    cfg = dataclasses.replace(cut_layers(get_config(arch), layers) if layers
                              else get_smoke_config(arch), dtype="float32")
    rules = arch_rules(arch, "train", Mesh(dict(zip(("data", "model"), mesh_shape,
                                                    strict=True))))
    dev = resolve_device(device)
    batches = smoke_batches(cfg, batch, seq, steps)
    ref = M.init_lm(cfg, 0, device=dev)
    ref_step = build_train_step(cfg, adamw(PARITY_LR, eps=PARITY_EPS),
                                knobs_for(0.0, gemm="xla"))
    opt = ref_step.init(ref)
    losses = [float(ref_step(ref, opt, i, batch_dict(cfg, b, dev))["loss"])
              for i, b in enumerate(batches)]
    # at full width the weights stay on the ranks (the losses are held)
    want_params = ({} if layers else
                   {n: p.detach().cpu().numpy() for n, p in ref.named_parameters()})
    del ref, opt, ref_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the card's memory for the ranks
    t0 = time.perf_counter()
    ranks = spawn(train_many, mesh_shape, backend=backend, device=dev.type,
                  args=({"job": ("train_job", (cfg, 0, knobs_for(0.0), batches),
                                 {"gather": not layers, "lr": PARITY_LR, "eps": PARITY_EPS,
                                  "rules": rules})},))
    run_s = time.perf_counter() - t0
    failures = []
    for r in ranks:
        rec = r["job"]
        got = [m["loss"] for m in rec["metrics"]]
        if violation(got, losses) > 0:
            failures.append(f"rank {rec['rank']}: losses {got} vs the single rank's {losses}")
        worst = max((violation(rec["params"][n], want_params[n]) for n in want_params),
                    default=-np.inf)
        if worst > 0:
            failures.append(f"rank {rec['rank']}: weights after {steps} steps off by {worst:.3g}")
        calls = [{k: v["calls"] for k, v in c.items()} for c in rec["collectives"]]
        want = {k: v["calls"] for k, v in rec["want_collectives"].items()}
        if any(c != want for c in calls) or any(k != rec["want_k1"] for k in rec["k1"]):
            failures.append(f"rank {rec['rank']}: collectives {calls} / K1 {rec['k1']} vs "
                            f"{want} / {rec['want_k1']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"mesh": list(mesh_shape), "arch": arch, "layers": cfg.n_layers, "losses": losses,
            "spawn_and_run_s": run_s,
            "ranks": [{k: r["job"].get(k) for k in ("rank", "wire_s", "wire_peak_bytes",
                                                     "held_bytes", "peak_bytes", "step_ms")}
                      for r in ranks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1,2", help="data,model ranks")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="the GPU unless cpu is asked for")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--arch", default="", help="one arch (default: seven, one a family)")
    ap.add_argument("--layers", type=int, default=0,
                    help="the published config at full width, cut to this depth (0: smoke)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    a = ap.parse_args(argv)
    shape = tuple(int(x) for x in a.mesh.split(","))
    archs = (a.arch,) if a.arch else ("qwen2-1.5b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                                      "mamba2-2.7b", "hymba-1.5b", "whisper-base",
                                      "internvl2-2b")
    for arch in archs:
        out = run(shape, device=a.device, backend=a.backend, arch=arch, layers=a.layers,
                  batch=a.batch, seq=a.seq)
        print(f"[mesh_train] {arch} on mesh {shape}: losses {out['losses']} held on every "
              f"rank; {out['spawn_and_run_s']:.1f} s")
        for r in out["ranks"]:
            print(f"[mesh_train]   rank {r['rank']}: wired in {r['wire_s']:.2f} s, holds "
                  f"{r['held_bytes'] / 1e9:.3f} GB, wiring peak "
                  f"{(r['wire_peak_bytes'] or 0) / 1e9:.3f} GB, step peak "
                  f"{(r['peak_bytes'] or 0) / 1e9:.3f} GB (0: not on a card)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
