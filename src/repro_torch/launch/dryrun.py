"""Multi-pod dry run: what one rank of a production mesh holds and costs,
with no card.

The port of ``repro.launch.dryrun``.  For every (architecture × input shape
× mesh) cell it wires one rank's real step (``launch.steps.wire_cell``: the
training step for train shapes, the prefill step for prefill, the decode
step for decode) on rank 0 of the (16, 16) or (2, 16, 16) production mesh
(``launch.mesh.make_production_mesh`` over a fake process group of 256 or
512 ranks), runs it once on fake tensors (nothing is allocated, no kernel is
built or launched, every collective returns at once) and records, per
rank, what ``parallel.cost`` reads from that run:

* ``memory``      — the arguments' bytes (the rank's shards, optimizer
  state, cache and batch block) and the peak of the live bytes while the
  step runs (proves the cell fits a card's 80 GB);
* ``cost``        — FLOPs and HBM bytes (roofline terms 1 and 2);
* ``collectives`` — calls, bytes and ring-factor wire bytes by kind
  (roofline term 3);
* ``sharding_fallbacks`` — every replication fallback the specs took;
* ``model``       — 6·N·D (train) or 2·N·D FLOPs a rank and their share of
  the traced FLOPs.

The JAX record's ``analysis`` (the HLO lint of ``repro.analysis``) has no
counterpart: the port has no compiled program to lint.  ``--attn-fused``
accounts the blocked attention's interior as the flash-attention kernel
(K3) keeps it on chip: the bytes of ``models.layers.flash_attention``'s ops
are dropped and the kernel's boundary traffic is added from the shapes
(:func:`fused_attention_hbm_bytes`); the mesh steps themselves run the
plain attention, as the JAX mesh paths do.

The fake tensors live on ``cuda`` where this PyTorch is built with CUDA,
else on the CPU (``--device`` picks; autograd on a fake CUDA tensor needs
the CUDA build), which changes no count: only the peak's rounding to the
caching allocator's blocks.  Records go to ``benchmarks/results/torch_dryrun/``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import SHAPES, supports_shape
from repro_torch.core.cost_model import model_flops_decode, model_flops_train
from repro_torch.launch.inputs import batch_specs
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.steps import wire_cell
from repro_torch.models.lm import PerfKnobs
from repro_torch.parallel.cost import top_contributors
from repro_torch.parallel.sharding import record_spec_fallbacks

RESULTS_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / "torch_dryrun"

#: the functions whose ops the flash-attention kernel keeps on chip (``--attn-fused``)
FUSED_ATTENTION_SCOPES = ("models/layers.py:flash_attention", "models/layers.py:_block_mask")


def default_device() -> str:
    """``cuda`` where this PyTorch is built with CUDA, else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def input_specs(arch: str, shape_name: str) -> dict:
    """Shape-only stand-ins (``meta`` tensors) for every model input of one cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return batch_specs(cfg, shape.global_batch, shape.seq_len, shape.kind)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    knobs: PerfKnobs | None = None,
    *,
    attn_fused: bool = False,
    save: bool = True,
    tag: str = "",
    device: str | None = None,
) -> dict:
    """One cell's record (``status`` ok, skipped or failed), saved under
    :data:`RESULTS_DIR` unless ``save=False``."""
    knobs = knobs or PerfKnobs()
    device = device or default_device()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")

    ok, why = supports_shape(cfg, shape)
    if not ok:
        out = {"cell": cell_id, "status": "skipped", "reason": why}
        print(json.dumps(out))
        if save:
            _save(cell_id, out)
        return out

    t0 = time.time()
    world = 512 if multi_pod else 256
    try:
        with fake_process_group(world, rank=0):
            mesh = make_production_mesh(multi_pod=multi_pod, backend="fake", device=device)
            # every spec_for_axes replication fallback taken while wiring and
            # running this cell lands in the record
            with record_spec_fallbacks() as fallbacks:
                cell = wire_cell(cfg, mesh, seq_len=shape.seq_len,
                                 global_batch=shape.global_batch, mode=shape.kind, knobs=knobs)
                t_wire = time.time() - t0
                trace = cell.lower()
        t_lower = time.time() - t0 - t_wire
        attn_bytes = 0.0
        hbm = trace.hbm_bytes
        if attn_fused:
            hbm -= sum(row["bytes"] for name, row in trace.by_module.items()
                       if name.split("backward of ")[-1] in FUSED_ATTENTION_SCOPES)
            attn_bytes = fused_attention_hbm_bytes(cfg, shape, mesh, knobs)
            hbm += attn_bytes
        n_chips = world
        out = {
            "cell": cell_id,
            "status": "ok",
            "arch": arch,
            "shape": shape_name,
            "mode": shape.kind,
            "mesh": list(mesh.shape.values()),
            "n_chips": n_chips,
            "rank": 0,
            "device": device,
            "knobs": {**dataclasses.asdict(knobs), "attn_fused": attn_fused},
            "seconds": {"wire": round(t_wire, 1), "lower": round(t_lower, 1)},
            "memory": trace.memory,
            "cost": {
                "flops": trace.flops,
                "bytes_accessed": hbm,
                "attn_fused_model_bytes": attn_bytes,
                "launches": trace.launches,
            },
            "collectives": trace.collectives,
            "sharding_fallbacks": [
                {"axis": axis, "reason": reason, "count": count}
                for (axis, reason), count in fallbacks.items()
            ],
            "top": top_contributors(trace, 5),
            "model": {
                "params": cfg.param_count(),
                "params_active": cfg.param_count(active_only=True),
            },
        }
        # useful-compute cross-check: 6·N·D (train) or 2·N·D (prefill, decode)
        tokens_per_chip = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1) \
            / n_chips
        flops_fn = model_flops_train if shape.kind == "train" else model_flops_decode
        mf = flops_fn(cfg.param_count(active_only=True), tokens_per_chip)
        out["model"]["model_flops_per_chip"] = mf
        out["model"]["useful_flops_ratio"] = mf / trace.flops if trace.flops else 0.0
        print(
            f"[dryrun] {cell_id}: OK ({device}) wire {t_wire:.0f}s lower {t_lower:.0f}s | "
            f"peak/rank {trace.peak_bytes / 2**30:.2f} GiB | "
            f"flops/rank {trace.flops:.3e} (useful {out['model']['useful_flops_ratio']:.2f}) | "
            f"coll {trace.collectives['total_bytes'] / 2**20:.1f} MiB"
        )
    except Exception as e:  # noqa: BLE001 — a failing cell is a fault we record
        out = {
            "cell": cell_id,
            "status": "failed",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"[dryrun] {cell_id}: FAILED {type(e).__name__}: {e}")

    if save:
        _save(cell_id, out)
    return out


def fused_attention_hbm_bytes(cfg, shape, mesh, knobs: PerfKnobs) -> float:
    """Per-rank HBM traffic of the flash-attention kernel, modeled from
    shapes (the JAX package's formula): the kernel streams Q once, writes O
    once, and re-reads K/V once per q-block (causal skipping → on average
    (nq+1)/2 of them).  For train cells the remat schedule runs the forward
    twice and the backward reads ~2x the forward, so traffic ≈ 4x forward.
    MLA uses the materialised per-head K (nope+rope) / padded V.  SSM layers
    have no attention."""
    if cfg.attention_kind == "none" or shape.kind == "decode":
        return 0.0
    names = mesh.axis_names
    model = mesh.shape["model"] if "model" in names else 1
    data = 1
    for a in ("pod", "data"):
        if a in names:
            data *= mesh.shape[a]
    B_loc = max(1, shape.global_batch // data)
    S = shape.seq_len + cfg.meta_tokens
    qc = min(knobs.q_chunk, S)
    nq = -(-S // qc)
    H, KH = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        hd_q = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        hd_kv = hd_q  # k materialised per head; v padded to the same width
        KH = H
    else:
        hd_q = hd_kv = cfg.head_dim
    H_loc = H // model if H % model == 0 else H
    KH_loc = KH // model if KH % model == 0 else KH
    bpe = 2  # bf16
    q_o = 2 * B_loc * S * H_loc * hd_q * bpe
    kv = 2 * B_loc * S * KH_loc * hd_kv * bpe
    kv_reads = kv * (nq + 1) / 2  # causal-skip average
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) != "ssm")
    if cfg.encoder is not None:
        n_attn += cfg.encoder.n_layers  # bidirectional: full nk — approximate
    passes = 4.0 if shape.kind == "train" else 1.0
    return n_attn * (q_o + kv_reads) * passes


def measure_cell(cfg, shape, mesh_shape: tuple[int, ...], *, knobs: PerfKnobs | None = None,
                 seed: int = 0, device: str = "cuda") -> dict:
    """The dry run's prediction of rank 0's step of ``cfg`` at ``shape`` (a
    ``ShapeConfig``) on a ``mesh_shape`` mesh over a fake process group, and
    the same rank's step run for real (its shards and batch from ``seed``),
    collectives over the same fake group (they move nothing; on CUDA
    tensors too): ``{"predicted": {flops, peak_bytes, temp_bytes,
    argument_bytes}, "measured": {flops (``FlopCounterMode`` on the real
    step), held_bytes (allocated before it), peak_bytes
    (``torch.cuda.max_memory_allocated`` over it), growth_bytes (the peak
    less the bytes held before)}}``; on the CPU the measured memory is None."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.parallel.sharding import make_mesh

    knobs = knobs or PerfKnobs()
    names = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(mesh_shape)]
    world = 1
    for n in mesh_shape:
        world *= n
    cuda = device == "cuda"
    with fake_process_group(world, rank=0):
        mesh = make_mesh(mesh_shape, names, backend="fake", device=device)
        kw = dict(seq_len=shape.seq_len, global_batch=shape.global_batch, mode=shape.kind,
                  knobs=knobs)
        trace = wire_cell(cfg, mesh, **kw).lower()
        cell = wire_cell(cfg, mesh, seed=seed, **kw)
        if cuda:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            cell.run()
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    return {"predicted": {"flops": trace.flops, "peak_bytes": trace.peak_bytes,
                          "temp_bytes": trace.memory["temp_bytes"],
                          "argument_bytes": trace.memory["argument_bytes"]},
            "measured": {"flops": fc.get_total_flops(),
                         "held_bytes": held if cuda else None,
                         "peak_bytes": peak if cuda else None,
                         "growth_bytes": peak - held if cuda else None}}


def _save(cell_id: str, payload: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{cell_id}.json").write_text(json.dumps(payload, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument(
        "--multi-pod", default="both", choices=["true", "false", "both"],
        help="single-pod (16x16), multi-pod (2x16x16), or both",
    )
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--k-chunk", type=int, default=1024)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--attn-fused", action="store_true",
                    help="account the blocked attention's interior as the flash-attention "
                    "kernel's on-chip work (adds its modeled boundary traffic)")
    ap.add_argument("--skip-done", action="store_true", help="skip cells with saved results")
    ap.add_argument("--tag", default="", help="suffix for result files (perf experiments)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the fake tensors' device (default: cuda where this PyTorch is "
                    "built with CUDA, else cpu)")
    ap.add_argument("--measure", action="store_true",
                    help="on the card: rank 0 of one cell (--arch, --shape, --multi-pod "
                    "true|false) predicted and run for real over the fake group; prints one "
                    "JSON line (measure_cell)")
    args = ap.parse_args(argv)
    if args.measure:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        mesh_shape = (2, 16, 16) if args.multi_pod == "true" else (16, 16)
        out = measure_cell(cfg, shape, mesh_shape, device=args.device or "cuda")
        print("MEASURED " + json.dumps({"arch": args.arch, "shape": args.shape,
                                        "mesh": list(mesh_shape), **out}))
        return

    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"true": [True], "false": [False], "both": [False, True]}[args.multi_pod]
    knobs = PerfKnobs(q_chunk=args.q_chunk, k_chunk=args.k_chunk, remat=args.remat)

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                cell_id = f"{arch}__{shape}__{mesh_name}" + (f"__{args.tag}" if args.tag else "")
                if args.skip_done and (RESULTS_DIR / f"{cell_id}.json").exists():
                    prev = json.loads((RESULTS_DIR / f"{cell_id}.json").read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        continue
                out = run_cell(arch, shape, mp, knobs, attn_fused=args.attn_fused,
                               tag=args.tag, device=args.device)
                n_ok += out["status"] == "ok"
                n_fail += out["status"] == "failed"
                n_skip += out["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")


if __name__ == "__main__":
    main()
