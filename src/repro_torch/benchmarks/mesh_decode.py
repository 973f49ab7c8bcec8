"""Mesh-sharded paired decode: token parity and per-shard ledgers.

The port of ``benchmarks/mesh_decode.py``, with both of its gates:

1. **r = 0 token parity** — the tensor-parallel ``ServeEngine`` (one
   process a rank, ``launch.mesh.spawn``) decodes the same prompts token for
   token as the single-rank engine, its logits within ``PARITY_TOL``.  At
   r = 0 the paired kernel is exact, so a divergence is a sharding fault,
   not rounding.
2. **r = 0.05 ledgers** — the shard-aware build's per-shard ledger of every
   leaf sums to the leaf's total; a column-sharded leaf's total equals the
   single-host build's; the per-shard counts of wq (column-sharded) and
   w_down (row-sharded) equal standalone pairings of each shard's slice.

    # a (2, 4) mesh of gloo ranks on the CPU, the smoke config
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_decode --mesh 2,4 --device cpu
    # any of the ten archs: whisper with stub frames, internvl2 with patches
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_decode --arch whisper-base --device cpu
    # FSDP: mistral-large-123b's smoke config (embed over data, as its
    # published config's rules say); on the card at full width, 1 of 88 layers
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_decode --arch mistral-large-123b \
        --mesh 2,2 --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_decode --arch mistral-large-123b \
        --mesh 2,2 --layers 1

:func:`serve_rank` is what each rank runs (an engine over its shards, the
prompts, its tokens and logits, K1 launches and collectives a step); the
tests and ``chip_smoke.py`` spawn it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import fmt_table, write_result
from repro_torch.configs import get_smoke_config
from repro_torch.core.pairing import pair_rows_blocked
from repro_torch.core.transform import pair_params, tp_shard_plan
from repro_torch.device import resolve_device
from repro_torch.models import lm as M
from repro_torch.models.param import param_axes_and_shapes
from repro_torch.parallel.collectives import collective_stats, reset_collectives
from repro_torch.parallel.rules import arch_rules, rules_for
from repro_torch.parallel.sharding import Mesh

LEDGER_ROUNDING = 0.05
PARITY_TOL = 1e-5  # relative to the largest logit, fp32 at r = 0


def knobs_for(rounding: float, block_n: int = 1, **kw) -> M.PerfKnobs:
    return M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm="pallas_paired",
                       pair_block_n=block_n, pair_rounding=rounding, **kw)


def _k1_count() -> int:
    from repro_torch.kernels import paired_matmul as pm

    return pm.launch_count()


def slot_extras(extras: dict | None, slot: int) -> dict | None:
    """Row ``slot`` of each of ``extras`` (``launch.inputs.make_batch``'s
    ``"frames"``/``"patches"``, a row a slot), with its batch axis of 1."""
    return None if not extras else {k: v[slot:slot + 1] for k, v in extras.items()}


def generate(eng, prompts: dict, n_steps: int, extras: dict | None = None) -> dict:
    """``eng.generate`` with slot ``i``'s extras row ``i`` of ``extras``."""
    outs = {slot: [eng.add_request(slot, p, slot_extras(extras, slot))]
            for slot, p in prompts.items()}
    for _ in range(n_steps - 1):
        nxt = eng.step()
        for slot in prompts:
            outs[slot].append(int(nxt[slot]))
    return outs


def refill_len(cfg, plen: int) -> int:
    """The length of the ``cycle``'s refill of a ``plen``-token prompt: half
    of it, and longer than a vision-language model's patch positions."""
    return max(1, plen // 2, cfg.vision_prefix + 1)


def serve_rank(mesh: Mesh, cfg, weights, knobs: M.PerfKnobs, prompts: dict, n_steps: int, *,
               max_seq: int, batch_size: int, cycle: bool = False, hold: bool = False,
               timed_steps: int = 0, fold: bool = False, moe_x=None,
               extras: dict | None = None, rules=None) -> dict:
    """One rank's engine over ``cfg`` on ``mesh`` (under ``rules``:
    ``rules_for(cfg, "decode", mesh)`` unless given): ``weights`` is the JAX
    package's value tree of numpy arrays or a seed (``init_lm``'s weights,
    the same on every rank), of which the rank builds only its blocks, leaf
    by leaf (``launch.steps.local_model``).
    Generates ``n_steps`` tokens a slot from ``prompts`` (slot ``i`` with
    row ``i`` of ``extras``, an encoder-decoder model's frames or a
    vision-language one's patches, :func:`generate`) and returns them with
    the last step's logits, the rank's pairing report, its split
    (``"tp"``, the first segment's and the model's; ``"tp_segments"``,
    ``"tp_encoder"``), the shapes of its weights and cache, and what one
    more decode step and one more prefill launched and sent (K1 launches on
    the card, K1 calls on the CPU; collectives by kind).  ``cycle`` then
    releases slot 0, refills it and steps once more (its tokens under
    ``"cycle"``); ``hold`` keeps the paired weights in the compute dtype
    once paired; ``timed_steps`` times that many more decode steps (ms,
    device-synchronised); ``fold`` returns each paired weight of the rank
    folded by its own metadata (``kernels.ops.fold_lm_weight``, an expert's
    by ``fold_lm_expert_weight``) with where its block sits in the whole
    weight (:func:`folded_blocks`); ``moe_x`` (a (B, S, d) numpy array)
    returns layer 0's expert block over it, and how many times it took the
    expert-parallel route (``models.layers._moe_shard_map``).  ``k1_launches``
    counts every K1 launch of the rank from the engine's wiring on."""
    from repro_torch.analysis import counting
    from repro_torch.launch.steps import held_bytes, largest_leaf_bytes
    from repro_torch.models import layers as Lyr
    from repro_torch.serving.engine import ServeEngine

    dev = mesh.device
    k1_start = _k1_count()
    wire_peak = base = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, weights, max_seq=max_seq, batch_size=batch_size, knobs=knobs,
                      mesh=mesh, rules=rules)
    wire_s = time.perf_counter() - t0
    # what the wiring left on the device (before ``hold`` narrows the paired weights)
    held = held_bytes(eng.model) + sum(t.numel() * t.element_size() for t in eng.cache.values())
    if hold:
        M.hold_paired_in_compute_dtype(cfg, eng.model)
    if dev.type == "cuda":
        wire_peak = torch.cuda.max_memory_allocated(dev) - base  # its blocks, one whole leaf
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    with counting(moe_routes=(Lyr._moe_shard_map,)) as routes:
        out = generate(eng, prompts, n_steps, extras)
    logits = eng.last_logits
    # one more decode step and one more prefill, counted
    reset_collectives()
    with counting() as c:
        before = _k1_count()
        eng.step()
    step_k1 = _k1_count() - before if dev.type == "cuda" else c["k1_calls"]
    step_coll = collective_stats()
    free = [s for s in range(batch_size) if s not in prompts]
    prefill_k1 = prefill_coll = None
    if free:
        reset_collectives()
        with counting() as c:
            before = _k1_count()
            eng.add_request(free[0], np.asarray(next(iter(prompts.values()))),
                            slot_extras(extras, free[0]))
        prefill_k1 = _k1_count() - before if dev.type == "cuda" else c["k1_calls"]
        prefill_coll = collective_stats()
        eng.release_slot(free[0])
    rec = {"rank": mesh.rank, "coords": mesh.coords, "tokens": out, "logits": logits,
           "wire_s": wire_s, "wire_seconds": eng.cell.seconds, "wire_peak_bytes": wire_peak,
           "held_bytes": held,
           "leaf_bytes": largest_leaf_bytes(cfg),
           "step_k1": step_k1, "step_collectives": step_coll,
           "prefill_k1": prefill_k1, "prefill_collectives": prefill_coll,
           "tp": {k: getattr(eng.tp, k) for k in ("vocab_split", "q_split", "kv_split",
                                                  "cache_seq", "ff_split", "experts_split",
                                                  "batch_split")},
           "fsdp_axes": eng.tp.fsdp_axes, "top_gathers": eng.tp.top_gathers,
           "tp_segments": [dict(splits) for _, splits in eng.tp.segment_splits],
           "tp_encoder": None if eng.tp.encoder_splits is None else dict(eng.tp.encoder_splits),
           "shapes": {name: tuple(t.shape) for name, t in eng.model.named_parameters()},
           "cache_shapes": {name: tuple(t.shape) for name, t in eng.cache.items()},
           "moe_shard_map_calls": routes["moe_routes"],
           "pair_report": None if eng.pair_report is None else [
               {"path": lr.path, "n_pairs": lr.n_pairs, "row_shards": lr.row_shards,
                "col_shards": lr.col_shards} for lr in eng.pair_report.leaves]}
    if cycle:
        first = next(iter(prompts))
        eng.release_slot(first)
        refill = np.asarray(prompts[first])[: refill_len(cfg, len(prompts[first]))]
        rec["cycle"] = [eng.add_request(first, refill, slot_extras(extras, first)),
                        eng.step().tolist()]
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            eng.step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
        rec["step_ms"] = times
    if fold:
        rec["folded"] = folded_blocks(eng, mesh)
    if moe_x is not None:
        moe = eng.model.layers[0].moe
        x = torch.as_tensor(moe_x, device=dev).to(M.compute_dtype(cfg))
        with torch.no_grad(), counting(moe_routes=(Lyr._moe_shard_map,)) as c:
            y, _ = Lyr.moe_block(cfg, moe, x, knobs, tp=eng.tp)
        rec["moe_y"], rec["moe_routes"] = y.float().cpu().numpy(), c["moe_routes"]
    rec["k1_launches"] = _k1_count() - k1_start  # all of this rank's (0 on the CPU)
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)  # serving, after the wiring
    return rec


def serve_many(mesh: Mesh, jobs: dict) -> dict:
    """:func:`serve_rank` for each ``name: (args, kwargs)`` of ``jobs`` on
    this rank, one after another: one spawn serves several engines."""
    return {name: serve_rank(mesh, *args, **kwargs) for name, (args, kwargs) in jobs.items()}


def folded_blocks(eng, mesh: Mesh) -> dict:
    """Each paired weight of the rank's engine folded by the rank's own
    metadata, as ``{(layer, block, name): (starts, folded)}`` for a decoder
    layer (``block`` a dotted path: ``"attn"``, ``"moe.shared"``) and
    ``{("encoder", layer, block, name): …}`` for an encoder one: ``folded``
    a float64 numpy array of the rank's block in the weight's shape, and
    ``starts`` where it sits in the whole weight (its resolved spec and the
    rank's coordinates); the folded-dense oracle of the mesh engine
    (:func:`assemble_folded`)."""
    from repro_torch.kernels.ops import fold_lm_expert_weight, fold_lm_weight
    from repro_torch.models.layers import MoE
    from repro_torch.parallel.sharding import shardings_for

    cfg, knobs = eng.cfg, eng.knobs
    axes, shapes = param_axes_and_shapes(cfg)
    specs = shardings_for(axes, mesh, eng.rules, shapes)
    out = {}

    def walk(layers, segments, seg_specs, key) -> None:
        start = 0
        for (_, count), seg_spec in zip(segments, seg_specs, strict=True):
            for l in range(start, start + count):
                for path, sub in layers[l].named_modules():
                    for name, meta in getattr(sub, "pairing", {}).items():
                        w = getattr(sub, name).detach().float()
                        if isinstance(sub, MoE) and w.ndim == 3:
                            wf = fold_lm_expert_weight(w, meta, knobs.pair_block_n)
                        else:
                            wf = fold_lm_weight(sub.matrix(name, torch.float32), meta,
                                                knobs.pair_block_n)
                        spec = seg_spec
                        for part in path.split("."):
                            spec = spec[part]
                        starts = [0 if e is None else mesh.index(e) * (w.shape[d])
                                  for d, e in enumerate(spec[name][1:])]
                        out[key(l, path, name)] = (starts,
                                                   wf.reshape(w.shape).double().cpu().numpy())
            start += count

    walk(eng.model.layers, eng.model.segments, specs["segments"], lambda *k: k)
    if eng.model.encoder is not None:
        enc = eng.model.encoder
        walk(enc.layers, enc.segments, specs["encoder"]["segments"], lambda *k: ("encoder", *k))
    return out


def assemble_folded(cfg, model: M.LM, ranks_folded: list[dict]) -> M.LM:
    """A copy of ``model`` (on the CPU) with every paired weight replaced by
    the ranks' folded blocks (:func:`folded_blocks`), each placed where it
    sits: the single-device model whose plain engine is the mesh engine's
    folded-dense oracle."""
    folded = M.init_lm(cfg, 0, device="cpu")
    M.load_lm_values(folded, M.lm_value_tree(model))
    with torch.no_grad():
        for blocks in ranks_folded:
            for key, (starts, block) in blocks.items():
                layers = folded.encoder.layers if key[0] == "encoder" else folded.layers
                l, path, name = key[-3:]
                node = layers[l]
                for part in path.split("."):
                    node = getattr(node, part)
                w = getattr(node, name)
                idx = tuple(slice(s, s + n) for s, n in zip(starts, block.shape))
                w[idx] = torch.as_tensor(block, dtype=w.dtype)
    return folded


def shard_shapes(cfg, mesh: Mesh, batch_size: int, max_seq: int) -> tuple[dict, dict]:
    """What the rank of ``mesh`` should hold under ``rules_for(cfg,
    "decode", mesh)``: each weight's shape keyed as the served model's
    ``named_parameters``, and each cache entry's as ``models.lm.init_cache``
    stacks it (all layers), every dim divided where its resolved spec splits
    it; :func:`serve_rank`'s ``"shapes"`` and ``"cache_shapes"`` are held to
    them."""
    from repro_torch.models.param import cache_axes_and_shapes
    from repro_torch.parallel.sharding import shardings_for

    rules = rules_for(cfg, "decode", mesh)
    axes, shapes = param_axes_and_shapes(cfg)
    specs = shardings_for(axes, mesh, rules, shapes)

    def local(shape, spec):
        return tuple(n // mesh.axis_size(e) if e is not None else n for n, e in zip(shape, spec))

    def leaves(spec_tree, shape_tree, path=()):
        for k, v in spec_tree.items():
            if isinstance(v, dict):
                yield from leaves(v, shape_tree[k], path + (k,))
            else:
                yield path + (k,), shape_tree[k].shape, v

    weights = {}

    def stack(prefix, seg_specs, seg_shapes, segments):
        start = 0
        for (_, count), seg_spec, seg_shape in zip(segments, seg_specs, seg_shapes, strict=True):
            for path, shape, spec in leaves(seg_spec, seg_shape):
                for l in range(start, start + count):
                    weights[".".join((prefix, str(l), *path))] = local(shape[1:], spec[1:])
            start += count

    stack("layers", specs["segments"], shapes["segments"], cfg.segments())
    top = {k: v for k, v in specs.items() if k not in ("segments", "encoder")}
    if cfg.encoder is not None:
        enc = specs["encoder"]
        stack("encoder.layers", enc["segments"], shapes["encoder"]["segments"],
              (("encoder", cfg.encoder.n_layers),))
        top["encoder"] = {"final_norm": enc["final_norm"]}
    for path, shape, spec in leaves(top, shapes):
        weights[".".join(path)] = local(shape, spec)
    c_axes, c_shapes = cache_axes_and_shapes(cfg, batch_size, max_seq)
    c_specs = shardings_for(c_axes, mesh, rules, c_shapes)
    cache = {}
    for seg_spec, seg_shape in zip(c_specs["segments"], c_shapes["segments"], strict=True):
        for k, spec in seg_spec.items():
            cache[k] = (cfg.n_layers, *local(seg_shape[k].shape[1:], spec[1:]))
    return weights, cache


def _gemm_stack(model: M.LM, sub: str, name: str) -> np.ndarray:
    """(L, K, N) float64 GEMM view of one decoder leaf over the layers that
    hold it."""
    mats = [getattr(getattr(layer, sub), name).detach().cpu().double() for layer in model.layers
            if hasattr(layer, sub)]
    return np.stack([(m.reshape(-1, m.shape[-1]) if name == "wo" else m.reshape(m.shape[0], -1))
                     .numpy() for m in mats])


def _standalone_shard_ledger(mats: np.ndarray, rounding: float, rs: int, cs: int,
                             block_n: int = 1) -> list[int]:
    """Per-shard pair counts (per-column equivalent) from standalone
    column-blocked builds on each shard's slice: the reference the
    shard-aware ledger must equal."""
    _, K, N = mats.shape
    n = max(rs, cs)
    totals = [0] * n
    for m in mats:
        for s in range(n):
            sl = (m[:, s * (N // cs):(s + 1) * (N // cs)] if cs > 1
                  else m[s * (K // rs):(s + 1) * (K // rs), :])
            totals[s] += pair_rows_blocked(sl, rounding, block_n, magnitudes=False).weighted_pairs
    return totals


def ledger_checks(cfg, model: M.LM, mesh_shape: dict, rounding: float = LEDGER_ROUNDING,
                  block_n: int = 1):
    """The r = ``rounding`` ledger gates on the host (no process needed: the
    plan reads only the mesh's shape), column-blocked at ``block_n`` (1: per
    column, the JAX bench's), under the tensor-parallel splits of
    ``rules_for(cfg, "decode", mesh)`` (its gates read one split a leaf: an
    FSDP leaf splits two ways).  Returns ``(rows, slice_checks, failures)``."""
    mesh = Mesh(mesh_shape)
    rules = rules_for(cfg, "decode", mesh)
    axes, shapes = param_axes_and_shapes(cfg)
    plan = tp_shard_plan(axes, shapes, mesh, rules, leaves=cfg.paired_leaves)
    kw = dict(mode="column_blocked", block_n=block_n, leaves=cfg.paired_leaves)
    _, rep_mesh = pair_params(model, rounding, shards=plan, **kw)
    _, rep_single = pair_params(model, rounding, **kw)
    single = {lr.path: lr for lr in rep_single.leaves}
    failures, rows = [], []
    for lr in rep_mesh.leaves:
        one = single[lr.path]
        if lr.shard_pairs is not None and sum(lr.shard_pairs) != lr.n_pairs:
            failures.append(f"{lr.path}: shard ledger {lr.shard_pairs} sums to "
                            f"{sum(lr.shard_pairs)} != total {lr.n_pairs}")
        if lr.col_shards > 1 and lr.n_pairs != one.n_pairs:
            failures.append(f"{lr.path}: column-sharded total {lr.n_pairs} != "
                            f"single-host {one.n_pairs}")
        rows.append({"leaf": lr.path.split("].")[-1], "rs": lr.row_shards, "cs": lr.col_shards,
                     "pairs": lr.n_pairs, "single_host": one.n_pairs,
                     "shard_pairs": list(lr.shard_pairs or ()), "pair_frac": lr.pair_fraction})
    slice_checks = []
    for sub, name in (("attn", "wq"), ("mlp", "w_down")):
        if (sub, name) not in plan:
            continue
        rs, cs = plan[(sub, name)]
        # the decoder's leaf in every segment (not the encoder's, nor xattn's)
        leaf = re.compile(rf"segments\[\d+\]\.{sub}\.{name}")
        segs = [x for x in rep_mesh.leaves if leaf.fullmatch(x.path)]
        if max(rs, cs) > 1:
            want = _standalone_shard_ledger(_gemm_stack(model, sub, name), rounding, rs, cs,
                                            block_n)
            got = [int(n) for n in np.sum([x.shard_pairs for x in segs], axis=0)]
            if got != want:
                failures.append(f"{sub}.{name}: per-shard ledger {got} != standalone "
                                f"slice builds {want}")
            slice_checks.append({"leaf": f"{sub}.{name}", "rs": rs, "cs": cs,
                                 "per_shard": got, "standalone": want})
    return rows, slice_checks, failures


def run(mesh_shape=(1, 2), *, device: str | None = None, backend: str = "gloo",
        n_steps: int = 10, arch: str = "qwen2-1.5b", layers: int = 0) -> dict:
    """Both gates on the ``arch`` smoke config (any of the ten) in fp32: the
    mesh engine's tokens against the single-rank engine's (each slot with
    its row of ``make_batch``'s stub frames or patches), then the ledgers;
    raises on a failed gate, writes
    ``benchmarks/results/torch_mesh_decode.json``.  ``layers``: the
    published config at full width cut to that depth instead (no ledgers:
    they pair the whole model on the host).  Either cut is sharded by the
    arch's rules (``parallel.rules.arch_rules``: mistral-large-123b's FSDP,
    ``embed`` over ``data``).  Each rank builds only its own blocks;
    its wiring seconds, wiring peak and held bytes are reported.  The ranks
    and the reference run on the GPU unless ``device="cpu"``."""
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.serving.engine import ServeEngine

    from repro_torch.launch.inputs import make_batch

    cfg = dataclasses.replace(cut_layers(get_config(arch), layers) if layers
                              else get_smoke_config(arch), dtype="float32")
    names = ("data", "model")[-len(mesh_shape):]
    rules = arch_rules(arch, "decode", Mesh(dict(zip(names, mesh_shape))))
    dev = resolve_device(device)
    device = dev.type
    model = M.init_lm(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(1, cfg.vocab, size=cfg.vision_prefix + 7).astype(np.int32),
               1: rng.integers(1, cfg.vocab, size=cfg.vision_prefix + 12).astype(np.int32)}
    stubs = make_batch(cfg, 2, 1, "prefill", seed=0, device=dev)
    extras = {k: stubs[k].cpu().numpy() for k in M.EXTRAS if k in stubs} or None
    max_seq = 32 + cfg.vision_prefix
    ref = ServeEngine(cfg, model, max_seq=max_seq, batch_size=2, knobs=knobs_for(0.0))
    want = generate(ref, prompts, n_steps, extras)
    t0 = time.perf_counter()
    ranks = spawn(serve_rank, mesh_shape, backend=backend, device=device,
                  args=(cfg, 0, knobs_for(0.0), prompts, n_steps),
                  kwargs={"max_seq": max_seq, "batch_size": 2, "extras": extras,
                          "rules": rules})
    run_s = time.perf_counter() - t0
    failures = []
    for rec in ranks:
        if rec["tokens"] != want:
            failures.append(f"r=0 token mismatch on rank {rec['rank']}: single-rank {want} "
                            f"vs mesh {rec['tokens']}")
        err = np.abs(rec["logits"] - ref.last_logits).max() / np.abs(ref.last_logits).max()
        if err > PARITY_TOL:
            failures.append(f"rank {rec['rank']}: logits {err:.3g} from the single-rank "
                            f"engine's (tolerance {PARITY_TOL})")
    rows, slices = [], []
    if not layers:
        rows, slices, ledger_failures = ledger_checks(cfg, model, dict(zip(names, mesh_shape)))
        failures += ledger_failures
        print(fmt_table(rows, ["leaf", "rs", "cs", "pairs", "single_host", "pair_frac"],
                        f"mesh_decode r={LEDGER_ROUNDING} shard ledger (mesh {mesh_shape})"))
    for rec in ranks:
        print(f"[mesh_decode] rank {rec['rank']}: wired in {rec['wire_s']:.2f} s, holds "
              f"{rec['held_bytes'] / 1e9:.3f} GB, wiring peak "
              f"{(rec['wire_peak_bytes'] or 0) / 1e9:.3f} GB (0: not on a card)")
    payload = {"mesh": list(mesh_shape), "arch": arch, "layers": cfg.n_layers,
               "rules": None if rules is None else dict(rules.table),
               "device": device, "backend": backend,
               "parity_steps": n_steps, "parity_ok": not any("token" in f for f in failures),
               "ledger": rows, "slice_checks": slices, "spawn_and_run_s": run_s,
               "wire_s": [r["wire_s"] for r in ranks],
               "wire_peak_bytes": [r["wire_peak_bytes"] for r in ranks],
               "held_bytes": [r["held_bytes"] for r in ranks], "failures": failures}
    write_result("mesh_decode", payload)
    if failures:
        raise AssertionError("; ".join(failures))
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1,2", help="data,model (or model) ranks")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="the GPU unless cpu is asked for")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0,
                    help="the published config at full width, cut to this depth (0: smoke)")
    a = ap.parse_args(argv)
    shape = tuple(int(x) for x in a.mesh.split(","))
    out = run(shape, device=a.device, backend=a.backend, n_steps=a.steps, arch=a.arch,
              layers=a.layers)
    print(f"[mesh_decode] mesh {shape}: r=0 parity over {a.steps} steps; "
          f"{len(out['ledger'])} leaves, ledgers ok; {out['spawn_and_run_s']:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
