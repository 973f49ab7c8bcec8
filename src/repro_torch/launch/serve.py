"""Serving driver of the port: prefill + batched greedy decode of an LM.

    # on the GPU (the default): full-size qwen2-1.5b, paired GEMMs and fused
    # decode attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05

    # on the CPU, the kernels' plain versions, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --gemm pallas_paired --attn pallas_fused --device cpu

    # olmoe-1b-7b (64 experts top-8): every expert projection one K1 launch
    # over the expert grid; prompts of 12 and 16 tokens take the dense
    # expert branch, 24 and 64 the routed one
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 \
        --batch 4 --max-seq 256 --prompt-lens 12,16,24,64

    # deepseek-v2-lite-16b (MLA, 64 routed experts top-6 beside 2 shared, a
    # dense first layer): every projection but MLA's latent up-projections
    # on K1; decode attention is latent einsums (--attn is a no-op for it)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --gemm pallas_paired --pair-rounding 0.05 \
        --batch 4 --max-seq 256 --prompt-lens 12,16,24,64

    # mamba2-2.7b (SSM: 64 Mamba-2 layers, no attention): the six SSM
    # projections of every layer on K1; the conv, the SSD scan and the
    # state step plain PyTorch; --attn is a no-op for it
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --gemm pallas_paired --pair-rounding 0.05 \
        --batch 4 --max-seq 512 --prompt-lens 12,16,24,300

    # hymba-1.5b (hybrid: attention beside SSM heads, 128 meta tokens, a
    # window of 1024 with the meta tokens as its sinks on 29 of 32 layers):
    # every projection on K1, the windowed decode attention on K2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 \
        --batch 4 --max-seq 1280 --prompt-lens 12,16,24,1200

    # qwen3-4b (qk-norm), granite-3-2b and mistral-large-123b (dense GQA):
    # the same path as qwen2-1.5b; mistral's 88 layers (246 GB in bf16) do
    # not fit one 80 GB card: --layers cuts the depth
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-large-123b \
        --layers 4 --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 \
        --batch 4 --max-seq 256 --prompt-lens 12,16,24,64

    # whisper-base (encoder-decoder): each slot's prefill runs the encoder
    # over its stub frames once (1500 × 512, make_batch), its
    # self-attention and the decoder's cross-attention on the
    # flash-attention kernel (K3) under --attn pallas_fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 \
        --batch 4 --max-seq 128 --prompt-lens 12,16,24,64

    # internvl2-2b (vision-language): 256 stub patch embeddings take a
    # prompt's first positions, so a prompt has more than 256 tokens
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 \
        --batch 4 --max-seq 320 --prompt-lens 260,270,280,300

    # hardened front end: Poisson load + chaos over the paired engine, with
    # graceful degradation to the unpaired fallback engine (--fallback-gemm
    # pallas: its GEMMs on K1's dense form)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --gemm pallas_paired --frontend --arrival-rate 20 --horizon 0.5 \
        --inject nan_logits:0.05,kv_poison:0.02,kernel_failure:0.02 --device cpu

    # K1's plans from a measured tile cache (chip_smoke.py's tile_cache phase
    # writes one for this engine; kernels.tuning.autotune_plans)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05 --batch 4 \
        --max-seq 256 --tile-cache .cache/tile_cache.json

    # the weights folded per column at r=0.05 first (host work: about 20 s
    # a full-width qwen2 layer), one layer
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --layers 1 \
        --gemm pallas_paired --pair-rounding 0.05 --paired-rounding 0.05

The port of ``repro.launch.serve``.  ``--paired-rounding`` folds the weights
per column first (``core.transform.fold_lm_params``; the JAX CLI's
``pair_model_params`` on the whole value tree pairs the wrong axes of an LM,
so the port departs from it on purpose).  ``--tile-cache`` (a file that must
exist) and ``--block-k`` set K1's launch plans (``kernels.tuning``);
``--conv`` and ``--fuse-pool`` are the JAX CLI's conv knobs, which change
nothing on the LM archs, as there.  Weights are random from seed 0
(``models.lm.init_lm``); once
the engine has paired them, the launcher holds the paired ones in the
compute dtype (``models.lm.hold_paired_in_compute_dtype``), which every use
casts them to: a bf16 model's paired fp32 masters would not fit one card
beside their segments at deepseek-v2-lite-16b's size.  ``--max-seq`` counts
a slot's tokens; a hybrid model's cache holds its meta tokens beside them.
Without ``--frontend`` slot ``i`` is prefilled with a random prompt of
``--prompt-lens``' ``i``-th length (default ``vision_prefix + 8 + 4·i``
tokens) and every slot decodes ``--steps`` tokens (the first from its
prefill); an encoder-decoder or vision-language slot gets row ``i`` of
``launch.inputs.make_batch``'s seeded stub frames or patches (the JAX
package's CLI feeds none, so it cannot serve these families).  With
``--frontend``, ``serving.frontend`` serves a seeded Poisson workload
(``--seed``) and the run exits non-zero if any request is lost; it feeds no
frames or patches, and refuses those two families.  ``--layers`` cuts the
decoder (and encoder) depth of the config (``configs.cut_layers``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import cut_layers, get_config, get_smoke_config
from repro_torch.core.transform import fold_lm_params
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paired_matmul as pm
from repro_torch.launch.inputs import make_batch
from repro_torch.models import lm as M
from repro_torch.serving import (
    FaultInjector,
    FrontendConfig,
    ServeEngine,
    ServeFrontend,
    ServeReport,
    poisson_workload,
)


def kernel_launches() -> dict[str, int]:
    """Launches of each kernel since its counter was last reset."""
    return {"paired_matmul": pm.launch_count(), "decode_attention": da.launch_count(),
            "flash_attention": fa.launch_count()}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _build_engine(*, arch: str, smoke: bool, batch: int, max_seq: int, pair_rounding: float,
                 pair_block_n: int, gemm: str, attn: str, device: str | None,
                 layers: int | None = None, paired_rounding: float = 0.0, block_k: int = 0,
                 tile_cache: str = "", conv: str = "xla", fuse_pool: bool = False):
    """Config, device, the model (seed 0, folded per column at
    ``paired_rounding`` if it is above 0, unpaired) and the engine over it
    (paired by its constructor under ``gemm="pallas_paired"``, its paired
    weights then held in the compute dtype), and the seconds the engine
    took to build; prints the pairing reports."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = cut_layers(cfg, layers)
    dev = resolve_device(device)
    model = M.init_lm(cfg, 0, device=dev)
    if paired_rounding > 0:
        mode = "column_blocked" if pair_block_n >= 1 else "per_column"
        t0 = time.perf_counter()
        model, report = fold_lm_params(model, paired_rounding, block_n=max(1, pair_block_n))
        s = report.savings()
        print(f"[serve] subtractor pairing ({mode}"
              f"{f', block_n={pair_block_n}' if pair_block_n else ''}): "
              f"{report.total_pairs} pairs ({100 * report.pair_fraction:.1f}% of weights) "
              f"→ modeled power −{100 * s['power_saving']:.1f}%, "
              f"area −{100 * s['area_saving']:.1f}%; folded in "
              f"{time.perf_counter() - t0:.1f} s")
    knobs = M.PerfKnobs(q_chunk=32, k_chunk=32, gemm=gemm, attn=attn, conv=conv,
                        block_k=block_k, fuse_pool=fuse_pool, tile_cache=tile_cache,
                        pair_block_n=pair_block_n, pair_rounding=pair_rounding)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, max_seq=max_seq, batch_size=batch, knobs=knobs)
    pairing_s = time.perf_counter() - t0
    M.hold_paired_in_compute_dtype(cfg, eng.model)
    rp = eng.pair_report
    if rp is not None:
        print(f"[serve] paired-kernel LM path ({rp.mode}"
              f"{f', block_n={pair_block_n}' if pair_block_n else ''}"
              f", rounding {pair_rounding}): "
              f"{rp.total_pairs} per-column-equivalent pairs across "
              f"{len(rp.leaves)} decoder weights "
              f"({100 * rp.pair_fraction:.1f}% of paired-eligible weights); "
              f"residual adds fused into the kernel epilogue; paired in {pairing_s:.1f} s")
    return cfg, dev, model, eng, pairing_s


def serve(
    *,
    arch: str,
    smoke: bool = False,
    batch: int = 2,
    max_seq: int = 128,
    steps: int = 16,
    pair_rounding: float = 0.0,
    pair_block_n: int = 0,
    gemm: str = "xla",
    attn: str = "xla",
    device: str | None = None,
    prompt_lens: list[int] | None = None,
    layers: int | None = None,
    paired_rounding: float = 0.0,
    block_k: int = 0,
    tile_cache: str = "",
    conv: str = "xla",
    fuse_pool: bool = False,
) -> dict:
    """Build the engine, serve one prompt per slot, print what the JAX
    package's driver prints, and return the run's record: the engine, the
    prompts and tokens, seconds spent pairing, per-request prefill and
    per-step decode wall times (ms; each ends in a device-to-host copy of the
    tokens, so it includes the device work), and the kernel launches made
    during the prefills and during the decode steps."""
    cfg, dev, _, eng, pairing_s = _build_engine(
        arch=arch, smoke=smoke, batch=batch, max_seq=max_seq, pair_rounding=pair_rounding,
        pair_block_n=pair_block_n, gemm=gemm, attn=attn, device=device, layers=layers,
        paired_rounding=paired_rounding, block_k=block_k, tile_cache=tile_cache, conv=conv,
        fuse_pool=fuse_pool)

    lens = prompt_lens or [cfg.vision_prefix + 8 + 4 * i for i in range(batch)]
    if len(lens) != batch:
        raise ValueError(f"{len(lens)} prompt lengths for a batch of {batch}")
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for i, n in enumerate(lens)}
    stubs = make_batch(cfg, batch, 1, "prefill", seed=0, device=dev)
    extras = {i: {k: stubs[k][i:i + 1] for k in M.EXTRAS if k in stubs} for i in prompts}
    outs: dict[int, list[int]] = {}
    prefill_ms, step_ms = [], []
    t_all = time.perf_counter()
    before = kernel_launches()
    for slot, prompt in prompts.items():
        t0 = time.perf_counter()
        outs[slot] = [eng.add_request(slot, prompt, extras[slot])]
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = _since(before)
    before = kernel_launches()
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        nxt = eng.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for slot in prompts:
            outs[slot].append(int(nxt[slot]))
    decode_launches = _since(before)
    dt = time.perf_counter() - t_all
    for slot, toks in outs.items():
        print(f"[serve] slot {slot}: prompt {len(prompts[slot])} toks → {toks}")
    print(f"[serve] {batch * steps} tokens in {dt:.2f}s "
          f"({batch * steps / dt:.1f} tok/s incl. prefill) on {dev}")
    return {
        "engine": eng, "prompts": prompts, "extras": extras, "outputs": outs,
        "pairing_s": pairing_s,
        "prefill_ms": prefill_ms, "step_ms": step_ms, "seconds": dt,
        "tokens_per_s": batch * steps / dt,
        "launches": {"prefill": prefill_launches, "decode": decode_launches},
    }


#: the front end's fallback GEMMs: torch.matmul, or K1's dense form
FALLBACK_GEMMS = ("xla", "pallas")


def _parse_fault_rates(spec: str) -> dict[str, float]:
    rates: dict[str, float] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        kind, _, rate = part.partition(":")
        rates[kind] = float(rate or 0.0)
    return rates


def run_frontend(
    *,
    arch: str,
    smoke: bool = False,
    batch: int = 2,
    max_seq: int = 128,
    steps: int = 16,
    pair_rounding: float = 0.0,
    pair_block_n: int = 0,
    gemm: str = "xla",
    attn: str = "xla",
    device: str | None = None,
    arrival_rate: float = 10.0,
    horizon: float = 1.0,
    seed: int = 0,
    prefill_chunk: int = 8,
    deadline: float = float("inf"),
    inject: str = "",
    fallback_gemm: str = "xla",
    layers: int | None = None,
    paired_rounding: float = 0.0,
    block_k: int = 0,
    tile_cache: str = "",
    conv: str = "xla",
    fuse_pool: bool = False,
) -> ServeReport:
    """Simulated-load run: Poisson arrivals + optional chaos, degrading to a
    fresh unpaired fallback engine on the same (folded, unpaired) weights,
    its GEMMs ``torch.matmul`` (``fallback_gemm="xla"``) or K1's dense form
    (``"pallas"``).  Prints the report's summary and the kernel launches of
    the run; raises ``SystemExit`` if any request is lost.  The front end
    feeds tokens alone: an encoder-decoder or vision-language arch raises."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.encoder is not None or cfg.vision_prefix:
        raise ValueError(f"the front end feeds no frames or patches: it cannot serve "
                         f"{arch} ({cfg.family})")
    if fallback_gemm not in FALLBACK_GEMMS:
        raise ValueError(f"fallback_gemm {fallback_gemm!r} not in {FALLBACK_GEMMS}")
    cfg, dev, model, eng, _ = _build_engine(
        arch=arch, smoke=smoke, batch=batch, max_seq=max_seq, pair_rounding=pair_rounding,
        pair_block_n=pair_block_n, gemm=gemm, attn=attn, device=device, layers=layers,
        paired_rounding=paired_rounding, block_k=block_k, tile_cache=tile_cache, conv=conv,
        fuse_pool=fuse_pool)
    # `model` is the pre-pairing model (the engine paired its own copy), so
    # the fallback runs plain exact GEMMs (decode attention as the primary's)
    fb_knobs = dataclasses.replace(eng.knobs, gemm=fallback_gemm, pair_rounding=0.0)
    fallback = ServeEngine(cfg, model, max_seq=max_seq, batch_size=batch, knobs=fb_knobs)
    workload = poisson_workload(
        rate_rps=arrival_rate, horizon_s=horizon, seed=seed, vocab=cfg.vocab,
        prompt_len=(3, max(4, max_seq // 4)), new_tokens=(2, max(3, steps)))
    rates = _parse_fault_rates(inject)
    faults = FaultInjector.from_rates(seed, n_steps=4096, batch_size=batch,
                                      rates=rates) if rates else None
    fe = ServeFrontend(eng, fallback,
                       FrontendConfig(prefill_chunk=prefill_chunk, deadline_s=deadline),
                       faults=faults)
    before = kernel_launches()
    report = fe.run(workload, offered_load_rps=arrival_rate)
    print(f"[serve] front end: {len(workload)} requests @ {arrival_rate} req/s over "
          f"{horizon}s ({len(report.incidents)} incident records) on {dev}; "
          f"kernel launches {_since(before)}")
    print(json.dumps(report.summary(), indent=2))
    lost = report.lost()
    if lost:
        raise SystemExit(f"[serve] LOST {len(lost)} request(s): {[r.rid for r in lost]}")
    return report


def main(argv: list[str] | None = None) -> dict | ServeReport:
    """The CLI; returns :func:`serve`'s record, or the front end's report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config of the arch")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's decoder (and encoder) to this many layers")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prompt-lens", type=lambda v: [int(n) for n in v.split(",")],
                    default=None, help="prompt length of each slot, comma-separated "
                                       "(default 8 + 4·slot)")
    ap.add_argument("--paired-rounding", type=float, default=0.0,
                    help="fold the weights first: per-column pairing (per "
                         "--pair-block-n columns if n >= 1) of each decoder weight "
                         "matrix at this rounding (core.transform.fold_lm_params; "
                         "the JAX CLI's pair_model_params pairs the wrong axes of an "
                         "LM tree); 0.0 folds nothing")
    ap.add_argument("--pair-rounding", type=float, default=0.0,
                    help="rounding size of the pallas_paired LM pairing (live-weight "
                         "kernel path, distinct from --paired-rounding's offline "
                         "folding); 0.0 is the exact-parity point")
    ap.add_argument("--pair-block-n", type=int, default=0,
                    help="pairing-mode spectrum: 0 → structured (one shared-row "
                         "pairing per weight); n >= 1 → column-blocked, one "
                         "pairing per n output columns (1 == per-column)")
    ap.add_argument("--gemm", choices=M.GEMMS, default="xla",
                    help="xla: torch.matmul; pallas_paired: the decoder GEMMs on "
                         "the paired subtractor kernel, residual adds in its "
                         "epilogue")
    ap.add_argument("--attn", choices=M.ATTNS, default="xla",
                    help="decode attention: xla is plain PyTorch; pallas_fused is "
                         "the decode-attention kernel with the out-projection "
                         "(and residual) in its flush")
    ap.add_argument("--conv", choices=M.CONVS, default="xla",
                    help="conv lowering for conv-bearing models (no-op for the LM "
                         "archs)")
    ap.add_argument("--fuse-pool", action="store_true",
                    help="conv→pool megakernel for conv-bearing models (no-op for "
                         "the LM archs)")
    ap.add_argument("--block-k", type=int, default=0,
                    help="K1's K-slice width in lanes (the contraction split over "
                         "ceil(K'/block_k) CTAs of a cluster); 0 → tile cache / "
                         "heuristic")
    ap.add_argument("--tile-cache", default="",
                    help="path to a persisted K1 TileCache (kernels.tuning."
                         "autotune_plans writes one; chip_smoke.py's tile_cache "
                         "phase measures it); its measured plans beat the heuristic")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU ('cpu' runs the kernels' "
                         "plain versions)")
    # -- hardened front end (serving.frontend) -------------------------------
    ap.add_argument("--frontend", action="store_true",
                    help="drive the engine through the front end: seeded Poisson "
                         "arrivals, length-bucketed admission, chunked prefill, "
                         "numeric watchdog with degradation to the unpaired "
                         "fallback engine")
    ap.add_argument("--arrival-rate", type=float, default=10.0,
                    help="offered load in requests per virtual second")
    ap.add_argument("--horizon", type=float, default=1.0,
                    help="arrival window in virtual seconds")
    ap.add_argument("--seed", type=int, default=0, help="workload + fault-schedule seed")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens per monolithic prefill; the tail of "
                         "longer prompts rides the shared decode steps")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="per-request completion deadline (virtual s)")
    ap.add_argument("--fallback-gemm", choices=FALLBACK_GEMMS, default="xla",
                    help="unpaired exact path quarantined requests degrade to: "
                         "torch.matmul (xla) or K1's dense form (pallas)")
    ap.add_argument("--inject", default="",
                    help="fault rates, e.g. 'nan_logits:0.05,kv_poison:0.02' "
                         "(per front-end step; see serving.faults.FAULT_KINDS)")
    args = vars(ap.parse_args(argv))
    if args["tile_cache"] and not Path(args["tile_cache"]).is_file():
        ap.error(f"--tile-cache: no file at {args['tile_cache']}")
    fe_args = {k: args.pop(k) for k in ("arrival_rate", "horizon", "seed", "prefill_chunk",
                                         "deadline", "inject", "fallback_gemm")}
    if args.pop("frontend"):
        if args.pop("prompt_lens"):
            ap.error("--prompt-lens sets a run without --frontend")
        return run_frontend(**args, **fe_args)
    return serve(**args)


if __name__ == "__main__":
    main()
