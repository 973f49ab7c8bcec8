"""Serving driver of the port: prefill + batched greedy decode of an LM.

    # on the GPU (the default): full-size qwen2-1.5b, paired GEMMs and fused
    # decode attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05

    # on the CPU, the kernels' plain versions, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --gemm pallas_paired --attn pallas_fused --device cpu

    # hardened front end: Poisson load + chaos over the paired engine, with
    # graceful degradation to the unpaired fallback engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --gemm pallas_paired --frontend --arrival-rate 20 --horizon 0.5 \
        --inject nan_logits:0.05,kv_poison:0.02,kernel_failure:0.02 --device cpu

The port of ``repro.launch.serve`` without its offline weight folding and
conv lowering.  Weights are random from seed 0 (``models.lm.init_lm``).
Without ``--frontend`` slot ``i`` is prefilled with a random prompt of
``8 + 4·i`` tokens and every slot decodes ``--steps`` tokens (the first from
its prefill); with it, ``serving.frontend`` serves a seeded Poisson workload
(``--seed``) and the run exits non-zero if any request is lost.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paired_matmul as pm
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
                 pair_block_n: int, gemm: str, attn: str, device: str | None):
    """Config, device, the model (seed 0, unpaired) and the engine over it
    (paired by its constructor under ``gemm="pallas_paired"``), and the
    seconds the engine took to build; prints the pairing report."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    model = M.init_lm(cfg, 0, device=dev)
    knobs = M.PerfKnobs(q_chunk=32, k_chunk=32, gemm=gemm, attn=attn,
                        pair_block_n=pair_block_n, pair_rounding=pair_rounding)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, max_seq=max_seq, batch_size=batch, knobs=knobs)
    pairing_s = time.perf_counter() - t0
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
) -> dict:
    """Build the engine, serve one prompt per slot, print what the JAX
    package's driver prints, and return the run's record: the engine, the
    prompts and tokens, seconds spent pairing, per-request prefill and
    per-step decode wall times (ms; each ends in a device-to-host copy of the
    tokens, so it includes the device work), and the kernel launches made
    during the prefills and during the decode steps."""
    cfg, dev, _, eng, pairing_s = _build_engine(
        arch=arch, smoke=smoke, batch=batch, max_seq=max_seq, pair_rounding=pair_rounding,
        pair_block_n=pair_block_n, gemm=gemm, attn=attn, device=device)

    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, size=(8 + 4 * i,)).astype(np.int32)
               for i in range(batch)}
    outs: dict[int, list[int]] = {}
    prefill_ms, step_ms = [], []
    t_all = time.perf_counter()
    before = kernel_launches()
    for slot, prompt in prompts.items():
        t0 = time.perf_counter()
        outs[slot] = [eng.add_request(slot, prompt)]
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
        "engine": eng, "prompts": prompts, "outputs": outs, "pairing_s": pairing_s,
        "prefill_ms": prefill_ms, "step_ms": step_ms, "seconds": dt,
        "tokens_per_s": batch * steps / dt,
        "launches": {"prefill": prefill_launches, "decode": decode_launches},
    }


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
) -> ServeReport:
    """Simulated-load run: Poisson arrivals + optional chaos, degrading to a
    fresh unpaired fallback engine on the same (unpaired) weights.  Prints
    the report's summary and the kernel launches of the run; raises
    ``SystemExit`` if any request is lost."""
    cfg, dev, model, eng, _ = _build_engine(
        arch=arch, smoke=smoke, batch=batch, max_seq=max_seq, pair_rounding=pair_rounding,
        pair_block_n=pair_block_n, gemm=gemm, attn=attn, device=device)
    # `model` is the pre-pairing model (the engine paired its own copy), so
    # the fallback runs plain exact GEMMs (decode attention as the primary's)
    fb_knobs = dataclasses.replace(eng.knobs, gemm="xla", pair_rounding=0.0)
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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config of the arch")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--pair-rounding", type=float, default=0.0,
                    help="rounding size of the pallas_paired LM pairing; 0.0 is "
                         "the exact-parity point")
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
    ap.add_argument("--inject", default="",
                    help="fault rates, e.g. 'nan_logits:0.05,kv_poison:0.02' "
                         "(per front-end step; see serving.faults.FAULT_KINDS)")
    args = vars(ap.parse_args(argv))
    fe_args = {k: args.pop(k) for k in ("arrival_rate", "horizon", "seed", "prefill_chunk",
                                         "deadline", "inject")}
    if args.pop("frontend"):
        run_frontend(**args, **fe_args)
    else:
        serve(**args)


if __name__ == "__main__":
    main()
