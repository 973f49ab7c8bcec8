"""Serving driver of the port: prefill + batched greedy decode of an LM.

    # on the GPU (the default): full-size qwen2-1.5b, paired GEMMs and fused
    # decode attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --gemm pallas_paired --attn pallas_fused --pair-rounding 0.05

    # on the CPU, the kernels' plain versions, a reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --gemm pallas_paired --attn pallas_fused --device cpu

The port of ``repro.launch.serve`` without its front end, offline weight
folding and conv lowering.  Weights are random from seed 0
(``models.lm.init_lm``); slot ``i`` is prefilled with a random prompt of
``8 + 4·i`` tokens and every slot decodes ``--steps`` tokens (the first from
its prefill).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paired_matmul as pm
from repro_torch.models import lm as M
from repro_torch.serving.engine import ServeEngine


def kernel_launches() -> dict[str, int]:
    """Launches of each kernel since its counter was last reset."""
    return {"paired_matmul": pm.launch_count(), "decode_attention": da.launch_count()}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


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
    serve(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
