"""Shared helpers of the port's benchmarks: result files, text tables,
full-fp32 comparisons and CUDA-event timing.

``write_result`` and ``fmt_table`` are the counterparts of
``benchmarks/common.py``'s; ``device_ms`` takes the place of the JAX
package's ``tuning.measure`` (a host clock).  Results go to ``benchmarks/results/torch_<name>.json`` at
the root of the checkout, beside (never over) the JAX benchmarks' files.
"""
from __future__ import annotations

import contextlib
import json
from collections.abc import Sequence
from pathlib import Path
from typing import Any

import torch

RESULTS_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "results"


def write_result(name: str, payload: Any) -> Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"torch_{name}.json"
    path.write_text(json.dumps(payload, indent=2, default=str))
    return path


def fmt_table(rows: Sequence[dict], cols: Sequence[str], title: str = "") -> str:
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4f}" if abs(v) < 100 else f"{v:.1f}"
        return str(v)

    widths = {c: max(len(c), *(len(fmt(r.get(c, ""))) for r in rows)) for c in cols}
    out = []
    if title:
        out.append(f"== {title} ==")
    out.append(" | ".join(c.rjust(widths[c]) for c in cols))
    out.append("-+-".join("-" * widths[c] for c in cols))
    for r in rows:
        out.append(" | ".join(fmt(r.get(c, "")).rjust(widths[c]) for c in cols))
    return "\n".join(out)


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matmuls in full precision inside the block.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits), which would miss the benchmarks' ≤ 1e-5 gates against
    ``F.conv2d``; the previous settings come back on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def device_ms(fn, device: torch.device, reps: int = 5, warmup: int = 1) -> float | None:
    """Median ms of ``fn()`` on the card, each call between CUDA events;
    ``None`` on the CPU, where no device time exists."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]
