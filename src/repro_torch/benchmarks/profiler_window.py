"""Whether ``torch.profiler`` sees every kernel of a traced step.

The CUDA tracer can begin capturing some milliseconds after its window opens
and then loses the window's first kernels.  ``trace_step`` runs a step
``pad_s`` into the window, between two marker kernels (``torch.cuda._sleep``'s
``spin_kernel``, which no step of the port launches), so that a caller can
tell a whole trace from a cut one.  ``main`` measures the loss on a synthetic
step, three runs of distinct kernels, at several paddings:

    python -m repro_torch.benchmarks.profiler_window --reps 40 --pads 0,0.05,0.1

It prints one JSON object: for each padding the traces taken, those that
missed kernels of the step, how many of the first run each of those kept,
and how many cut traces still held both markers (0 means the markers catch
every cut).  It runs on the GPU only: the tracer under test is CUDA's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

MARK_KERNEL = "spin_kernel"
RUNS = (("add", 300), ("mul", 1500), ("abs", 300))


def trace_step(step, pad_s: float = 0.1):
    """Trace one call of ``step`` after a traced and dropped warm-up call;
    returns the profiler and the call's wall ms.  The step starts ``pad_s``
    into the window and is fenced by a marker kernel on each side."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
        time.sleep(pad_s)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
    return prof, wall


def device_kernels(prof) -> list[tuple[str, int, float]]:
    """``(name, launches, self device us)`` of every kernel in the trace,
    without the profiler's own step spans."""
    out = []
    for ev in prof.key_averages():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        if getattr(ev, "is_user_annotation", False) or ev.key.startswith("ProfilerStep"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        out.append((ev.key, ev.count, us))
    return out


def _run_of(kernel: str) -> str | None:
    name = kernel.lower()
    if MARK_KERNEL in name:
        return "marker"
    if "abs" in name:
        return "abs"
    if "mulfunctor" in name:
        return "mul"
    if "add" in name:
        return "add"
    return None


def probe(pads: list[float], reps: int) -> list[dict]:
    x = torch.zeros(1024, device="cuda")
    ops = {"add": lambda: x.add_(1), "mul": lambda: x.mul_(1.0), "abs": lambda: x.abs_()}

    def step():
        for run, n in RUNS:
            for _ in range(n):
                ops[run]()

    rows = []
    for pad in pads:
        cut, kept_first, both_marks = 0, [], 0
        for _ in range(reps):
            prof, _ = trace_step(step, pad)
            n = {"add": 0, "mul": 0, "abs": 0, "marker": 0, None: 0}
            for kernel, count, _ in device_kernels(prof):
                n[_run_of(kernel)] += count
            if any(n[run] != want for run, want in RUNS) or n[None]:
                cut += 1
                kept_first.append(n["add"])
                both_marks += n["marker"] == 2
        rows.append({"pad_s": pad, "traces": reps, "cut": cut,
                     "first_run_kept": kept_first, "cut_with_both_markers": both_marks})
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--pads", default="0,0.05,0.1", help="seconds, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the probe traces CUDA kernels")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "step_kernels": sum(n for _, n in RUNS),
           "rows": probe([float(p) for p in args.pads.split(",")], args.reps)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
