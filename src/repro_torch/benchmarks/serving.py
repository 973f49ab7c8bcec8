"""Load + chaos bench for the hardened serving front end.

The port of ``benchmarks/serving.py``.  Two scenarios over the paired
engine (qwen2 smoke, fp32, ``gemm="pallas_paired"`` at rounding 0, the
exact-parity point) with an unpaired fallback engine (``gemm="xla"``:
``torch.matmul``) behind it; the workload shape, loads, front-end
settings and fault schedule are ``serving/chaos.py``'s, which the tests
hold equal to the JAX bench's:

1. **Load sweep** (:func:`load_sweep`): seeded Poisson arrivals at each
   offered load through the same front end.  p50/p99 completion latency,
   p50 time to first token and tokens/s on the virtual clock
   (deterministic per seed); no request may be lost.
2. **Chaos run** (:func:`chaos_run`): the same workload at half the top
   load with deterministic fault injection (NaN/Inf logits, KV-cache
   poisoning, kernel launch failures, latency spikes).  Its gates:

   - **zero requests lost**: every request ends completed, degraded, or
     shed with a reason;
   - **every slot-targeted fault accounted**: the request in a faulted
     slot ends degraded or shed, never plain-completed;
   - **r=0 token parity**: every completion's tokens equal the unpaired
     reference engine's greedy decode of its prompt, at least one of them
     degraded.  Where a request's tokens leave the reference's, the record
     names the step and the reference's top-2 logit margin there (a near
     tie on random weights, or a fault).

``chip_smoke.py`` runs both functions on full-width engines too.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only serving [--quick]
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.benchmarks.common import fmt_table, full_fp32, write_result
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import lm as M
from repro_torch.serving import ServeEngine, ServeFrontend, chaos, faulted_request_ids

ARCH = "qwen2-1.5b"
_BASE = dict(q_chunk=16, k_chunk=16, remat="none")
#: the load sweep's row: the JAX bench's fields, then the report's counts
SWEEP_FIELDS = ("offered_rps", "requests", "completed", "shed", "p50_s", "p99_s",
                "ttft_p50_s", "tok_per_s")


def engines(cfg, model: M.LM) -> tuple[ServeEngine, ServeEngine, ServeEngine]:
    """(primary paired at r=0, unpaired fallback, unpaired batch-1
    reference) over ``model``, the JAX bench's three engines."""
    paired = M.PerfKnobs(**_BASE, gemm="pallas_paired", pair_rounding=0.0)
    plain = M.PerfKnobs(**_BASE)
    return (ServeEngine(cfg, model, max_seq=chaos.MAX_SEQ, batch_size=chaos.BATCH, knobs=paired),
            ServeEngine(cfg, model, max_seq=chaos.MAX_SEQ, batch_size=chaos.BATCH, knobs=plain),
            ServeEngine(cfg, model, max_seq=chaos.MAX_SEQ, batch_size=1, knobs=plain))


def reset_slots(*engs: ServeEngine) -> None:
    """Every slot of each engine free, scrubbed and out of quarantine."""
    for eng in engs:
        for slot in range(eng.batch_size):
            eng.clear_quarantine(slot)
            eng.release_slot(slot)


def load_sweep(primary: ServeEngine, fallback: ServeEngine, loads, vocab: int) -> list[dict]:
    """The chaos workload at each offered load (req/s) through a front end
    over ``primary`` and ``fallback`` (their slots reset first), no faults.
    A row a load: the JAX bench's :data:`SWEEP_FIELDS`, then ``degraded``,
    ``lost``, ``shed_reasons``, ``steps``, ``generated_tokens``,
    ``incidents`` and the host's ``wall_s``.  Raises ``AssertionError`` on
    a lost request."""
    rows = []
    for rate in loads:
        reset_slots(primary, fallback)
        report = ServeFrontend(primary, fallback, chaos.frontend_config()).run(
            chaos.chaos_workload(vocab, rate), offered_load_rps=rate)
        s = report.summary()
        if s["lost"]:
            raise AssertionError(f"load {rate}: {s['lost']} request(s) lost")
        rows.append({
            "offered_rps": rate, "requests": s["n_requests"], "completed": s["completed"],
            "shed": s["shed"], "p50_s": s["latency_s"]["p50"], "p99_s": s["latency_s"]["p99"],
            "ttft_p50_s": s["ttft_s"]["p50"], "tok_per_s": s["tokens_per_s_virtual"],
            **{k: s[k] for k in ("degraded", "lost", "shed_reasons", "steps",
                                 "generated_tokens", "incidents", "wall_s")},
        })
    return rows


@torch.no_grad()
def divergence(reference: ServeEngine, r, want: list[int]) -> dict:
    """Where request ``r``'s tokens first leave ``want`` (the reference's),
    and the reference model's top-2 logit margin at that position."""
    cfg = reference.cfg
    t = next(i for i, (a, b) in enumerate(zip(r.tokens + [None], want)) if a != b)
    seq = torch.as_tensor(list(r.prompt) + want[:t], device=reference.device)[None]
    logits = M.lm_forward(cfg, reference.model, seq)[0][0, -1, : cfg.vocab]
    top2 = torch.topk(logits, 2).values
    return {"rid": r.rid, "state": r.state, "step": t, "got": r.tokens[t: t + 1],
            "want": want[t], "ref_top2_margin": float(top2[0] - top2[1])}


def chaos_run(primary: ServeEngine, fallback: ServeEngine, reference: ServeEngine, faults,
              rate: float) -> tuple[dict, list[str]]:
    """The chaos workload at ``rate`` req/s with ``faults`` (a
    ``FaultInjector``) through a front end over ``primary`` and
    ``fallback`` (their slots reset first), then every completion against
    ``reference``'s greedy decode (batch 1, unpaired; it launches no
    kernel).  Returns the JAX bench's chaos record (the report's summary,
    ``wall_s``, the faults scheduled and fired, the faulted requests,
    ``parity_checked``, the incident log; ``diverged`` besides) and the
    failed gates."""
    reset_slots(primary, fallback)
    fe = ServeFrontend(primary, fallback, chaos.frontend_config(), faults=faults)
    t0 = time.time()
    report = fe.run(chaos.chaos_workload(primary.cfg.vocab, rate), offered_load_rps=rate)
    summary = report.summary()
    wall = time.time() - t0

    failures: list[str] = []
    if summary["lost"]:
        failures.append(f"{summary['lost']} request(s) lost under chaos")
    faulted = faulted_request_ids(report)
    if not faulted:
        failures.append("chaos schedule injected no slot-targeted faults into occupied "
                        "slots: the gate gated nothing")
    by_rid = {r.rid: r for r in report.requests}
    for rid in sorted(faulted):
        r = by_rid[rid]
        if r.state == "shed" and not r.shed_reason:
            failures.append(f"rid {rid}: shed without a structured reason")
        elif r.state not in ("degraded", "shed"):
            failures.append(f"rid {rid}: took a numeric fault but ended {r.state!r}: its "
                            "tokens never went through the exact fallback path")
    n_parity, diverged = {"completed": 0, "degraded": 0}, []
    for r in report.requests:
        if r.state not in ("completed", "degraded"):
            continue
        want = reference.generate({0: r.prompt}, n_steps=r.max_new_tokens)[0]
        reference.release_slot(0)
        if r.tokens == want:
            n_parity[r.state] += 1
        else:
            d = divergence(reference, r, want)
            diverged.append(d)
            failures.append(f"rid {r.rid} ({r.state}): token stream diverged from the "
                            f"unpaired reference at rounding 0 (step {d['step']}, "
                            f"reference top-2 margin {d['ref_top2_margin']:.3g})")
    if n_parity["degraded"] == 0:
        failures.append("no request completed on the degraded path: the parity gate "
                        "gated nothing")
    record = {**summary, "wall_s": round(wall, 3), "scheduled_faults": len(faults.events),
              "fired_faults": len(faults.fired), "faulted_requests": sorted(faulted),
              "parity_checked": n_parity, "diverged": diverged,
              "incident_log": report.incidents.as_dicts()}
    return record, failures


def run(quick: bool = False, *, device=None, model: M.LM | None = None) -> dict:
    """The JAX bench's run: qwen2-1.5b smoke in fp32, seed-0 weights made
    on ``device`` (the GPU unless ``"cpu"`` is asked for) or ``model``'s;
    the load sweep, then the chaos run, on one set of engines (each run
    resets their slots).
    Writes ``benchmarks/results/torch_serving.json``; raises
    ``AssertionError`` on a failed gate."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    if model is None:
        model = M.init_lm(cfg, chaos.SEED, device=resolve_device(device))
    dev = model.embed.device
    loads = chaos.LOADS_RPS_QUICK if quick else chaos.LOADS_RPS
    with full_fp32():
        primary, fallback, reference = engines(cfg, model)
        sweep = load_sweep(primary, fallback, loads, cfg.vocab)
        print(fmt_table(sweep, SWEEP_FIELDS,
                        title="serving load sweep (virtual clock, Poisson arrivals, no faults)"))
        rate = loads[-1] / 2
        faults = chaos.chaos_schedule(quick)
        record, failures = chaos_run(primary, fallback, reference, faults, rate)
    print(fmt_table([{"requests": record["n_requests"], "completed": record["completed"],
                      "degraded": record["degraded"], "shed": record["shed"],
                      "faulted": len(record["faulted_requests"]),
                      "incidents": len(record["incident_log"]),
                      "p99_s": record["latency_s"]["p99"]}],
                    ["requests", "completed", "degraded", "shed", "faulted", "incidents",
                     "p99_s"],
                    title=f"chaos run @ {rate} req/s ({len(faults.events)} scheduled fault(s))"))
    n_parity = record["parity_checked"]
    print(f"[serving] r=0 parity: {n_parity['degraded']} degraded + {n_parity['completed']} "
          f"clean completions match the unpaired reference; {len(record['diverged'])} diverged")
    payload = {"seed": chaos.SEED, "batch": chaos.BATCH, "max_seq": chaos.MAX_SEQ,
               "device": dev.type, "load_sweep": sweep, "chaos": record, "failures": failures}
    write_result("serving", payload)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"perf_summary": {"load_sweep": sweep,
                             "chaos": {k: v for k, v in record.items() if k != "incident_log"}}}
