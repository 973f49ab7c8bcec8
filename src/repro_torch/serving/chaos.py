"""The chaos workload of the JAX package's serving benchmark
(``benchmarks/serving.py``): its workload shape, offered loads, front-end
settings and fault schedule, kept here so that the port's serving bench
(``repro_torch.benchmarks.serving``), its smoke run and its tests build the
same run from one place.

``chaos_workload`` gives the same requests as the benchmark's
``poisson_workload`` call for the same vocab and rate, ``chaos_schedule``
the same pinned faults and (unless ``quick``) seeded background draw,
``frontend_config`` the same ``FrontendConfig``.
"""
from __future__ import annotations

from repro_torch.serving.faults import FaultEvent, FaultInjector
from repro_torch.serving.frontend import FrontendConfig, Request, poisson_workload
from repro_torch.serving.guards import GuardConfig

SEED = 0
BATCH = 4
MAX_SEQ = 48
HORIZON_S = 0.6
PROMPT_LEN = (3, 20)
NEW_TOKENS = (2, 8)
CHAOS_RPS = 30.0
LOADS_RPS = (10.0, 25.0, 60.0)
LOADS_RPS_QUICK = (10.0, 40.0)


def frontend_config() -> FrontendConfig:
    return FrontendConfig(prefill_chunk=6, queue_timeout_s=1.0,
                          guard=GuardConfig(max_retries=2, quarantine_steps=2))


def chaos_workload(vocab: int, rate: float) -> list[Request]:
    return poisson_workload(rate_rps=rate, horizon_s=HORIZON_S, seed=SEED, vocab=vocab,
                            prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS)


def chaos_schedule(quick: bool = False) -> FaultInjector:
    """Pinned early-step faults (they hit occupied slots at this load) plus,
    unless ``quick``, a seeded low-rate background draw across the whole
    run."""
    pinned = [
        FaultEvent(step=3, kind="nan_logits", slot=0),
        FaultEvent(step=5, kind="kv_poison", slot=1),
        FaultEvent(step=7, kind="inf_logits", slot=2),
        FaultEvent(step=9, kind="kernel_failure", magnitude=2),
        FaultEvent(step=11, kind="latency_spike", magnitude=8.0),
        FaultEvent(step=14, kind="kv_poison", slot=3),
    ]
    background = () if quick else FaultInjector.from_rates(
        SEED + 1, n_steps=256, batch_size=BATCH,
        rates={"nan_logits": 0.02, "kv_poison": 0.01, "kernel_failure": 0.01,
               "latency_spike": 0.02},
        magnitude=2.0).events
    return FaultInjector([*pinned, *background])
