"""Deterministic fault injection for the hardened serving front end.

The port of ``repro.serving.faults``.  Approximate-compute accelerators are
where numeric faults surface in production: a mis-paired lane, a bad
rounding table or a flaky kernel launch turns into NaN/Inf activations long
before it turns into a crash.  This module simulates those failure modes
*on a schedule*, so the front end's watchdog and degradation policy
(:mod:`repro_torch.serving.guards`) can be tested reproducibly:

- ``nan_logits`` / ``inf_logits`` — corrupt one slot's decode-step logits
  (a transient bad kernel output on the paired path);
- ``kv_poison`` — write NaN into one slot's cached K/V rows, so the *model
  itself* produces non-finite logits on the next step (through the decode
  attention kernel when ``attn="pallas_fused"``);
- ``latency_spike`` — multiply the virtual cost of one batched step;
- ``kernel_failure`` — the step "fails" ``magnitude`` consecutive times
  before succeeding (the front end retries, bounded).  Only simulated: a
  real exception from a kernel launch propagates, nothing catches it.

Every event is an explicit :class:`FaultEvent` pinned to a front-end step;
:meth:`FaultInjector.from_rates` draws a schedule from a numpy seed (the
same draws as the JAX package), materialised up front.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from collections.abc import Mapping, Sequence

import numpy as np
import torch

FAULT_KINDS = (
    "nan_logits", "inf_logits", "kv_poison", "latency_spike", "kernel_failure",
)

#: fault kinds that target one slot's numerics (and must therefore end in a
#: degraded completion or a structured shed — the zero-requests-lost gate)
SLOT_FAULTS = ("nan_logits", "inf_logits", "kv_poison")


class KernelFault(RuntimeError):
    """A (simulated) kernel launch failure on the paired path."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires when the front end reaches ``step``."""

    step: int
    kind: str
    slot: int = 0  # target slot for SLOT_FAULTS; ignored otherwise
    magnitude: float = 4.0  # latency multiplier / consecutive kernel failures

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")


class FaultInjector:
    """Applies a fault schedule to a :class:`~repro_torch.serving.engine.ServeEngine`.

    The injector only mutates state the front end hands it (logits arrays,
    the engine cache) and records everything it actually did in ``fired``.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._by_step: dict[int, list[FaultEvent]] = defaultdict(list)
        for ev in events:
            self._by_step[ev.step].append(ev)
        self.events = tuple(events)
        self.fired: list[FaultEvent] = []

    @classmethod
    def from_rates(
        cls,
        seed: int,
        n_steps: int,
        batch_size: int,
        rates: Mapping[str, float],
        magnitude: float = 4.0,
    ) -> FaultInjector:
        """Bernoulli(rate) draw per (step, kind), slot drawn uniformly —
        deterministic given the seed (the schedule is materialised here,
        never re-drawn at fire time)."""
        unknown = sorted(set(rates) - set(FAULT_KINDS))
        if unknown:
            raise ValueError(f"unknown fault kind(s) {unknown}")
        rng = np.random.default_rng(seed)
        events = []
        for step in range(n_steps):
            for kind in FAULT_KINDS:
                rate = rates.get(kind, 0.0)
                if rate > 0 and rng.random() < rate:
                    events.append(FaultEvent(
                        step=step, kind=kind,
                        slot=int(rng.integers(0, batch_size)),
                        magnitude=magnitude,
                    ))
        return cls(events)

    def events_at(self, step: int, kind: str | None = None) -> list[FaultEvent]:
        evs = self._by_step.get(step, [])
        return [e for e in evs if kind is None or e.kind == kind]

    # -- application helpers (each records what actually fired) --------------
    def corrupt_logits(self, logits: np.ndarray, step: int,
                       active: np.ndarray) -> tuple[np.ndarray, list[FaultEvent]]:
        """Apply the step's nan/inf logits events to a (batch, vocab) host
        array; events targeting inactive slots are dropped (nothing to hit)."""
        out = logits
        applied = []
        for ev in self.events_at(step):
            if ev.kind not in ("nan_logits", "inf_logits"):
                continue
            if ev.slot >= len(active) or not active[ev.slot]:
                continue
            if out is logits:
                out = logits.copy()
            out[ev.slot] = np.nan if ev.kind == "nan_logits" else np.inf
            applied.append(ev)
        self.fired.extend(applied)
        return out, applied

    def poison_kv(self, engine, step: int) -> list[FaultEvent]:
        """Write NaN into the targeted slots' cached K/V (rows the decode
        step will genuinely attend — positions below the slot's pos)."""
        applied = []
        for ev in self.events_at(step, "kv_poison"):
            if ev.slot >= engine.batch_size or not engine.active[ev.slot]:
                continue
            poison_slot_cache(engine, ev.slot)
            applied.append(ev)
        self.fired.extend(applied)
        return applied

    def latency_multiplier(self, step: int) -> float:
        mult = 1.0
        for ev in self.events_at(step, "latency_spike"):
            mult *= max(1.0, ev.magnitude)
            self.fired.append(ev)
        return mult

    def kernel_failures(self, step: int) -> int:
        """Consecutive simulated launch failures at this step (0 → healthy)."""
        n = 0
        for ev in self.events_at(step, "kernel_failure"):
            n += int(ev.magnitude)
            self.fired.append(ev)
        return n


def poison_slot_cache(engine, slot: int) -> None:
    """NaN one slot's attended K/V rows in place: ``[:, slot, :max(1, pos)]``
    of the engine's ``{"k", "v"}`` cache (L, B, S, KH, hd), the positions
    below the slot's pos, so the poison provably reaches the next step's
    logits."""
    upto = max(1, int(engine.pos[slot]))
    for t in engine.cache.values():
        t[:, slot, :upto] = torch.nan
