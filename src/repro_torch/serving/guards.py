"""Numeric watchdog + graceful degradation policy for the serving front end.

The port of ``repro.serving.guards`` (host numpy, unchanged in behaviour).
The subtractor path trades exactness knobs (pairing, rounding) for power,
so the serving layer assumes its numerics *can* go bad and bounds the blast
radius of a bad slot to one quarantined slot, never a garbage token stream.
The watchdog checks every decode step's logits for NaN/Inf and overflow; a
flagged slot is quarantined (evicted + cache-scrubbed, admission refused for
a cooldown) and its request is retried with bounded backoff on the
**unpaired** fallback engine (``gemm="xla"``: exact arithmetic), or shed
with a structured reason once retries are exhausted.  Every action lands in
a structured :class:`IncidentLog`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    overflow: float = 1e6  # |logit| above this is treated as corrupt
    max_retries: int = 2  # degraded re-admissions per request before shedding
    backoff_s: float = 0.05  # virtual re-admission delay; doubles per retry
    quarantine_steps: int = 2  # front-end ticks a flagged slot sits out


@dataclasses.dataclass
class Incident:
    """One structured incident-log record (JSON-serializable via as_dict)."""

    time: float  # virtual seconds
    step: int  # front-end step index
    engine: str  # "primary" | "fallback"
    slot: int
    rid: int  # request id (-1 when no request occupied the slot)
    kind: str  # "nan" | "inf" | "overflow" | fault kind | "kernel_failure"
    action: str  # "injected" | "quarantined" | "retried_degraded" | "shed"
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class IncidentLog:
    def __init__(self):
        self.records: list[Incident] = []

    def add(self, **kw: Any) -> Incident:
        inc = Incident(**kw)
        self.records.append(inc)
        return inc

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            key = f"{r.action}:{r.kind}"
            out[key] = out.get(key, 0) + 1
        return out

    def for_request(self, rid: int) -> list[Incident]:
        return [r for r in self.records if r.rid == rid]

    def as_dicts(self) -> list[dict]:
        return [r.as_dict() for r in self.records]

    def __len__(self) -> int:
        return len(self.records)


def check_logits(
    logits: np.ndarray | None,
    active: np.ndarray,
    overflow: float = GuardConfig.overflow,
) -> dict[int, str]:
    """Per-slot corruption verdicts over a (batch, vocab) decode-step logits
    array: ``{slot: "nan" | "inf" | "overflow"}`` for every *active* slot
    whose logits are unusable.  Inactive slots are never flagged."""
    if logits is None:
        return {}
    bad: dict[int, str] = {}
    for slot in np.flatnonzero(np.asarray(active, bool)):
        row = logits[slot]
        if np.isnan(row).any():
            bad[int(slot)] = "nan"
        elif np.isinf(row).any():
            bad[int(slot)] = "inf"
        elif np.abs(row).max() > overflow:
            bad[int(slot)] = "overflow"
    return bad


class NumericWatchdog:
    """Quarantine + retry/shed policy over one engine's decode steps.

    The watchdog owns the *decision* (quarantine the slot; retry the request
    degraded with backoff, or shed it) and the incident log; the front end
    owns the queue, so re-admission mechanics stay there.
    """

    def __init__(self, cfg: GuardConfig | None = None,
                 log: IncidentLog | None = None):
        self.cfg = cfg or GuardConfig()
        self.log = log if log is not None else IncidentLog()

    def scan(self, engine, engine_name: str, *, step: int,
             now: float) -> dict[int, str]:
        """Check the engine's last decode-step logits; returns flagged slots."""
        return check_logits(engine.last_logits, engine.active,
                            self.cfg.overflow)

    def quarantine(self, engine, engine_name: str, slot: int, reason: str, *,
                   step: int, now: float, rid: int) -> str:
        """Quarantine ``slot`` and decide the request's fate.

        Returns the action taken: ``"retried_degraded"`` (the front end must
        re-enqueue the request for the fallback engine, not before
        :meth:`backoff` seconds from now) or ``"shed"`` (retries exhausted).
        The watchdog counts prior retries through the incident log.
        """
        engine.quarantine_slot(slot)
        self.log.add(time=now, step=step, engine=engine_name, slot=slot,
                     rid=rid, kind=reason, action="quarantined",
                     detail=f"slot evicted + cache scrubbed; cooldown "
                            f"{self.cfg.quarantine_steps} step(s)")
        n_prior = sum(
            1 for r in self.log.records
            if r.rid == rid and r.action == "retried_degraded"
        )
        if n_prior >= self.cfg.max_retries:
            self.log.add(time=now, step=step, engine=engine_name, slot=slot,
                         rid=rid, kind=reason, action="shed",
                         detail=f"retries exhausted ({n_prior}/"
                                f"{self.cfg.max_retries})")
            return "shed"
        self.log.add(time=now, step=step, engine=engine_name, slot=slot,
                     rid=rid, kind=reason, action="retried_degraded",
                     detail=f"retry {n_prior + 1}/{self.cfg.max_retries} on "
                            f"the unpaired fallback path, backoff "
                            f"{self.backoff(n_prior):.3f}s")
        return "retried_degraded"

    def backoff(self, n_prior_retries: int) -> float:
        """Bounded exponential backoff before a degraded re-admission."""
        return self.cfg.backoff_s * (2.0 ** n_prior_retries)
