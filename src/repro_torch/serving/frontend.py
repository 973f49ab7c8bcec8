"""Hardened serving front end over :class:`~repro_torch.serving.engine.ServeEngine`.

The port of ``repro.serving.frontend`` (host Python; the scheduling, the
virtual clock and the report are the JAX package's, decision for decision).
Continuous batching under simulated load: seeded Poisson arrivals feed a
bounded request queue; admission is length-bucketed into the engine's free
slots; long prompts prefill in chunks (an initial chunk through the real
prefill, the tail piggybacked one token per shared decode step, so a long
prompt never stalls the other slots' decode); per-request deadlines and a
queue timeout shed work that can't be served in time, with structured
reasons.  A :class:`~repro_torch.serving.guards.NumericWatchdog` inspects
every decode step's logits and degrades bad slots to the **unpaired**
fallback engine (exact arithmetic) with bounded backoff.

Time is *virtual*: each batched decode step and each prefilled token charges
a configured cost, and fault-injected latency spikes multiply it, so p50/p99
latency and tokens/sec are deterministic for a given seed; the report also
records the run's wall time (``wall_s``), which on the GPU includes every
kernel the engines launch.

Degradation is driven only by the logits check and by injected
:mod:`~repro_torch.serving.faults` events.  A real exception from a kernel
launch is not caught here: it propagates to the caller.
"""
from __future__ import annotations

import dataclasses
import time as _time
from collections import deque

import numpy as np

from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import SLOT_FAULTS, FaultInjector
from repro_torch.serving.guards import GuardConfig, IncidentLog, NumericWatchdog

TERMINAL_STATES = ("completed", "degraded", "shed")


@dataclasses.dataclass
class Request:
    """One serving request plus its full lifecycle record."""

    rid: int
    prompt: np.ndarray  # (plen,) int32
    max_new_tokens: int
    arrival: float  # virtual seconds
    # lifecycle (filled by the front end):
    state: str = "queued"  # queued | running | completed | degraded | shed
    tokens: list[int] = dataclasses.field(default_factory=list)
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    shed_reason: str | None = None
    retries: int = 0
    degraded: bool = False  # ever routed to the fallback path
    engine: str | None = None  # "primary" | "fallback" while running
    slot: int | None = None
    prefill_done: int = 0  # prompt tokens absorbed so far (chunked prefill)
    not_before: float = 0.0  # backoff: earliest virtual re-admission time

    @property
    def plen(self) -> int:
        return len(self.prompt)

    def latency(self) -> float | None:
        return None if self.finish_time is None else self.finish_time - self.arrival

    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    max_queue: int = 64  # arrivals beyond this are shed ("queue_full")
    prefill_chunk: int = 8  # prompt tokens per monolithic prefill call;
    # the rest of a long prompt rides the shared decode steps 1 tok/step
    bucket_width: int = 8  # length-bucket granularity for admission order
    deadline_s: float = float("inf")  # completion deadline after arrival
    queue_timeout_s: float = float("inf")  # max queue wait before shedding
    step_cost_s: float = 0.01  # virtual cost of one batched decode step
    prefill_cost_s: float = 0.002  # virtual cost per prefilled prompt token
    max_kernel_retries: int = 3  # simulated-launch-failure retries per step
    max_steps: int = 100_000  # hard loop bound: a scheduling bug fails fast
    guard: GuardConfig = dataclasses.field(default_factory=GuardConfig)


def poisson_workload(
    *,
    rate_rps: float,
    horizon_s: float,
    seed: int,
    vocab: int,
    prompt_len: tuple[int, int] = (4, 24),
    new_tokens: tuple[int, int] = (4, 12),
) -> list[Request]:
    """Seeded Poisson arrival process with mixed prompt/output lengths.

    Inter-arrival gaps are Exponential(rate); prompt and output lengths are
    uniform over the given inclusive-exclusive ranges.  Deterministic for a
    given seed — the bench's offered-load axis.
    """
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t > horizon_s:
            break
        plen = int(rng.integers(*prompt_len))
        reqs.append(Request(
            rid=len(reqs),
            prompt=rng.integers(0, vocab, size=(plen,)).astype(np.int32),
            max_new_tokens=int(rng.integers(*new_tokens)),
            arrival=t,
        ))
    return reqs


def _percentiles(values: list[float]) -> dict[str, float | None]:
    if not values:
        return {"p50": None, "p99": None}
    arr = np.asarray(values, np.float64)
    return {"p50": round(float(np.percentile(arr, 50)), 6),
            "p99": round(float(np.percentile(arr, 99)), 6)}


@dataclasses.dataclass
class ServeReport:
    """Everything one load run produced, plus the summary the bench emits."""

    requests: list[Request]
    incidents: IncidentLog
    virtual_time: float
    wall_s: float
    steps: int
    offered_load_rps: float | None = None

    def by_state(self) -> dict[str, list[Request]]:
        out: dict[str, list[Request]] = {s: [] for s in (*TERMINAL_STATES, "other")}
        for r in self.requests:
            out[r.state if r.state in TERMINAL_STATES else "other"].append(r)
        return out

    def lost(self) -> list[Request]:
        """Requests not in a terminal state — must always be empty."""
        return [r for r in self.requests if r.state not in TERMINAL_STATES]

    def summary(self) -> dict:
        by = self.by_state()
        done = by["completed"] + by["degraded"]
        shed_reasons: dict[str, int] = {}
        for r in by["shed"]:
            shed_reasons[r.shed_reason or "?"] = (
                shed_reasons.get(r.shed_reason or "?", 0) + 1)
        n_tokens = sum(len(r.tokens) for r in done)
        return {
            "n_requests": len(self.requests),
            "completed": len(by["completed"]),
            "degraded": len(by["degraded"]),
            "shed": len(by["shed"]),
            "shed_reasons": shed_reasons,
            "lost": len(self.lost()),
            "offered_load_rps": self.offered_load_rps,
            "latency_s": _percentiles([r.latency() for r in done]),
            "ttft_s": _percentiles(
                [r.ttft() for r in done if r.ttft() is not None]),
            "generated_tokens": n_tokens,
            "tokens_per_s_virtual": (
                round(n_tokens / self.virtual_time, 3) if self.virtual_time else None),
            "virtual_time_s": round(self.virtual_time, 6),
            "wall_s": round(self.wall_s, 3),
            "steps": self.steps,
            "incidents": self.incidents.counts(),
        }


class ServeFrontend:
    """Drives a primary (possibly subtractor-paired) engine and an optional
    exact fallback engine through one simulated-load run."""

    def __init__(
        self,
        primary: ServeEngine,
        fallback: ServeEngine | None = None,
        cfg: FrontendConfig | None = None,
        faults: FaultInjector | None = None,
    ):
        self.primary = primary
        self.fallback = fallback
        self.cfg = cfg or FrontendConfig()
        self.faults = faults
        self.log = IncidentLog()
        self.watchdog = NumericWatchdog(self.cfg.guard, self.log)
        # (engine_name, slot) -> Request
        self.running: dict[tuple[str, int], Request] = {}
        self._quarantine_until: dict[tuple[str, int], int] = {}

    # -- helpers --------------------------------------------------------------
    def _engines(self):
        yield "primary", self.primary
        if self.fallback is not None:
            yield "fallback", self.fallback

    def _engine(self, name: str) -> ServeEngine:
        return self.primary if name == "primary" else self.fallback

    def _shed(self, r: Request, reason: str, *, now: float, step: int) -> None:
        if r.slot is not None and r.engine is not None:
            self._engine(r.engine).release_slot(r.slot)
            self.running.pop((r.engine, r.slot), None)
        r.state, r.shed_reason, r.finish_time = "shed", reason, now
        r.engine = r.slot = None
        self.log.add(time=now, step=step, engine=r.engine or "-",
                     slot=-1, rid=r.rid, kind=reason, action="shed")

    def _bucket_order(self, queue: list[Request], now: float) -> list[Request]:
        """Length-bucketed admission order: serve the bucket of the oldest
        eligible request first (so similar-length prompts batch together),
        oldest-first inside a bucket, then everything else oldest-first."""
        eligible = [r for r in queue if r.not_before <= now]
        if not eligible:
            return []
        w = max(1, self.cfg.bucket_width)
        lead = min(eligible, key=lambda r: r.arrival)
        lead_bucket = lead.plen // w
        return sorted(
            eligible,
            key=lambda r: (r.plen // w != lead_bucket, r.arrival, r.rid),
        )

    def _admit(self, r: Request, name: str, slot: int, now: float) -> float:
        """Prefill the first chunk into ``slot``; returns the virtual cost."""
        eng = self._engine(name)
        c0 = min(r.plen, max(1, self.cfg.prefill_chunk))
        first = eng.add_request(slot, r.prompt[:c0])
        r.state, r.engine, r.slot = "running", name, slot
        r.admit_time = now
        r.prefill_done = c0
        r.tokens = []
        if c0 < r.plen:
            # chunked prefill: the tail rides the shared decode steps —
            # override the engine's sampled token with the next prompt token
            eng.force_token(slot, int(r.prompt[c0]))
        else:
            r.tokens.append(int(first))
            r.first_token_time = now + self.cfg.prefill_cost_s * c0
        self.running[(name, slot)] = r
        cost = self.cfg.prefill_cost_s * c0
        # a one-token request is already done after prefill
        self._finish_if_done(r, now=now + cost)
        return cost

    def _account_token(self, r: Request, tok: int, *, now: float) -> None:
        """One decode-step emission for a running request: either consumes
        one more prompt token (chunked prefill) or appends a generated one."""
        eng = self._engine(r.engine)
        if r.prefill_done < r.plen:
            r.prefill_done += 1
            if r.prefill_done < r.plen:
                eng.force_token(r.slot, int(r.prompt[r.prefill_done]))
            else:
                # the step that absorbed the last prompt token emitted the
                # first generated token
                r.tokens.append(tok)
                r.first_token_time = now
        else:
            r.tokens.append(tok)

    def _finish_if_done(self, r: Request, *, now: float) -> None:
        if len(r.tokens) < r.max_new_tokens:
            return
        r.tokens = r.tokens[: r.max_new_tokens]
        self._engine(r.engine).release_slot(r.slot)
        self.running.pop((r.engine, r.slot), None)
        r.state = "degraded" if r.degraded else "completed"
        r.finish_time = now
        r.engine = r.slot = None

    def _degrade(self, r: Request, name: str, slot: int, reason: str,
                 queue: list[Request], *, now: float, step: int) -> None:
        """Watchdog verdict for a flagged slot: quarantine it, then retry the
        request from its prompt on the fallback path or shed it."""
        action = self.watchdog.quarantine(
            self._engine(name), name, slot, reason,
            step=step, now=now, rid=r.rid)
        self.running.pop((name, slot), None)
        self._quarantine_until[(name, slot)] = step + self.cfg.guard.quarantine_steps
        if action == "shed":
            r.state, r.shed_reason, r.finish_time = "shed", f"retries_exhausted:{reason}", now
            r.engine = r.slot = None
            return
        r.not_before = now + self.watchdog.backoff(r.retries)
        r.retries += 1
        r.degraded = True
        r.state, r.engine, r.slot = "queued", None, None
        r.tokens = []
        r.prefill_done = 0
        r.first_token_time = None
        queue.append(r)

    # -- the loop -------------------------------------------------------------
    def run(self, workload: list[Request],
            offered_load_rps: float | None = None) -> ServeReport:
        cfg = self.cfg
        t_wall = _time.perf_counter()
        now = 0.0
        step = 0
        pending = deque(sorted(workload, key=lambda r: (r.arrival, r.rid)))
        queue: list[Request] = []

        while pending or queue or self.running:
            if step >= cfg.max_steps:
                raise RuntimeError(
                    f"front end exceeded max_steps={cfg.max_steps} with "
                    f"{len(pending)} pending / {len(queue)} queued / "
                    f"{len(self.running)} running — scheduling bug or "
                    f"undersized budget")

            # quarantine cooldowns expire on the step clock
            for (name, slot), until in list(self._quarantine_until.items()):
                if step >= until:
                    self._engine(name).clear_quarantine(slot)
                    del self._quarantine_until[(name, slot)]

            # arrivals → bounded queue
            while pending and pending[0].arrival <= now:
                r = pending.popleft()
                if len(queue) >= cfg.max_queue:
                    self._shed(r, "queue_full", now=now, step=step)
                else:
                    queue.append(r)

            # shed queued work that can no longer meet its bounds
            for r in list(queue):
                wait = now - r.arrival
                if now > r.arrival + cfg.deadline_s:
                    queue.remove(r)
                    self._shed(r, "deadline", now=now, step=step)
                elif wait > cfg.queue_timeout_s:
                    queue.remove(r)
                    self._shed(r, "queue_timeout", now=now, step=step)

            # length-bucketed admission into free slots
            for r in self._bucket_order(queue, now):
                target = "fallback" if (r.degraded and self.fallback is not None) \
                    else "primary"
                eng = self._engine(target)
                if r.plen + r.max_new_tokens > eng.max_seq:
                    queue.remove(r)
                    self._shed(r, "too_long", now=now, step=step)
                    continue
                free = eng.free_slots()
                if not free:
                    continue
                queue.remove(r)
                now += self._admit(r, target, free[0], now)

            if not self.running:
                # nothing to step: jump virtual time to the next event
                horizons = [r.arrival for r in pending][:1]
                horizons += [r.not_before for r in queue if r.not_before > now]
                if horizons:
                    now = max(now, min(horizons))
                elif queue:
                    # queued work blocked only by quarantine cooldowns —
                    # let the step clock tick them down
                    step += 1
                    continue
                else:
                    break
                step += 1
                continue

            # one batched decode step per engine with active slots
            for name, eng in self._engines():
                if not eng.active.any():
                    continue
                cost = cfg.step_cost_s
                if name == "primary" and self.faults is not None:
                    cost *= self.faults.latency_multiplier(step)
                    n_fail = self.faults.kernel_failures(step)
                    if n_fail:
                        retries = min(n_fail, cfg.max_kernel_retries)
                        cost += cfg.step_cost_s * retries
                        self.log.add(
                            time=now, step=step, engine=name, slot=-1, rid=-1,
                            kind="kernel_failure", action="injected",
                            detail=f"{n_fail} consecutive launch failure(s), "
                                   f"{retries} retried")
                        if n_fail > cfg.max_kernel_retries:
                            # launch keeps failing: degrade every active slot
                            now += cost
                            for slot in np.flatnonzero(eng.active):
                                r = self.running.get((name, int(slot)))
                                if r is not None:
                                    self._degrade(r, name, int(slot),
                                                  "kernel_failure", queue,
                                                  now=now, step=step)
                            continue
                    # cache poisoning happens before the step so the model
                    # itself produces the bad logits the watchdog must catch
                    for ev in self.faults.poison_kv(eng, step):
                        occupant = self.running.get((name, ev.slot))
                        self.log.add(
                            time=now, step=step, engine=name, slot=ev.slot,
                            rid=occupant.rid if occupant else -1,
                            kind=ev.kind, action="injected")

                nxt = eng.step()
                now += cost

                if name == "primary" and self.faults is not None:
                    corrupted, applied = self.faults.corrupt_logits(
                        eng.last_logits, step, eng.active)
                    eng.last_logits = corrupted
                    for ev in applied:
                        occupant = self.running.get((name, ev.slot))
                        self.log.add(
                            time=now, step=step, engine=name, slot=ev.slot,
                            rid=occupant.rid if occupant else -1,
                            kind=ev.kind, action="injected")

                flagged = self.watchdog.scan(eng, name, step=step, now=now)
                for slot, reason in flagged.items():
                    r = self.running.get((name, slot))
                    if r is None:  # active slot without a tracked request
                        eng.quarantine_slot(slot)
                        self._quarantine_until[(name, slot)] = (
                            step + cfg.guard.quarantine_steps)
                        continue
                    self._degrade(r, name, slot, reason, queue,
                                  now=now, step=step)

                # token accounting for the slots that survived the watchdog
                for (ename, slot), r in list(self.running.items()):
                    if ename != name or slot in flagged:
                        continue
                    self._account_token(r, int(nxt[slot]), now=now)
                    self._finish_if_done(r, now=now)

            # completion deadlines for running requests
            for (name, slot), r in list(self.running.items()):
                if now > r.arrival + cfg.deadline_s:
                    self._shed(r, "deadline", now=now, step=step)

            step += 1

        return ServeReport(
            requests=sorted(workload, key=lambda r: r.rid),
            incidents=self.log,
            virtual_time=now,
            wall_s=_time.perf_counter() - t_wall,
            steps=step,
            offered_load_rps=offered_load_rps,
        )


def faulted_request_ids(report: ServeReport) -> set[int]:
    """Requests that took a slot-targeted injected fault (the ones the
    zero-lost gate requires to end degraded-completed or cleanly shed)."""
    return {
        inc.rid for inc in report.incidents.records
        if inc.action == "injected" and inc.kind in SLOT_FAULTS and inc.rid >= 0
    }
