"""Rule registry, structured findings, and the machine-readable report.

The port of ``repro.analysis.core``.  A *rule* is a function from a
:class:`RuleContext` (the dispatch trace of a step, the pairing metadata of
a model or a LeNet's conv artifacts: whatever the target provides) to zero
or more :class:`Finding`\\ s.  Rules declare what context they ``need``;
:func:`run_rules` runs every registered rule whose needs are met and
records the rest as skipped, so one report always answers "which
invariants were actually checked".

Severity contract, as in the JAX package: ``error`` findings are schedule or
correctness violations a gate must fail on (:meth:`AnalysisReport.exit_code`
is non-zero iff one fires); ``warning`` is a suspicious measurement worth a
look; ``info`` findings carry the measured values themselves (writebacks,
convert churn, the shared-memory peak).  A rule that raises is reported as
an error finding of that rule, never skipped.

Ten rules keep their JAX ids.  Two read the card's program, not the TPU's,
and are renamed (:data:`JAX_RULE` maps each id to its counterpart's):
``vmem/static-budget`` is ``smem/static-budget`` and
``hlo/pairing-resharding-in-loop`` is ``moves/pairing-in-step``.
"""
from __future__ import annotations

import dataclasses
import json
import traceback
from collections.abc import Callable, Iterable
from typing import Any

SEVERITIES = ("info", "warning", "error")

#: each rule's counterpart in ``repro.analysis``
JAX_RULE = {
    "dtype/convert-churn": "dtype/convert-churn",
    "dtype/no-f64": "dtype/no-f64",
    "dtype/reduce-precision-on-bf16": "dtype/reduce-precision-on-bf16",
    "moves/pairing-in-step": "hlo/pairing-resharding-in-loop",
    "pairing/padding-consistent": "pairing/padding-consistent",
    "pairing/stacked-shapes": "pairing/stacked-shapes",
    "pairing/valid-permutation": "pairing/valid-permutation",
    "schedule/no-standalone-pool": "schedule/no-standalone-pool",
    "schedule/standalone-residual-adds": "schedule/standalone-residual-adds",
    "schedule/writebacks-per-decode-layer": "schedule/writebacks-per-decode-layer",
    "schedule/writebacks-per-program": "schedule/writebacks-per-program",
    "smem/static-budget": "vmem/static-budget",
}


@dataclasses.dataclass
class Finding:
    """One structured result of one rule at one location."""

    rule: str
    severity: str  # "info" | "warning" | "error"
    location: str  # target name, artifact path, layer, …
    message: str
    measured: Any = None
    expected: Any = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RuleContext:
    """Everything a target exposes for the rules to inspect.

    Fields are optional: rules declare which ones they need and are skipped
    (not failed) when a target does not provide them.  ``trace`` and
    ``step`` are :class:`~repro_torch.analysis.trace.Trace`\\ s; ``step`` is
    the trace of one serving step with the model's pairing storages
    registered (what ``moves/pairing-in-step`` reads), and a decode target
    gives the same trace as both, as the JAX targets give a jaxpr and the
    compiled HLO of one step.
    """

    target: str
    trace: Any = None  # the dispatch trace of the program
    step: Any = None  # the trace of one serving step, pairing storages registered
    params: Any = None  # an LM (models.lm.LM) whose blocks may carry pairing metadata
    pairing_artifacts: dict | None = None  # conv {name: PairedLayer}
    hidden_shape: tuple | None = None  # residual-add signature shape
    expect: dict = dataclasses.field(default_factory=dict)
    # per-target expectations, e.g. {"fused_pool": True, "pallas_calls": 3,
    # "writebacks_per_layer": 7, "residual_adds": 0, "max_converts": 40}

    def has(self, need: str) -> bool:
        if need == "trace":
            return self.trace is not None
        if need == "step":
            return self.step is not None
        if need == "hidden_shape":
            return self.hidden_shape is not None
        if need == "pairing":
            return self.pairing_artifacts is not None or self.params is not None
        raise ValueError(f"unknown rule need {need!r}")


@dataclasses.dataclass
class Rule:
    id: str
    needs: tuple[str, ...]
    fn: Callable[[RuleContext], Iterable[Finding]]
    doc: str


RULE_REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, *, needs: tuple[str, ...] = ()):
    """Register a rule under ``rule_id`` (e.g. ``"schedule/no-standalone-pool"``).

    ``needs`` lists the :class:`RuleContext` facets the rule requires:
    ``"trace"``, ``"step"``, ``"hidden_shape"``, ``"pairing"``.
    """

    def deco(fn):
        if rule_id in RULE_REGISTRY:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULE_REGISTRY[rule_id] = Rule(
            rule_id, tuple(needs), fn, (fn.__doc__ or "").strip().splitlines()[0]
        )
        return fn

    return deco


@dataclasses.dataclass
class AnalysisReport:
    target: str
    findings: list[Finding]
    rules_run: list[str]
    rules_skipped: dict[str, str]  # rule id -> unmet need

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def exit_code(self) -> int:
        return 1 if self.errors() else 0

    def measured(self, rule_id: str, location: str | None = None):
        """The ``measured`` value of the first finding of ``rule_id`` (at
        ``location`` if given): how benches read counts out of a report."""
        for f in self.findings:
            if f.rule == rule_id and (location is None or f.location == location):
                return f.measured
        raise KeyError(f"no finding for rule {rule_id!r}"
                       + (f" at {location!r}" if location else ""))

    def as_dict(self) -> dict:
        return {
            "target": self.target,
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "rules_run": self.rules_run,
            "rules_skipped": self.rules_skipped,
            "findings": [f.as_dict() for f in self.findings],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.as_dict(), default=str, **kw)

    def summary_lines(self) -> list[str]:
        lines = [
            f"[{self.target}] {len(self.rules_run)} rules run, "
            f"{len(self.rules_skipped)} skipped, "
            f"{len(self.errors())} error(s), {len(self.warnings())} warning(s)"
        ]
        for f in self.findings:
            if f.severity == "info":
                continue
            lines.append(f"  {f.severity.upper()} {f.rule} @ {f.location}: {f.message}")
        return lines


def _load_rules() -> None:
    """Import the rule modules so their ``@rule`` decorators register
    (deferred: they import torch and the kernels)."""
    from repro_torch.analysis import (  # noqa: F401
        rules_dtype,
        rules_moves,
        rules_pairing,
        rules_schedule,
        rules_smem,
    )


def run_rules(
    ctx: RuleContext, rule_ids: Iterable[str] | None = None
) -> AnalysisReport:
    """Run every registered rule (or the given subset) against ``ctx``.

    Rules whose ``needs`` the context cannot satisfy are recorded in
    ``rules_skipped`` with the first unmet need, never silently dropped; an
    unknown rule id raises ``ValueError``.  A rule that raises gives one
    error finding of that rule, with the exception, and the others run on.
    """
    _load_rules()

    wanted = set(rule_ids) if rule_ids is not None else None
    if wanted is not None:
        unknown = wanted - set(RULE_REGISTRY)
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)}")

    findings: list[Finding] = []
    rules_run: list[str] = []
    skipped: dict[str, str] = {}
    for rid in sorted(RULE_REGISTRY):
        if wanted is not None and rid not in wanted:
            continue
        r = RULE_REGISTRY[rid]
        unmet = next((n for n in r.needs if not ctx.has(n)), None)
        if unmet is not None:
            skipped[rid] = unmet
            continue
        try:
            findings.extend(r.fn(ctx))
        except Exception as e:  # noqa: BLE001 — a rule that breaks is a finding
            findings.append(Finding(
                rule=rid, severity="error", location=ctx.target,
                message=f"the rule raised {type(e).__name__}: {e}",
                measured=traceback.format_exc()[-2000:], expected="the rule runs",
            ))
        rules_run.append(rid)
    return AnalysisReport(
        target=ctx.target,
        findings=findings,
        rules_run=rules_run,
        rules_skipped=skipped,
    )
