"""``python -m repro_torch.analysis`` — run the schedule linter over a target.

The port of ``repro.analysis.__main__``: the JAX flags (``--target {…,
all}``, ``--json``, ``--rules``, ``--list-rules``) and ``--device {cuda,
cpu}`` (default: the GPU; ``cpu`` traces the kernels' plain versions).
The exit code is non-zero iff an error-severity finding fires on any
requested target; a target that fails to build, or a rule that raises, is
such a finding.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from repro_torch.analysis.core import RULE_REGISTRY, _load_rules
    from repro_torch.analysis.targets import TARGETS, run_target

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Rule-based schedule linter over dispatch traces of the port's "
                    "steps: gates fusion, dtype, shared-memory and pairing invariants.",
    )
    ap.add_argument(
        "--target", choices=(*TARGETS, "all"),
        help="which traced program to lint ('all' runs every target)",
    )
    ap.add_argument(
        "--json", metavar="PATH", default=None,
        help="write the machine-readable report here",
    )
    ap.add_argument(
        "--rules", nargs="*", default=None, metavar="RULE_ID",
        help="run only these rule ids (default: every registered rule)",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print every registered rule id and exit",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the traced steps run (default: the GPU)",
    )
    args = ap.parse_args(argv)

    _load_rules()
    if args.list_rules:
        for rid, r in sorted(RULE_REGISTRY.items()):
            needs = f"  [needs: {', '.join(r.needs)}]" if r.needs else ""
            print(f"{rid}{needs}")
        return 0
    if args.target is None:
        ap.error("--target is required (unless --list-rules)")
    if args.rules is not None:
        unknown = sorted(set(args.rules) - set(RULE_REGISTRY))
        if unknown:
            ap.error(f"unknown rule ids: {unknown}")

    targets = TARGETS if args.target == "all" else (args.target,)
    reports = []
    for t in targets:
        report = run_target(t, rule_ids=args.rules, device=args.device)
        reports.append(report)
        for line in report.summary_lines():
            print(line)
        for rid, need in sorted(report.rules_skipped.items()):
            print(f"  skipped {rid} (target provides no {need})")

    if args.json:
        payload = (
            reports[0].as_dict()
            if len(reports) == 1
            else {"targets": [r.as_dict() for r in reports]}
        )
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        print(f"wrote {args.json}")

    return max(r.exit_code for r in reports)


if __name__ == "__main__":
    sys.exit(main())
