"""Static shared-memory budget rule.

The port of ``repro.analysis.rules_vmem``.  The JAX rule charges every
``pallas_call``'s block specs against the TPU's VMEM budget; on the card the
scarce on-chip memory is a block's shared memory, 232 448 bytes
(``kernels.tuning.SMEM_PER_BLOCK``), and each launch's layout follows its
plan.  So the rule charges the plan of every K1 node (``tuning.plan_smem``)
and every K2 node (``tuning.k2_plan``'s ``smem``) of the trace against it:
the plans are worked out on the host from the recorded problems, so the
rule runs on the CPU as it does on the card, before anything launches.
"""
from __future__ import annotations

from repro_torch.analysis.core import Finding, RuleContext, rule


def node_smem(op) -> int | None:
    """The dynamic shared memory a kernel node's plan lays out, in bytes
    (None for a node without a plan: K3 lays out its own)."""
    from repro_torch.kernels import tuning

    plan = op.info.get("plan")
    if plan is None:
        return None
    if op.info["kernel"] == "K2":
        return plan.smem
    _, P, R, _, _, pool, itemsize = op.info["problem"]
    return tuning.plan_smem(plan, P, R, tuning.POOL_WINDOWS[pool], itemsize)


@rule("smem/static-budget", needs=("trace",))
def static_budget(ctx: RuleContext):
    """Every kernel plan's shared memory must fit a block's budget."""
    from repro_torch.kernels import tuning

    budget = ctx.expect.get("smem_budget_bytes", tuning.SMEM_PER_BLOCK)
    n_calls = 0
    peak = 0
    for op in ctx.trace.kernels():
        est = node_smem(op)
        if est is None:
            continue
        n_calls += 1
        peak = max(peak, est)
        if est > budget:
            yield Finding(
                rule="smem/static-budget",
                severity="error",
                location=f"{ctx.target}/{op.name}",
                message=f"plan {op.info['plan']} for {op.info['problem']} lays out {est} "
                        f"bytes of shared memory — over the {budget}-byte budget",
                measured=est,
                expected=budget,
            )
    yield Finding(
        rule="smem/static-budget",
        severity="info",
        location=ctx.target,
        message=f"{n_calls} kernel plan(s) checked, peak shared memory "
                f"{peak} bytes (budget {budget})",
        measured=peak,
        expected=budget,
    )
