"""Dtype-discipline rules.

The port of ``repro.analysis.rules_dtype``.  Approximate-arithmetic
accelerators live or die on numeric drift: the bf16 subtractor rounds the
difference of two lanes to bf16 before the multiply (``csrc/paired_matmul.cu``,
``sub_at_input_precision``; the plain version subtracts in bf16), f64
anywhere means a silent 2x-width fallback slipped in, and dtype conversions
measure how often the schedule bounces activations between widths.

The JAX rule reads the kernel's jaxpr for a ``reduce_precision``; a CUDA
kernel has no jaxpr, so the port's rule asks the kernel itself: for every
distinct bf16 (form, plan) of K1 in the trace it runs one probe through the
same wrapper at that plan (the kernel on the card, the plain version on the
CPU), whose pair lane's fp32 difference is not a bf16 number, and fails
unless the result is the product of the bf16-rounded difference.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.core import Finding, RuleContext, rule

_WIDE_DTYPES = ("float64", "complex128")

# two bf16 numbers whose fp32 difference, 1 + 2^-7 - 2^-9, is not one: bf16
# rounds it to 1 + 2^-7, the value a subtractor at input precision multiplies
PROBE_XI, PROBE_XJ = 1.0078125, 0.001953125
PROBE_ROUNDED = 1.0078125


@rule("dtype/no-f64", needs=("trace",))
def no_f64(ctx: RuleContext):
    """No float64/complex128 anywhere in the traced step."""
    hits = [f"{op.name}:{dt}" for op in ctx.trace.ops for dt, _, _ in op.outs
            if dt in _WIDE_DTYPES]
    if hits:
        yield Finding(
            rule="dtype/no-f64",
            severity="error",
            location=ctx.target,
            message=f"{len(hits)} op(s) produce 64-bit values "
                    f"(e.g. {hits[0]}) — the inference paths are ≤ 32-bit",
            measured=len(hits),
            expected=0,
        )
    else:
        yield Finding(
            rule="dtype/no-f64",
            severity="info",
            location=ctx.target,
            message="no 64-bit values in the traced step",
            measured=0,
            expected=0,
        )


def probe_k1(problem: tuple, form: str, plan, device: str) -> torch.Tensor:
    """One K1 call through the wrapper of ``form`` at ``plan`` on ``device``
    for ``problem`` (bf16, P ≥ 1): every row's first pair lane holds
    :data:`PROBE_XI` − :data:`PROBE_XJ`, a one-hot ``kmat`` column picks it
    in the first column of each block, everything else is zero.  Returns
    those columns' fp32 results, (M, n_blocks)."""
    from repro_torch.kernels import paired_matmul as pm

    M, P, R, n_blocks, bn, pool, _ = problem
    blocked = "_blocked" in form
    lead = ((n_blocks,) if blocked else ()) + ((4,) if pool != "none" else ())
    kw = dict(dtype=torch.bfloat16, device=device)
    x = torch.zeros((*lead, M, 2 * P + R), **kw)
    x[..., 0], x[..., P] = PROBE_XI, PROBE_XJ
    kmat = torch.zeros(((n_blocks,) if blocked else ()) + (P, bn), **kw)
    kmat[..., 0, 0] = 1.0
    w_res = torch.zeros(((n_blocks,) if blocked else ()) + (R, bn), **kw)
    if blocked:
        y = pm.paired_matmul_blocked_cuda(x, kmat, w_res, n_cols=n_blocks * bn, pool=pool,
                                          plan=plan, out_dtype=torch.float32)
    else:
        y = pm.paired_matmul_cuda(x, kmat, w_res, pool=pool, plan=plan,
                                  out_dtype=torch.float32)
    return y[:, ::bn].cpu()


@rule("dtype/reduce-precision-on-bf16", needs=("trace",))
def reduce_precision_on_bf16(ctx: RuleContext):
    """bf16 subtractor kernels must round the difference to bf16 before the
    multiply: one probe a distinct (form, plan) of a bf16 K1 call."""
    probes: dict = {}
    for op in ctx.trace.kernels("K1"):
        M, P, R, n_blocks, bn, pool, itemsize = op.info["problem"]
        if itemsize != 2 or P == 0:
            continue  # fp32, or the dense form: no low-precision subtractor lanes
        probes.setdefault((op.info["form"], op.info["plan"]), (op.info["problem"], op.ins[0][2]))
    for (form, plan), (problem, device) in probes.items():
        y = probe_k1(problem, form, plan, device)
        bad = y[y != PROBE_ROUNDED]
        if bad.numel():
            yield Finding(
                rule="dtype/reduce-precision-on-bf16",
                severity="error",
                location=f"{ctx.target}/K1/{form}",
                message=f"subtractor kernel at {plan} multiplies {float(bad[0])} for the "
                        f"bf16 lanes {PROBE_XI} − {PROBE_XJ}, not their bf16-rounded "
                        f"difference {PROBE_ROUNDED} — low-precision rounding semantics "
                        f"are unpinned",
                measured=float(bad[0]),
                expected=PROBE_ROUNDED,
            )
    yield Finding(
        rule="dtype/reduce-precision-on-bf16",
        severity="info",
        location=ctx.target,
        message=f"{len(probes)} low-precision subtractor kernel(s) checked",
        measured=len(probes),
        expected=None,
    )


def _converts(op) -> bool:
    """A dtype-changing copy: ``_to_copy`` to another dtype, or ``copy_``
    from one."""
    if op.kind != "op" or not op.ins or not op.outs:
        return False
    if op.name == "aten._to_copy":
        return op.ins[0][0] != op.outs[0][0]
    return op.name == "aten.copy_" and len(op.ins) >= 2 and op.ins[0][0] != op.ins[1][0]


@rule("dtype/convert-churn", needs=("trace",))
def convert_churn(ctx: RuleContext):
    """Dtype-conversion churn counter — widening/narrowing bounces outside
    the kernels."""
    n = sum(1 for op in ctx.trace.ops if _converts(op))
    cap = ctx.expect.get("max_converts")
    if cap is not None and n > cap:
        yield Finding(
            rule="dtype/convert-churn",
            severity="warning",
            location=ctx.target,
            message=f"{n} dtype conversion(s) exceed the target's "
                    f"budget of {cap} — check for width bouncing",
            measured=n,
            expected=cap,
        )
    else:
        yield Finding(
            rule="dtype/convert-churn",
            severity="info",
            location=ctx.target,
            message=f"{n} dtype conversion(s) in the traced step",
            measured=n,
            expected=cap,
        )
