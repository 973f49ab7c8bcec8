"""Schedule rules: does the traced step execute the claimed fusion plan?

The port of ``repro.analysis.rules_schedule``.  The paper's power and area
win is a schedule claim as much as an arithmetic one: the subtractions run
inside the kernel's lanes, the pool and the residual adds ride its
epilogue, and each conv layer or decode GEMM writes back to device memory
once.  These rules read the step's dispatch trace (``analysis.trace``) and
compare it with the target's declared expectations.  A kernel node is one
writeback, whatever ran beneath it.

Eager PyTorch runs every decode layer, so the trace holds the whole step:
the count a layer is the JAX count a scan trip, and the count a program
(and of residual adds) is that count times the layers.
"""
from __future__ import annotations

from repro_torch.analysis.core import Finding, RuleContext, rule
from repro_torch.analysis.trace import count_ops, count_shape_adds, kernels_by_layer

#: standalone pools: PyTorch's pooling ops and the port's plain 2×2 pool
POOL_OPS = ("aten.max_pool2d", "aten.max_pool2d_with_indices", "aten.avg_pool2d",
            "call/pool2_reference")


@rule("schedule/no-standalone-pool", needs=("trace",))
def no_standalone_pool(ctx: RuleContext):
    """A standalone pool is forbidden on the fused conv→pool path."""
    n = count_ops(ctx.trace, *POOL_OPS)
    fused = bool(ctx.expect.get("fused_pool"))
    if fused and n > 0:
        yield Finding(
            rule="schedule/no-standalone-pool",
            severity="error",
            location=ctx.target,
            message=f"fused path still runs {n} standalone pool(s) — pooling "
                    f"must happen inside the kernel epilogue",
            measured=n,
            expected=0,
        )
    else:
        yield Finding(
            rule="schedule/no-standalone-pool",
            severity="info",
            location=ctx.target,
            message=f"{n} standalone pool(s) in the traced step",
            measured=n,
            expected=0 if fused else None,
        )


@rule("schedule/writebacks-per-program", needs=("trace",))
def writebacks_per_program(ctx: RuleContext):
    """Kernel nodes of one step: one writeback to device memory per kernel."""
    n = len(ctx.trace.kernels())
    expected = ctx.expect.get("pallas_calls")
    if expected is not None and n != expected:
        yield Finding(
            rule="schedule/writebacks-per-program",
            severity="error",
            location=ctx.target,
            message=f"expected {expected} kernel writeback(s) in the traced "
                    f"step, found {n}",
            measured=n,
            expected=expected,
        )
    else:
        yield Finding(
            rule="schedule/writebacks-per-program",
            severity="info",
            location=ctx.target,
            message=f"{n} kernel writeback(s) in the traced step",
            measured=n,
            expected=expected,
        )


@rule("schedule/writebacks-per-decode-layer", needs=("trace",))
def writebacks_per_decode_layer(ctx: RuleContext):
    """Writebacks per decode layer: kernel nodes between the boundaries of
    each ``layer_decode`` call, against ``analysis.decode_launches``."""
    _, per_layer = kernels_by_layer(ctx.trace)
    expected = ctx.expect.get("writebacks_per_layer")
    if not any(per_layer.values()):
        sev = "error" if expected is not None else "info"
        yield Finding(
            rule="schedule/writebacks-per-decode-layer",
            severity=sev,
            location=ctx.target,
            message="no decode layer runs a kernel"
                    + (" (expected decode layers with kernel launches)"
                       if expected is not None else ""),
            measured=0,
            expected=expected,
        )
        return
    for layer, n in per_layer.items():
        loc = f"{ctx.target}/layer{layer}"
        if expected is not None and n > expected:
            yield Finding(
                rule="schedule/writebacks-per-decode-layer",
                severity="error",
                location=loc,
                message=f"{n} kernel writebacks in decode layer {layer} (of "
                        f"{len(per_layer)}) exceed the budget of {expected}",
                measured=n,
                expected=expected,
            )
        else:
            yield Finding(
                rule="schedule/writebacks-per-decode-layer",
                severity="info",
                location=loc,
                message=f"{n} kernel writeback(s) in decode layer {layer} of "
                        f"{len(per_layer)}",
                measured=n,
                expected=expected,
            )


@rule("schedule/standalone-residual-adds", needs=("trace", "hidden_shape"))
def standalone_residual_adds(ctx: RuleContext):
    """Standalone hidden-state residual adds: the paired path must fuse the
    ``h + attn(x)`` / ``h + mlp(x)`` skips into the kernel epilogue."""
    n = count_shape_adds(ctx.trace, ctx.hidden_shape)
    expected = ctx.expect.get("residual_adds")
    if expected is not None and n != expected:
        yield Finding(
            rule="schedule/standalone-residual-adds",
            severity="error",
            location=ctx.target,
            message=f"{n} standalone residual add(s) over hidden shape "
                    f"{tuple(ctx.hidden_shape)} (expected {expected}) — skips "
                    f"must ride the kernel's residual-add epilogue",
            measured=n,
            expected=expected,
        )
    else:
        yield Finding(
            rule="schedule/standalone-residual-adds",
            severity="info",
            location=ctx.target,
            message=f"{n} standalone residual add(s) over hidden shape "
                    f"{tuple(ctx.hidden_shape)}",
            measured=n,
            expected=expected,
        )
