"""Pairing metadata must stay put inside a step.

The port of ``repro.analysis.rules_hlo``.  The pairing index and mask
arrays are invariant serving state: a step gathers activations by them and
nothing else should touch them.  The JAX rule finds copies and collectives
of pairing-typed buffers inside the compiled decode loop; the port has no
compiled loop, so it reads the trace of one step whose pairing storages
were registered when the target was built (``analysis.trace.tracing(
pairing=model)``), and fails on:

* any op that copies a tensor whose storage is a registered pairing
  storage (to another device, dtype or storage: ``_to_copy``, ``clone``,
  ``copy_``), or sends one through ``parallel.collectives``;
* any host-to-device copy that produces an integer tensor of a pairing
  index array's shape (metadata kept on the host and uploaded each step).

That is the port's "loop-invariant metadata is moved every step".
"""
from __future__ import annotations

from repro_torch.analysis.core import Finding, RuleContext, rule

#: ops that move a tensor without computing anything new on it
MOVE_OPS = {"aten._to_copy", "aten.clone", "aten.copy_", "aten.copy", "aten._copy_from",
            "aten._copy_from_and_resize", "aten.lift_fresh_copy"}
#: the sends of ``parallel.collectives`` (trace call nodes)
SEND_CALLS = {"call/all_reduce", "call/all_gather", "call/reduce_scatter",
              "call/gather_blocks"}
_INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8")


def _uploads_index(op, index_shapes: set) -> bool:
    """A host-to-device copy producing an integer tensor of an index
    array's shape."""
    if op.name not in ("aten._to_copy", "aten.copy_") or not op.outs:
        return False
    dt, shape, dev = op.outs[0]
    return (dev == "cuda" and any(d == "cpu" for _, _, d in op.ins)
            and dt in _INT_DTYPES and shape in index_shapes)


@rule("moves/pairing-in-step", needs=("step",))
def pairing_in_step(ctx: RuleContext):
    """No copies, sends or uploads of pairing metadata inside a step."""
    step = ctx.step
    if not step.pairing_buffers:
        yield Finding(
            rule="moves/pairing-in-step",
            severity="info",
            location=ctx.target,
            message="no pairing-metadata buffers registered in the traced step",
            measured=0,
            expected=None,
        )
        return
    moved = 0
    for op in step.ops:
        copied = op.pairing and (op.name in MOVE_OPS or op.name in SEND_CALLS)
        if not (copied or _uploads_index(op, step.pairing_index_shapes)):
            continue
        moved += 1
        where = "" if op.layer is None else f"/layer{op.layer}"
        yield Finding(
            rule="moves/pairing-in-step",
            severity="error",
            location=f"{ctx.target}{where}",
            message=f"{op.name} of a pairing-metadata buffer "
                    f"({', '.join(f'{d}{list(s)}@{dev}' for d, s, dev in op.ins[:2])}) "
                    f"inside the step — invariant metadata is being moved per step",
            measured=op.name,
            expected="no copies/sends/uploads of pairing buffers in a step",
        )
    yield Finding(
        rule="moves/pairing-in-step",
        severity="info",
        location=ctx.target,
        message=f"{step.pairing_buffers} pairing buffer(s) tracked across "
                f"{len(step.ops)} op(s) of the step, {moved} moved",
        measured=moved,
        expected=0,
    )
