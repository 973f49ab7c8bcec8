"""What one rank's step costs, read from a trace of it on fake tensors.

The port's counterpart of ``repro.parallel.hlo`` and
``repro.parallel.hlo_debug``.  The JAX package compiles a step for the
production mesh and reads the compiled HLO: dot FLOPs weighted by loop trip
counts, the operand and result bytes of the top-level ops, the collectives
with ring factors.  The port has no compiled program: eager PyTorch launches
every aten op as it runs.  So the dry run (``launch.steps.LoweredCell``)
runs the rank's real step once under a ``FakeTensorMode`` (nothing is
allocated, no kernel is built or launched), its collectives over a fake
process group, inside :func:`record`, which sees every aten op and counts:

* **FLOPs** — ``torch.utils.flop_counter``'s formula of each op (matmuls,
  convolutions, attention; K1's operator ``repro_torch::k1`` has its own,
  ``kernels.ops``), by op and by module;
* **HBM bytes** — the operand and result bytes of every op launched (the
  port's version of hlo.py's "top-level ops only": each eager op is one
  launch that reads its operands and writes its result); views, ``detach``
  and allocations without a fill launch nothing and count nothing;
* **collectives** — the calls and bytes of each kind from
  ``parallel.collectives``' counter, and the wire bytes by hlo.py's ring
  factors (:func:`~repro_torch.parallel.collectives.collective_wire_bytes`);
* **memory** — the bytes of the step's arguments by group (parameters,
  optimizer state, cache, batch: what the rank holds when the step starts)
  and the peak of the live bytes on the rank's device while it runs, storage
  by storage (a CUDA storage rounded up to the caching allocator's 512-byte
  blocks); the peak less the arguments is the temporaries.

"By module" is the innermost function of the port that launched the op
(``models/layers.py:attention_block``); an op of the backward is charged to
the forward function whose output it differentiates (``backward of …``).
:func:`top_contributors` lists the ops and modules that carry the most FLOPs
and bytes (``hlo_debug.top_contributors``).  The lint the JAX package runs
on the compiled program (``repro.analysis``' ``hlo/pairing-resharding-in-loop``)
is the port's ``moves/pairing-in-step`` over the same run of a serving step
(``repro_torch.analysis``, traced beside this record: ``LoweredCell.lower``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.trace import NO_LAUNCH
from repro_torch.parallel import collectives

#: the caching allocator's block: a CUDA storage takes a multiple of it
CUDA_BLOCK = 512


_SELF = __file__.rsplit("/", 1)[0] + "/cost.py"


@dataclasses.dataclass
class Trace:
    """One rank's step, as :func:`record` saw it: totals, by op and by
    module (``{name: {"calls", "flops", "bytes"}}``), collectives, memory."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    launches: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    by_module: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    argument_bytes: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    seconds: float = 0.0
    #: the arguments' bytes as the rank's device allocates them
    args_allocated: int = 0
    #: a serving step's ``repro_torch.analysis`` trace of the same run
    #: (``launch.steps.LoweredCell.lower``), or None
    step: object = None

    @property
    def memory(self) -> dict:
        """Peak memory split into the arguments (exact bytes, by group) and
        the temporaries (the peak of the live bytes less the arguments'
        allocated bytes)."""
        args = sum(self.argument_bytes.values())
        return {"argument_bytes": args, "argument_bytes_by_group": dict(self.argument_bytes),
                "temp_bytes": self.peak_bytes - self.args_allocated,
                "peak_device_bytes": self.peak_bytes}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples, modules and optimizers."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list | tuple):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        for block in tree.modules():
            for group in (getattr(block, "pairing", {}), getattr(block, "gathered", {})):
                for meta in group.values():
                    yield from meta.values()
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            yield from _tensors(state)


def argument_bytes(args: dict) -> dict[str, int]:
    """The bytes of each group of a step's arguments (``{"params": model,
    "opt_state": optimizer, "cache": …, "batch": …}``), each tensor once."""
    seen, out = set(), {}
    for name, tree in args.items():
        total = 0
        for t in _tensors(tree):
            key = (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape))
            if key not in seen:
                seen.add(key)
                total += _bytes(t)
        out[name] = total
    return out


def _scope() -> str:
    """The innermost function of the port on the Python stack."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "/repro_torch/" in name and name != _SELF:
            return f"{name.rsplit('/repro_torch/', 1)[1]}:{f.f_code.co_name}"
        f = f.f_back
    return "(outside the port)"


class _Tagger(TorchFunctionMode):
    """Tags the autograd nodes each forward call made (its result's, and
    theirs back to the nodes tagged before) with the scope of the last op it
    launched, so the backward's ops can be charged to it."""

    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.grad_fn is not None:
            todo = [out.grad_fn]
            while todo:
                node = todo.pop()
                if node is None or "scope" in node.metadata or not hasattr(node, "next_functions"):
                    continue
                node.metadata["scope"] = self.rec.last_scope
                todo.extend(n for n, _ in node.next_functions)
        return out


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace, device: torch.device):
        super().__init__()
        self.trace, self.device = trace, device
        self.live = 0
        self.refs: dict[int, weakref.ref] = {}
        self.last_scope = ""

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage among the live bytes (once); its bytes."""
        if t.device != self.device:
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self.refs:
            return 0
        n = st.nbytes()
        if self.device.type == "cuda":
            n = -(-n // CUDA_BLOCK) * CUDA_BLOCK
        self.refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
        self.live += n
        if self.live > self.trace.peak_bytes:
            self.trace.peak_bytes = self.live
        return n

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") else str(func)
        outs = [t for t in (out if isinstance(out, tuple | list) else (out,))
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        if name in NO_LAUNCH or name.startswith("profiler.") or getattr(func, "is_view", False):
            return out
        node = torch._C._current_autograd_node()
        if node is None:
            scope = self.last_scope = _scope()
        else:
            scope = "backward of " + node.metadata.get("scope", node.name())
        flops = 0
        formula = flop_registry.get(getattr(func, "overloadpacket", None))
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        moved = sum(_bytes(t) for t in _flat_tensors((args, kwargs))) + sum(_bytes(t) for t in outs)
        tr = self.trace
        tr.flops += flops
        tr.hbm_bytes += moved
        tr.launches += 1
        for table, key in ((tr.by_op, name), (tr.by_module, scope)):
            row = table.get(key)
            if row is None:
                row = table[key] = {"calls": 0, "flops": 0.0, "bytes": 0.0}
            row["calls"] += 1
            row["flops"] += flops
            row["bytes"] += moved
        return out


def _flat_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_tensors(v)
    elif isinstance(tree, list | tuple):
        for v in tree:
            yield from _flat_tensors(v)


@contextlib.contextmanager
def record(args: dict, device, *, backward: bool = True):
    """Record the ops run inside the block into the :class:`Trace` it yields
    (complete after it): ``args`` are the step's arguments by group (their
    bytes, and what is live on ``device`` when the step starts); the
    collective counter is reset on entry and read on exit.  ``backward``:
    the block runs a backward, whose ops are charged to the forward
    functions they differentiate (off, a step without autograd skips the
    tagging of every forward result)."""
    trace = Trace(argument_bytes=argument_bytes(args))
    rec = _Recorder(trace, torch.device(device))
    trace.args_allocated = sum(rec.hold(t) for t in _tensors(list(args.values())))
    collectives.reset_collectives()
    t0 = time.perf_counter()
    with _Tagger(rec) if backward else contextlib.nullcontext(), rec:
        yield trace
    trace.seconds = time.perf_counter() - t0
    stats = collectives.collective_stats()
    wire = collectives.collective_wire_bytes()
    trace.collectives = {
        "calls_by_type": {k: v["calls"] for k, v in stats.items()},
        "bytes_by_type": {k: v["bytes"] for k, v in stats.items()},
        "wire_bytes_by_type": wire,
        "total_bytes": float(sum(wire.values())),
    }


def top_contributors(trace: Trace, k: int = 15) -> dict[str, list[dict]]:
    """The ``k`` ops and the ``k`` modules that carry the most FLOPs and the
    most HBM bytes (``repro.parallel.hlo_debug.top_contributors``), each row
    ``{"name", "calls", "flops", "bytes"}``."""
    out = {}
    for table_name, table in (("op", trace.by_op), ("module", trace.by_module)):
        rows = [{"name": name, **row} for name, row in table.items()]
        for metric in ("flops", "bytes"):
            out[f"{table_name}_by_{metric}"] = sorted(
                rows, key=lambda r: r[metric], reverse=True)[:k]
    return out
