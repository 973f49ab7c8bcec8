"""The dispatch trace of one step: the port's counterpart of a jaxpr.

The port of ``repro.analysis.jaxpr_walk``.  PyTorch runs eagerly, so there
is no program to walk: :func:`record_trace` runs the step once on real (or
fake) tensors under a ``TorchDispatchMode`` and records every aten op that
launches work (:data:`NO_LAUNCH` and views launch nothing): its name, the
dtype, shape and device of each tensor it reads and writes, whether it reads
a registered pairing-metadata storage, and the decode layer it ran in.

Every kernel call is one opaque node, whatever runs beneath it: the CUDA
kernel on the card, its plain PyTorch version on the CPU, as a
``pallas_call`` is one eqn of a jaxpr.  That is what lets a CPU trace and a
card trace give the same findings (K2's plain version would otherwise show
its residual add as a standalone add).  The nodes are the calls of K1's
wrappers ``paired_matmul_cuda`` / ``paired_matmul_blocked_cuda`` (or of
its operator ``repro_torch::k1``, which the differentiable GEMMs call), of
K2's ``decode_attention_cuda`` / ``fused_decode_attention_cuda``, and of
K3's ``flash_attention_fwd``.  Each K1 node carries its problem
``(M, P, R, n_blocks, bn, pool, itemsize)`` and the plan its launch takes
(``kernels.tuning.resolve_plan``, worked out on the host, so the CPU trace
has it too); each K2 node its ``k2_plan``.

Kernel regions, decode-layer boundaries (calls of ``models.lm.layer_decode``),
standalone pools (``kernels.paired_conv.pool2_reference``) and the sends of
``parallel.collectives`` are marked with ``sys.monitoring`` on those
functions' code objects alone, as ``analysis.counting`` counts, so nothing
on the path changes.  A wrapper that raises ends the trace (its exception
leaves :func:`record_trace`).

Eager PyTorch launches every layer, so a count over a trace covers the
whole step where the JAX count covers a scan body once: the port's count a
layer (:func:`kernels_by_layer`) is the JAX count a trip, and its count a
program is that count times the layers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from collections.abc import Iterable, Sequence
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ops that launch nothing: device and dtype queries, allocations without a
#: fill, and ``_unsafe_view`` (a view the schema does not mark as one)
NO_LAUNCH = {"aten.detach", "prim.device", "aten.empty", "aten.empty_like",
             "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided",
             "aten.lift_fresh", "aten._local_scalar_dense", "aten.sym_size",
             "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset",
             "aten.is_same_size", "aten._has_compatible_shallow_copy_type",
             "aten.promote_types", "aten._unsafe_view"}

#: the pairing-metadata keys of one weight's metadata dict, and its index arrays
META_KEYS = ("I", "J", "resid", "pair_mask", "resid_mask")
INDEX_KEYS = ("I", "J", "resid")


@dataclasses.dataclass
class Op:
    """One node of a trace.  ``kind`` is ``"op"`` (an aten op), ``"kernel"``
    (one kernel call, opaque; ``info`` holds ``kernel`` — ``"K1"``, ``"K2"``
    or ``"K3"`` —, ``form``, and for K1 and K2 ``problem`` and ``plan``) or
    ``"call"`` (a standalone pool or a collective's send).  ``ins`` and
    ``outs`` are ``(dtype, shape, device type)`` of each tensor read and
    written; ``pairing`` is whether one read tensor's storage is a
    registered pairing-metadata storage."""

    name: str
    kind: str
    ins: tuple = ()
    outs: tuple = ()
    layer: int | None = None
    pairing: bool = False
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Trace:
    """What :func:`record_trace` saw: the ops in order, the decode layers
    entered, the pairing storages registered (their count and the index
    arrays' shapes), and the kernel launches made meanwhile (by kernel:
    the wrappers' counters, CUDA tensors only)."""

    ops: list[Op] = dataclasses.field(default_factory=list)
    n_layers: int = 0
    pairing_buffers: int = 0
    pairing_index_shapes: set = dataclasses.field(default_factory=set)
    launches: dict = dataclasses.field(default_factory=dict)
    #: the traced function's result
    result: Any = dataclasses.field(default=None, repr=False, compare=False)

    def kernels(self, kernel: str | None = None) -> list[Op]:
        """The kernel nodes, of one kernel (``"K1"``) if given."""
        return [op for op in self.ops if op.kind == "kernel"
                and (kernel is None or op.info["kernel"] == kernel)]


def _flat(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, list | tuple):
        for v in tree:
            yield from _flat(v)


def _desc(t: torch.Tensor) -> tuple:
    return str(t.dtype).removeprefix("torch."), tuple(t.shape), t.device.type


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def pairing_tensors(model) -> Iterable[tuple[str, torch.Tensor]]:
    """``(key, tensor)`` of every pairing-metadata tensor a model's blocks
    hold (``pairing`` and FSDP's ``gathered``), or of a list of metadata
    dicts."""
    metas = (model if isinstance(model, list | tuple) else
             [m for block in model.modules()
              for group in (getattr(block, "pairing", {}), getattr(block, "gathered", {}))
              for m in group.values()])
    for meta in metas:
        for key, t in meta.items():
            if isinstance(t, torch.Tensor):
                yield key, t


def _k1_problem(x_shape, kmat_shape, w_res_shape, pool: str, itemsize: int) -> tuple:
    """(M, P, R, n_blocks, bn, pool, itemsize) of a K1 call (``kernels.
    paired_matmul._problem``): structured ``kmat`` (P, N) or blocked (B, P, bn)."""
    B, P, bn = kmat_shape if len(kmat_shape) == 3 else (1, *kmat_shape)
    return x_shape[-2], P, w_res_shape[-2], B, bn, pool, itemsize


def _k1_form(P: int, blocked: bool, pool: str) -> str:
    """K1's launch counter's name of a call (``paired_matmul._launch``)."""
    return (("paired_matmul" if P else "dense_matmul") + ("_blocked" if blocked else "")
            + ("_pool" if pool != "none" else ""))


def k1_node_info(x_shape, kmat_shape, w_res_shape, pool: str, itemsize: int,
                 residual: bool) -> dict:
    """A K1 node's ``info``: form, problem and the plan its launch takes."""
    from repro_torch.kernels import tuning

    problem = _k1_problem(x_shape, kmat_shape, w_res_shape, pool, itemsize)
    return {"kernel": "K1", "form": _k1_form(problem[1], len(kmat_shape) == 3, pool),
            "problem": problem, "residual": residual,
            "plan": tuning.resolve_plan(*problem, residual=residual)}


def _k2_node_info(q, k_cache, proj) -> dict:
    from repro_torch.kernels import tuning

    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if proj is None:
        n_cols, bn, P, R, form = 0, 1, 0, 0, "decode_attention"
    else:
        kmat, w_res, n_cols = proj
        bn, P, R, form = kmat.shape[-1], kmat.shape[1], w_res.shape[1], "fused_decode_attention"
    problem = (B, S, H, KH, D, n_cols, max(bn, 1), P, R, q.element_size())
    return {"kernel": "K2", "form": form, "problem": problem, "plan": tuning.k2_plan(*problem)}


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace, storages: set[int]):
        super().__init__()
        self.trace, self.storages = trace, storages
        self.depth = 0  # kernel regions open
        self.node: Op | None = None  # the open kernel node
        self.layer: int | None = None

    # -- kernel regions, layers and calls, from sys.monitoring ------------

    def open_kernel(self, info, ins) -> None:
        """Enter a kernel region; the outermost one is a node, its ``info()``
        and the tensors ``ins()`` it reads worked out only then."""
        self.depth += 1
        if self.depth == 1:
            info, ins = info(), ins()
            self.node = Op(f"{info['kernel']}/{info['form']}", "kernel",
                           tuple(map(_desc, ins)), (), self.layer, self._reads_pairing(ins), info)
            self.trace.ops.append(self.node)

    def close_kernel(self, out) -> None:
        self.depth -= 1
        if self.depth == 0 and self.node is not None:
            self.node.outs = tuple(map(_desc, _flat(out)))
            self.node = None

    def call(self, name: str, ins: Sequence[torch.Tensor]) -> None:
        if self.depth == 0:
            self.trace.ops.append(Op(name, "call", tuple(map(_desc, ins)), (), self.layer,
                                     self._reads_pairing(ins)))

    def _reads_pairing(self, tensors) -> bool:
        return bool(self.storages) and any(_storage(t) in self.storages for t in tensors)

    # -- aten ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") else str(func)
        if name == "repro_torch.k1" and self.depth == 0:
            xg, kmat, w_res, _, residual = args[:5]
            # a structured call flattens its leading dims to the kernel's rows
            rows = xg.shape[:-1] if kmat.ndim == 3 else (math.prod(xg.shape[:-1]),)
            self.open_kernel(lambda: k1_node_info((*rows, xg.shape[-1]), tuple(kmat.shape),
                                                  tuple(w_res.shape), "none", xg.element_size(),
                                                  residual is not None),
                             lambda: list(_flat(args)))
            out = func(*args, **kwargs)
            self.close_kernel(out)
            return out
        out = func(*args, **kwargs)
        if (self.depth or name in NO_LAUNCH or name.startswith("profiler.")
                or getattr(func, "is_view", False)):
            return out
        ins = list(_flat((args, kwargs)))
        self.trace.ops.append(Op(name, "op", tuple(map(_desc, ins)),
                                 tuple(map(_desc, _flat(out))), self.layer,
                                 self._reads_pairing(ins)))
        return out


def _monitored(rec: _Recorder) -> dict:
    """{code object: (on start(frame locals), on return(value))} of every
    function the trace marks."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.paired_conv import pool2_reference
    from repro_torch.models import lm
    from repro_torch.parallel import collectives as coll

    def k1(f):
        x, kmat, w_res, pool = f["x"], f["kmat"], f["w_res"], f["pool"]
        rec.open_kernel(lambda: k1_node_info(tuple(x.shape), tuple(kmat.shape),
                                             tuple(w_res.shape), pool, x.element_size(),
                                             f["residual"] is not None),
                        lambda: [t for t in (x, kmat, w_res, f["bias"], f["residual"])
                                 if t is not None])

    def k2(fused: bool):
        def start(f):
            names = (("q", "k_cache", "v_cache", "pos", "idx_i", "idx_j", "idx_r", "kmat",
                      "w_res", "residual") if fused else ("q", "k_cache", "v_cache", "pos"))
            proj = (f["kmat"], f["w_res"], f["n_cols"]) if fused else None
            rec.open_kernel(lambda: _k2_node_info(f["q"], f["k_cache"], proj),
                            lambda: [f[n] for n in names if f[n] is not None])
        return start

    def k3(f):
        rec.open_kernel(lambda: {"kernel": "K3", "form": "flash_attention"},
                        lambda: [f["q"], f["k"], f["v"]])

    def layer_start(f):
        rec.layer = rec.trace.n_layers
        rec.trace.n_layers += 1

    def layer_end(_):
        rec.layer = None

    def pool(f):
        if f["pool"] not in ("none", None):
            rec.call("call/pool2_reference", [f["y"]])

    def send(name: str, arg: str):
        return lambda f: rec.call(f"call/{name}", list(_flat(f[arg])))

    close = rec.close_kernel
    return {
        pm.paired_matmul_cuda.__code__: (k1, close),
        pm.paired_matmul_blocked_cuda.__code__: (k1, close),
        da.decode_attention_cuda.__code__: (k2(False), close),
        da.fused_decode_attention_cuda.__code__: (k2(True), close),
        fa.flash_attention_fwd.__code__: (k3, close),
        lm.layer_decode.__code__: (layer_start, layer_end),
        pool2_reference.__code__: (pool, None),
        coll._all_reduce_.__code__: (send("all_reduce", "t"), None),
        coll._all_gather.__code__: (send("all_gather", "t"), None),
        coll._reduce_scatter.__code__: (send("reduce_scatter", "t"), None),
        coll._gather_blocks.__code__: (send("gather_blocks", "blocks"), None),
    }


@contextlib.contextmanager
def monitoring(hooks: dict):
    """Inside the block, call ``on_start(frame locals)`` as each code object
    of ``hooks`` (``{code: (on_start, on_return)}``, either may be None)
    starts and ``on_return(value)`` as it returns, through a free
    ``sys.monitoring`` tool id set on those code objects alone, so nothing
    on the path changes."""
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id")
    events = mon.events

    def on_start(code, offset):
        start = hooks[code][0]
        if start is not None:
            start(sys._getframe(1).f_locals)

    def on_return(code, offset, value):
        end = hooks[code][1]
        if end is not None:
            end(value)

    mon.use_tool_id(tool, __name__)
    try:
        mon.register_callback(tool, events.PY_START, on_start)
        mon.register_callback(tool, events.PY_RETURN, on_return)
        for code in hooks:
            mon.set_local_events(tool, code, events.PY_START | events.PY_RETURN)
        yield
    finally:
        for code in hooks:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, events.PY_START, None)
        mon.register_callback(tool, events.PY_RETURN, None)
        mon.free_tool_id(tool)


@contextlib.contextmanager
def tracing(*, pairing=None):
    """Record the ops run inside the block into the :class:`Trace` it
    yields (complete after it).  ``pairing``: a model (or a list of
    metadata dicts) whose pairing-metadata storages the trace registers."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paired_matmul as pm

    trace = Trace()
    storages: set[int] = set()
    if pairing is not None:
        for key, t in pairing_tensors(pairing):
            storages.add(_storage(t))
            trace.pairing_buffers += 1
            if key in INDEX_KEYS:
                trace.pairing_index_shapes.add(tuple(t.shape))
    rec = _Recorder(trace, storages)
    counters = {"K1": pm.launch_count, "K2": da.launch_count, "K3": fa.launch_count}
    before = {k: fn() for k, fn in counters.items()}
    with monitoring(_monitored(rec)), rec:
        yield trace
    trace.launches = {k: fn() - before[k] for k, fn in counters.items()}


def record_trace(fn, *args, pairing=None, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under :func:`tracing` and return its
    trace (the result in ``trace.result``)."""
    with tracing(pairing=pairing) as trace:
        trace.result = fn(*args, **kwargs)
    return trace


# ---------------------------------------------------------------------------
# walks (the counterparts of count_primitives, count_shape_adds and
# pallas_calls_by_scan)
# ---------------------------------------------------------------------------


def count_ops(trace: Trace, *names: str) -> int:
    """Nodes of ``trace`` outside the kernels named any of ``names`` (aten
    ops by their packet, ``"aten.max_pool2d"``; calls and kernels by
    theirs, ``"call/pool2_reference"``, ``"K1/paired_matmul"``)."""
    return sum(1 for op in trace.ops if op.name in names)


def _is_shape_add(op: Op, shape: tuple) -> bool:
    if op.kind != "op" or op.name not in ("aten.add", "aten.add_"):
        return False
    tensors = [*op.ins, *op.outs]
    return len(op.ins) >= 2 and all(t[1] == shape for t in tensors)


def count_shape_adds(trace: Trace, shape: Sequence[int]) -> int:
    """``add`` ops whose output *and every tensor operand* have ``shape``,
    outside the kernels: the signature of a standalone residual add (``h +
    attn(x)``), as bias adds and norm arithmetic broadcast from lower-rank
    operands and never match."""
    shape = tuple(shape)
    return sum(1 for op in trace.ops if _is_shape_add(op, shape))


def kernels_by_layer(trace: Trace) -> tuple[int, dict[int, int]]:
    """(kernel nodes in all, {decode layer: kernel nodes inside it}):
    nodes outside every layer are only in the total.  A layer that ran no
    kernel is in the dict with 0."""
    per = {i: 0 for i in range(trace.n_layers)}
    total = 0
    for op in trace.kernels():
        total += 1
        if op.layer is not None:
            per[op.layer] += 1
    return total, per
