"""The collectives of the tensor-parallel paths, and their counter.

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`grad_all_reduce` or
:func:`gather_blocks` (FSDP's: a layer's data-split weights in one
all-gather, their gradients in one reduce-scatter), over
the process group of a mesh axis (``Mesh.group``); each collective that runs
adds one call and the bytes of its local input tensor to :data:`STATS` under
its kind, and nothing runs (and nothing is counted) over a group of one
rank.  :func:`collective_stats` reads the counter, the counterpart of the
JAX package's ``collective_stats``, which counts the collectives of a
compiled program (``repro.parallel.hlo``); :func:`collective_wire_bytes`
the bytes each rank puts on the wire, by the JAX package's ring factors
(``parallel.cost``, the dry run).

Under autograd they are Megatron's pairs, each backward the other's
forward: :func:`all_reduce` sums forward and passes the gradient through;
:func:`grad_all_reduce` passes forward and sums the gradient;
:func:`all_gather` gathers forward and reduce-scatters the gradient;
:func:`reduce_scatter` reduce-scatters forward and gathers the gradient.  A
collective run in a backward counts under its own kind.  Without a gradient
to track (the serving paths run under ``no_grad``) :func:`all_reduce` sums
in place.  Gloo runs all four on CUDA tensors as well as on the host; a
collective the backend refuses raises, and nothing reroutes it.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "reduce_scatter")

#: calls, bytes and wire bytes by kind:
#: ``STATS["all_reduce"] = {"calls": n, "bytes": b, "wire": w}``
STATS: dict[str, collections.Counter] = {k: collections.Counter() for k in KINDS}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_collectives() -> None:
    for c in STATS.values():
        c.clear()


def collective_stats() -> dict[str, dict[str, int]]:
    """Calls and bytes of each kind since the last :func:`reset_collectives`."""
    return {k: {"calls": int(c["calls"]), "bytes": int(c["bytes"])} for k, c in STATS.items()}


def collective_wire_bytes() -> dict[str, float]:
    """The bytes this rank sent of each kind since the last
    :func:`reset_collectives`, by ``repro.parallel.hlo``'s ring factors over
    a group of ``n`` ranks and a local input of ``b`` bytes: an all-reduce
    2·(n−1)/n·b; an all-gather (n−1)/n of its n·b result; a reduce-scatter
    (n−1) times its b/n result."""
    return {k: float(c["wire"]) for k, c in STATS.items()}


_RING = {"all_reduce": lambda n: 2 * (n - 1) / n, "all_gather": lambda n: n - 1,
         "reduce_scatter": lambda n: (n - 1) / n}


def _count(kind: str, t: torch.Tensor, group) -> None:
    b = t.numel() * t.element_size()
    STATS[kind]["calls"] += 1
    STATS[kind]["bytes"] += b
    STATS[kind]["wire"] += _RING[kind](dist.get_world_size(group)) * b


def _all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = t.contiguous()
    _count("all_gather", t, group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    lead = t.movedim(dim, 0).contiguous()
    _count("reduce_scatter", lead, group)
    out = lead.new_empty((lead.shape[0] // n, *lead.shape[1:]))
    dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, ctx.dim), None, None


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the largest) of ``t`` over the ranks of
    ``group`` (``t`` itself where the group is None: one rank).  Without a
    gradient to track it sums in place and returns ``t``; under autograd a
    new tensor, whose gradient passes to ``t`` unchanged (a sum's only)."""
    if group is None:
        return t
    if not _tracked(t):
        return _all_reduce_(t.contiguous(), group, op)
    if op != "sum":
        raise ValueError(f"an all-reduce of op {op!r} has no gradient: detach its input")
    return _AllReduce.apply(t, group)


def grad_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged, whose gradient is summed over the ranks of ``group``
    (the backward of an all-reduce whose consumers each hold a part of its
    output's gradient)."""
    if group is None or not _tracked(t):
        return t
    return _GradAllReduce.apply(t, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank order
    (``t`` where the group is None); the gradient is reduce-scattered back."""
    if group is None:
        return t
    if not _tracked(t):
        return _all_gather(t, group, dim)
    return _AllGather.apply(t, group, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, of which this rank keeps
    its chunk along ``dim`` (the rank's index among ``n`` equal chunks; ``t``
    where the group is None); the gradient is all-gathered back."""
    if group is None:
        return t
    if not _tracked(t):
        return _reduce_scatter(t, group, dim)
    return _ReduceScatter.apply(t, group, dim)


def _gather_blocks(blocks, dims, dtypes, group) -> list[torch.Tensor]:
    """Every rank's ``blocks`` in one all-gather of their bytes (each in its
    ``dtypes`` entry), concatenated along its dim in rank order."""
    n = dist.get_world_size(group)
    parts = [b.detach().to(dt).contiguous().reshape(-1).view(torch.uint8)
             for b, dt in zip(blocks, dtypes, strict=True)]
    rows = _all_gather(torch.cat(parts), group, 0).view(n, -1)
    out, off = [], 0
    for b, dt, part, dim in zip(blocks, dtypes, parts, dims, strict=True):
        chunks = []
        for r in range(n):
            raw = rows[r, off:off + part.numel()]
            if raw.storage_offset() % dt.itemsize:
                raw = raw.clone()  # a view of another width needs an aligned start
            chunks.append(raw.view(dt).view(b.shape))
        out.append(torch.cat(chunks, dim=dim))
        off += part.numel()
    return out


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, dtypes, *blocks):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [b.shape for b in blocks]
        return tuple(_gather_blocks(blocks, dims, dtypes, group))

    @staticmethod
    def backward(ctx, *grads):
        n = dist.get_world_size(ctx.group)
        flat = torch.cat([g.float().narrow(dim, r * shape[dim], shape[dim]).reshape(-1)
                          for r in range(n)
                          for g, dim, shape in zip(grads, ctx.dims, ctx.shapes, strict=True)])
        mine = _reduce_scatter(flat.view(n, -1), ctx.group, 0).reshape(-1)
        sizes = [math.prod(shape) for shape in ctx.shapes]
        return (None, None, None, *(part.view(shape) for part, shape in
                                    zip(mine.split(sizes), ctx.shapes, strict=True)))


def gather_blocks(blocks: list[torch.Tensor], dims: list[int], group,
                  dtypes: list[torch.dtype]) -> list[torch.Tensor]:
    """FSDP's gather: each rank's ``blocks`` (its data-split weights) with
    the other ranks' of ``group``, each concatenated along its ``dims``
    entry in rank order and in its ``dtypes`` entry (the compute dtype for
    a matrix, its own for what the forward reads in fp32), in one
    all-gather of their bytes (``blocks`` themselves where the group is
    None).  Under autograd the gradient of every gathered tensor is
    reduce-scattered back in fp32, all of them in one call: each rank's
    block gets the sum of its rows' gradients over the group."""
    if group is None:
        return [b.to(dt) for b, dt in zip(blocks, dtypes, strict=True)]
    if not any(_tracked(b) for b in blocks):
        return _gather_blocks(blocks, dims, dtypes, group)
    return list(_GatherBlocks.apply(group, tuple(dims), tuple(dtypes), *blocks))
