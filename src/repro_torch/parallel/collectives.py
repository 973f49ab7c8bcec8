"""The collectives of the tensor-parallel paths, and their counter.

Every collective of the port goes through :func:`all_reduce` or
:func:`all_gather`, over the process group of a mesh axis (``Mesh.group``);
each adds one call and the bytes of its local tensor to :data:`STATS` under
its kind, and does nothing (and counts nothing) over a group of one rank.
:func:`collective_stats` reads the counter, the counterpart of the JAX
package's ``collective_stats``, which counts the collectives of a compiled
program (``repro.parallel.hlo``).  Gloo runs both on CUDA tensors as well as
on the host; a collective the backend refuses raises, and nothing reroutes
it.  The tensor-parallel forward needs no other kind (no all-to-all: the
expert-parallel route is replicated routing and an all-reduce).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather")

#: calls and bytes by kind: ``STATS["all_reduce"] = {"calls": n, "bytes": b}``
STATS: dict[str, collections.Counter] = {k: collections.Counter() for k in KINDS}


def reset_collectives() -> None:
    for c in STATS.values():
        c.clear()


def collective_stats() -> dict[str, dict[str, int]]:
    """Calls and bytes of each kind since the last :func:`reset_collectives`."""
    return {k: {"calls": int(c["calls"]), "bytes": int(c["bytes"])} for k, c in STATS.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    STATS[kind]["calls"] += 1
    STATS[kind]["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, in place and returned
    (``t`` itself where the group is None: one rank)."""
    if group is None:
        return t
    t = t.contiguous()
    _count("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank order
    (``t`` where the group is None)."""
    if group is None:
        return t
    t = t.contiguous()
    _count("all_gather", t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)

