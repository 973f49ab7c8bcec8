"""Logical-axis sharding: the one place that says what shards where.

The port of ``repro.parallel.sharding``.  Every weight and cache entry of
the LM has *logical* axes (``"embed"``, ``"ff"``, ``"experts"``, …;
``models.param.param_axes`` and ``cache_axes``); a :class:`Rules` table maps
them onto mesh axes per (architecture × mode) (``parallel.rules``), and
:func:`spec_for_axes` resolves one tensor's axes to a :class:`PartitionSpec`
with the JAX package's two guards: a mesh axis is used at most once
(:data:`PRIORITY` order) and a dim that does not divide its mesh axes is
replicated instead.  Each guard that fires is reported (``explain=``,
:func:`record_spec_fallbacks`, one log line per distinct pair).

Where the JAX package hands the specs to pjit, the port places tensors
itself: a rank slices each tensor by its spec and its coordinates on the
:class:`Mesh` (``launch.steps.wire_serve_cell``), and the model's forward
closes every split with an explicit collective (``parallel.collectives``).
So :func:`constrain` stays a no-op.  A :class:`Mesh` made by
:func:`make_mesh` holds this process's coordinates, one process group per
mesh axis (and one over the data axes together, and one over all of them)
and its ``torch.device``; a mesh made from a shape alone
(``Mesh({"data": 2, "model": 4})``) carries no process and serves the spec
functions, which read only ``shape`` and ``axis_names``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or None
    (replicated); a tuple, so it compares equal to the JAX package's
    ``PartitionSpec`` entry by entry (a one-axis tuple is stored as its
    name, as JAX stores it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

#: the mesh axes that carry the batch, in the JAX package's order
DATA_AXES = ("pod", "data")


class Mesh:
    """A logical mesh of ranks: ``shape`` (axis name → size, in order) and
    ``axis_names``, what the spec functions read.

    Made by :func:`make_mesh` it is also this process's place in it:
    ``coords`` (axis → index; ranks are laid out row-major over the axes,
    as ``jax.make_mesh`` lays out devices), the process ``group`` of each
    axis, of the data axes together and of all axes (None where the axes
    have size 1), and ``device``, where this rank's tensors live."""

    def __init__(self, shape: Mapping[str, int], *, rank: int = 0, device=None,
                 groups: dict | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._groups = dict(groups or {})
        self.coords = {}
        rest = rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {name: self.coords[name] for name in self.axis_names}

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name, a tuple of names, or None: 1)."""
        return _axis_size(self, axes)

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple), the
        shard of a dim split over them that it holds."""
        if axes is None:
            return 0
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (a name or a tuple), or None where they are one rank."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in names if a in self.shape and self.shape[a] > 1)
        if not names:
            return None
        key = tuple(a for a in self.axis_names if a in names)
        if key not in self._groups:
            raise KeyError(f"no process group over mesh axes {key}: make the mesh with "
                           "make_mesh, which builds one a mesh axis and one over the data axes")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _group_keys(names: tuple[str, ...], shape: dict) -> list[tuple[str, ...]]:
    """The axis sets a mesh builds process groups over: each axis, the data
    axes together where there are several, and all the axes together (a
    training step's router statistics) where that is yet another set."""
    keys = [(a,) for a in names if shape[a] > 1]
    data = tuple(a for a in names if a in DATA_AXES and shape[a] > 1)
    if len(data) > 1:
        keys.append(data)
    every = tuple(a for a in names if shape[a] > 1)
    if len(every) > 1 and every not in keys:
        keys.append(every)
    return keys


def make_mesh(shape: Sequence[int], names: Sequence[str], *, backend: str,
              device: str = "cuda") -> Mesh:
    """This process's :class:`Mesh` over the initialised default process
    group, whose world must be ``prod(shape)`` ranks of ``backend``
    (``"gloo"`` or ``"nccl"``, the caller's choice: nothing is probed or
    switched).  ``device``: ``"cuda"`` puts rank ``r`` on card ``r`` modulo
    the cards there are (ranks share cards under gloo; ``"nccl"`` with more
    ranks than cards raises), ``"cpu"`` on the host.  Builds one process
    group a mesh axis, one over the data axes together and one over all
    axes, on every rank in the same order."""
    import torch.distributed as dist

    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(launch.mesh.spawn does it for each rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError("device='cuda' but there is no CUDA card")
        if backend == "nccl" and world > cards:
            raise ValueError(f"nccl needs a card a rank: {world} ranks, {cards} card(s)")
        dev = torch.device("cuda", rank % cards)
    elif device == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA tensors; use gloo for device='cpu'")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unknown device {device!r} (expected 'cuda' or 'cpu')")
    sizes = dict(zip(names, shape, strict=True))
    strides = {a: math.prod(shape[i + 1:]) for i, a in enumerate(names)}
    groups = {}
    for key in _group_keys(names, sizes):
        # every rank creates every group, in the same order
        others = [a for a in names if a not in key]
        mine = None
        for fixed in _coords_product([sizes[a] for a in others]):
            base = sum(c * strides[a] for a, c in zip(others, fixed, strict=True))
            members = sorted(base + sum(c * strides[a] for a, c in zip(key, pos, strict=True))
                             for pos in _coords_product([sizes[a] for a in key]))
            g = dist.new_group(members, backend=backend)
            if rank in members:
                mine = g
        groups[key] = mine
    return Mesh(sizes, rank=rank, device=dev, groups=groups)


def _coords_product(sizes: list[int]) -> list[tuple[int, ...]]:
    out: list[tuple[int, ...]] = [()]
    for n in sizes:
        out = [c + (i,) for c in out for i in range(n)]
    return out


# Resolution priority: earlier names win a contested mesh axis.
PRIORITY = [
    "experts",
    "vocab",
    "ff",
    "expert_ff",
    "q_heads",
    "kv_heads",
    "ssm_heads",
    "ssm_in",
    "cache_seq",
    "batch",
    "embed",
    "kv_lora",
    "ssm_state",
    "head_dim",
    "frames",
    "meta",
    "conv",
    "layers",
    "seq",
    "pairing_meta",
]


@dataclasses.dataclass(frozen=True)
class Rules:
    """Mapping logical axis -> mesh axis (str), tuple of mesh axes, or None."""

    table: Mapping[str, Any]

    def mesh_axes(self, name: str | None):
        if name is None:
            return None
        return self.table.get(name)


_state = threading.local()


def current() -> tuple[Mesh | None, Rules | None]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate(mesh: Mesh, rules: Rules):
    """Install (mesh, rules) for :func:`spec_for_axes` in this thread."""
    prev = current()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


_log = logging.getLogger(__name__)
_fallback_state = threading.local()
_logged_fallbacks: set[tuple[str, str]] = set()


@contextlib.contextmanager
def record_spec_fallbacks():
    """Collect every replication fallback :func:`spec_for_axes` takes inside
    the block: yields an insertion-ordered ``dict[(logical_axis, reason),
    count]``, complete after it.  Nested recorders shadow outer ones."""
    prev = getattr(_fallback_state, "sink", None)
    sink: dict[tuple[str, str], int] = {}
    _fallback_state.sink = sink
    try:
        yield sink
    finally:
        _fallback_state.sink = prev


def _note_fallback(explain: Callable[[str, str], None] | None, axis: str, reason: str) -> None:
    """Route a replication fallback to the explain hook, the active
    :func:`record_spec_fallbacks` sink, and (once per distinct pair) the log."""
    if explain is not None:
        explain(axis, reason)
    sink = getattr(_fallback_state, "sink", None)
    if sink is not None:
        sink[(axis, reason)] = sink.get((axis, reason), 0) + 1
    if (axis, reason) not in _logged_fallbacks:
        _logged_fallbacks.add((axis, reason))
        _log.info("sharding fallback: axis %r replicated — %s", axis, reason)


def spec_for_axes(
    axes: Sequence[str | None],
    *,
    mesh: Mesh | None = None,
    rules: Rules | None = None,
    dim_sizes: Sequence[int] | None = None,
    explain: Callable[[str, str], None] | None = None,
) -> PartitionSpec:
    """PartitionSpec for a tuple of logical axis names.

    Guards, as in the JAX package: (a) each mesh axis is used at most once,
    logical axes claiming in :data:`PRIORITY` order; (b) with ``dim_sizes``,
    a dim that does not divide its mesh axes is replicated.  Each guard that
    fires reports ``(logical_axis, reason)`` through ``explain=``, the active
    :func:`record_spec_fallbacks` sink and a once-per-pair log line.
    """
    if mesh is None or rules is None:
        m, r = current()
        mesh = mesh or m
        rules = rules or r
    if mesh is None or rules is None:
        return PartitionSpec(*([None] * len(axes)))

    order = sorted(
        range(len(axes)),
        key=lambda i: PRIORITY.index(axes[i]) if axes[i] in PRIORITY else len(PRIORITY),
    )
    used: set[str] = set()
    out: list[Any] = [None] * len(axes)
    for i in order:
        cand = rules.mesh_axes(axes[i])
        if cand is None:
            continue
        cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
        if any(c in used for c in cand_t):
            taken = sorted(c for c in cand_t if c in used)
            _note_fallback(explain, axes[i],
                           f"mesh axes {taken} already claimed by a higher-priority "
                           "logical axis")
            continue
        if dim_sizes is not None:
            size = dim_sizes[i]
            if size % _axis_size(mesh, cand_t) != 0:
                _note_fallback(explain, axes[i],
                               f"dim {size} not divisible by mesh axes "
                               f"{list(cand_t)} (size {_axis_size(mesh, cand_t)})")
                continue
        used.update(cand_t)
        out[i] = cand if isinstance(cand, str) else tuple(cand_t)
    return PartitionSpec(*out)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """The JAX package's sharding constraint on an activation: a no-op in the
    port, whose ranks hold their slices explicitly and close each split with
    a collective."""
    return x


def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(x, str | None) for x in a)


def _shape_of(t) -> tuple[int, ...] | None:
    shape = getattr(t, "shape", None)
    return None if shape is None else tuple(int(s) for s in shape)


def _tree_map(fn, axes, shapes):
    """``fn(axes_tuple, shaped)`` over an axes tree (dicts, lists, tuples of
    axes tuples) and a matching tree of tensors or arrays (or None)."""
    if isinstance(axes, dict):
        return {k: _tree_map(fn, a, None if shapes is None else shapes[k])
                for k, a in axes.items()}
    if _is_axes(axes):
        return fn(axes, shapes)
    if isinstance(axes, list | tuple):
        return type(axes)(_tree_map(fn, a, None if shapes is None else shapes[i])
                          for i, a in enumerate(axes))
    return fn(axes, shapes)


def shardings_for(axes_tree: Any, mesh: Mesh, rules: Rules, shapes_tree: Any = None) -> Any:
    """A :class:`PartitionSpec` tree for a tree of logical-axes tuples
    (where the JAX package returns ``NamedSharding``s: the port's placement
    is the spec and the rank's coordinates).  ``shapes_tree``: a matching
    tree of tensors or arrays for the divisibility guards."""
    def one(axes, shaped):
        return spec_for_axes(axes, mesh=mesh, rules=rules, dim_sizes=_shape_of(shaped))

    return _tree_map(one, axes_tree, shapes_tree)


def _pairing_meta_spec(
    w_name: str,
    w_axes: tuple[str | None, ...],
    w_spec: PartitionSpec,
    w_shape: tuple[int, ...],
    meta_shape: tuple[int, ...],
    mesh: Mesh,
) -> PartitionSpec:
    """PartitionSpec of one pairing-metadata leaf, derived from its sibling
    weight's *resolved* spec (never from a fresh rule resolution).

    Column-blocked metadata ``(L[, E], B, lanes)``: the block axis B shards
    like the weight's leading output-column dim when that dim is the only
    sharded column dim, blocks are uniform (``N % B == 0``) and the block
    count divides the shard count (``B % shards == 0``), so shard boundaries
    land on block boundaries.  Expert metadata copies the weight's expert
    axis.  Everything else (layers, lanes, structured metadata) is
    replicated: correct everywhere, and a rank reads only its own lanes.
    """
    nd_m = len(meta_shape)
    out: list[Any] = [None] * nd_m
    if nd_m == 0:
        return PartitionSpec()
    expert = "experts" in w_axes and len(w_shape) == 4
    mat0 = 2 if expert else 1
    nd_w = len(w_shape)
    if expert and nd_m >= 2 and meta_shape[1] == w_shape[1]:
        out[1] = w_spec[1]
    block_dim = 2 if expert else 1
    # blocked metadata carries (block, lane) behind the stack dims; structured
    # a single lane dim: nothing to place there
    if nd_m == block_dim + 2 and nd_w > mat0:
        col_dims = [nd_w - 1] if w_name == "wo" else list(range(mat0 + 1, nd_w))
        lead = w_spec[col_dims[0]]
        aligned = lead is not None and all(w_spec[d] is None for d in col_dims[1:])
        if aligned:
            n_cols = math.prod(w_shape[d] for d in col_dims)
            n_blocks = meta_shape[block_dim]
            shards = _axis_size(mesh, lead)
            if n_cols % n_blocks == 0 and n_blocks % shards == 0:
                out[block_dim] = lead
    return PartitionSpec(*out)


def paired_shardings_for(axes_tree: Any, mesh: Mesh, rules: Rules, shapes_tree: Any) -> Any:
    """:func:`shardings_for` for a *paired* tree: weights and every other
    leaf resolve through the rule table; a ``"<name>_pairing"`` sibling dict
    takes its placement from the sibling weight's resolved spec
    (:func:`_pairing_meta_spec`), so metadata lands beside the weight shard
    it indexes.  ``shapes_tree`` is required: the alignment guards need
    concrete dims."""

    def one(axes, shaped):
        return spec_for_axes(axes, mesh=mesh, rules=rules, dim_sizes=_shape_of(shaped))

    def walk(axes, shapes):
        if isinstance(axes, dict):
            out = {}
            for k, a in axes.items():
                w = k[: -len("_pairing")] if k.endswith("_pairing") else None
                if w is not None and isinstance(a, dict) and w in axes and _is_axes(axes[w]):
                    w_axes, w_shape = axes[w], _shape_of(shapes[w])
                    w_spec = spec_for_axes(w_axes, mesh=mesh, rules=rules, dim_sizes=w_shape)
                    out[k] = {mk: _pairing_meta_spec(w, w_axes, w_spec, w_shape,
                                                     _shape_of(shapes[k][mk]), mesh)
                              for mk in a}
                else:
                    out[k] = walk(a, shapes[k])
            return out
        if _is_axes(axes):
            return one(axes, shapes)
        if isinstance(axes, list | tuple):
            return type(axes)(walk(a, s) for a, s in zip(axes, shapes, strict=True))
        return one(axes, shapes)

    return walk(axes_tree, shapes_tree)
