"""Launch plans for the paired GEMM kernel (K1) and the fused decode
attention (K2) on an H100.

The port's counterpart of the block choice in ``repro.kernels.tuning``
(``choose_blocks``), redone for this card: 132 SMs, 227 KB of shared memory
per block, thread-block clusters of at most 8 CTAs (the portable size).
:func:`plan` is a pure function of the launch's shape; the wrapper passes
the plan :func:`resolve_plan` picks to the C entry point, which checks it and
refuses a plan out of range (:func:`refusal` is the same check on the host).
Measured plans beat the heuristic where a :class:`TileCache` is active
(:func:`use_tile_cache`): :func:`autotune_plans` times the
:func:`candidate_plans` of one problem and writes the fastest through, under
the JAX package's :func:`cache_key` of that problem.

Two forms of the one kernel (``csrc/paired_matmul.cu``), 128 threads a CTA:

* **skinny** — decode and prefill rows (``M ≤ 64``, no pool).  A CTA owns
  ``cols`` output columns of one column block and one slice of the
  contraction; each thread holds ``tn`` adjacent columns for ``rows`` rows
  (more rows run in passes) and streams its weight rows as ``tn``-element
  vectors through a ``cp.async`` ring.  The ``splits`` slices of one column
  tile are the CTAs of one cluster; their fp32 partial sums meet in the
  leader CTA through distributed shared memory, in rank order.
* **tall** — LeNet's 1 000–196 000 rows, pooled or not.  A CTA owns ``tn``
  columns of one block and ``subtiles`` sub-tiles of ``rows`` pooled rows.
  A sub-tile's whole rows are, per pool window, one contiguous span of x:
  it passes through a ``cp.async`` ring of up to 3 ``stages`` as 16-byte
  copies; ``lanes`` threads share a window-row and split its lanes, and
  each thread holds :func:`tall_rows_per_thread` window-rows.
  Where the grid would leave SMs idle the contraction is split over a
  cluster as in the skinny form.

K2 (``csrc/decode_attention.cu``, 256 threads a CTA) takes a
:class:`K2Plan` from :func:`k2_plan`: a cluster of ``cluster`` CTAs owns
``slots`` slots, deals their (slot, unit, key range) work items over its
ranks (a unit is a KV head with its query heads, or a group of them;
``splits`` key ranges per pair, cut in the kernel from each slot's position)
and merges the partial softmax sums through distributed shared memory; in
the fused form each CTA then owns ``cols`` columns of one column block for
all those slots, ``tn`` adjacent columns a thread.  The plan also lays out
the kernel's shared memory (:func:`k2_layout`), which the kernel follows.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import re
import threading
import time
from pathlib import Path

SMS = 132
SMEM_PER_BLOCK = 232_448  # 227 KB: the opt-in dynamic shared memory of a block
SMEM_PER_SM = 233_472  # 228 KB an SM
MAX_CLUSTER = 8  # portable cluster size
MAX_GRID_Y = 65_535
TARGET_CTAS = 2 * SMS  # at least two CTAs on every SM where the shape allows
THREADS = 128

SKINNY_MAX_ROWS = 64  # decode and prefill; more rows stream the weights again
SKINNY_STAGES = 5  # cp.async ring depth
SKINNY_UNROLL = 4  # weight rows per thread per stage
TALL_STAGES = 3
STAGE_BYTES = 8_192  # x a tall stage holds, about
TALL_CTAS = 8 * SMS  # enough CTAs to keep eight on every SM
TALL_MAX_SUBTILES = 64
TALL_SMEM = SMEM_PER_BLOCK // 4  # shared memory a tall CTA aims to stay under

# (rows, tn) of the skinny instances the source compiles, by element size;
# more than 4 rows take the 16-row ones first
SKINNY_SHAPES = {2: ((4, 8), (4, 4), (16, 4)), 4: ((4, 4), (16, 4))}
# tn of the tall instances, for both pool windows (1 and 4)
TALL_TN = (1, 4, 8)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of K1.

    skinny: ``rows`` rows a pass, ``cols`` columns and one K-slice a CTA,
    ``tn`` adjacent columns a thread.  tall: ``rows`` pooled rows a
    sub-tile (a ring stage), ``subtiles`` sub-tiles and ``cols == tn``
    columns a CTA, ``lanes`` threads a window-row.  Both: ``splits``
    K-slices of a column tile, the CTAs of one cluster; ``stages`` ring
    slots; ``smem`` the dynamic shared memory the kernel lays out for this
    plan, in bytes (the kernel's entry point works it out itself: this is
    the planner's model of it, which the card's kernel phase holds equal).
    """

    form: str  # "skinny" | "tall"
    rows: int
    cols: int
    tn: int
    splits: int
    lanes: int
    subtiles: int
    stages: int
    smem: int

    def grid(self, M: int, n_blocks: int, bn: int) -> tuple[int, int]:
        """(x, y) CTAs of the launch, as the kernel's entry point works them
        out: x the K-slices (of each group of sub-tiles, tall), y the
        column tiles of every block."""
        tiles = n_blocks * -(-bn // self.cols)
        if self.form == "skinny":
            return self.splits, tiles
        return -(-(-(-M // self.rows)) // self.subtiles) * self.splits, tiles

    def slices(self, P: int, R: int) -> list[tuple[int, int]]:
        """[begin, end) of each cluster rank's effective lanes, as the
        kernel computes them from ``splits``."""
        return slice_bounds(P + R, self.splits)

    def as_args(self) -> tuple[int, ...]:
        """The C entry point's plan arguments."""
        return (int(self.form == "skinny"), self.rows, self.cols, self.tn, self.splits,
                self.lanes, self.subtiles, self.stages)


def slice_step(ke: int, splits: int) -> int:
    """Lanes per K-slice: ``ceil(ke / splits)`` (the kernel computes the same)."""
    return -(-ke // splits) if ke else 0


def slice_bounds(ke: int, splits: int) -> list[tuple[int, int]]:
    """[begin, end) of each of ``splits`` contiguous slices of ``ke`` lanes."""
    step = slice_step(ke, splits)
    return [(min(ke, s * step), min(ke, (s + 1) * step)) for s in range(splits)]


def _splits(ke: int, want: int) -> int:
    """At most ``want`` (and MAX_CLUSTER) slices of ``ke`` lanes, none empty."""
    if not ke:
        return 1
    s = max(1, min(want, MAX_CLUSTER, ke))
    return -(-ke // slice_step(ke, s))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pow2_at_most(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def _units(lanes: int, itemsize: int) -> int:
    """16-byte units that hold ``lanes`` elements at any alignment."""
    return (lanes * itemsize + 15) // 16 + 1


def _skinny_smem(rows, cols, tn, itemsize, lanes, pairs, splits) -> int:
    """Bytes of the skinny form's shared memory (csrc ``skinny_layout``)."""
    ring = SKINNY_STAGES * SKINNY_UNROLL * THREADS * tn * itemsize
    reduce = 4 * rows * cols * 4  # at most four partials per output
    gather = splits * rows * cols * 4  # every rank's partial sums, in the leader
    # x's raw segments: a slice's pairs' I lanes, then its J and residual lanes
    raw = rows * (_units(min(lanes, pairs), itemsize) + _units(lanes, itemsize)) * 16
    return rows * lanes * 4 + max(ring, reduce) + gather + raw


def _waves(smem: int, ctas: int) -> int:
    """Rounds of CTAs the card runs, as shared memory per SM allows them
    (with the 1 KB it reserves for each resident block)."""
    return -(-ctas // (SMS * max(1, SMEM_PER_SM // (smem + 1024))))


def _one_wave(smem: int, ctas: int) -> bool:
    return _waves(smem, ctas) == 1


def _plan_skinny(M, P, R, n_blocks, bn, itemsize) -> Plan | None:
    """The widest column tile (the longest contiguous weight rows) that,
    split over a cluster, puts TARGET_CTAS on the card in one wave; else the
    one with the fewest waves; else the plan with the most CTAs; None
    where no instance takes the shape.
    More than 16 rows run in passes of 16 (of 4 where 16 do not fit)."""
    ke = P + R
    fits = []  # (plan, CTAs)
    shapes = SKINNY_SHAPES[itemsize]
    for rows, tn in sorted(shapes, key=lambda s: -s[0]) if M > 4 else shapes:
        if (M <= 4 and rows != 4) or bn % tn:
            continue
        cols = min(_pow2_at_least(bn), 256)
        while cols >= tn:
            tiles = n_blocks * -(-bn // cols)
            splits = _splits(ke, -(-TARGET_CTAS // tiles))
            smem = _skinny_smem(rows, cols, tn, itemsize, slice_step(ke, splits), P, splits)
            if tiles <= MAX_GRID_Y and smem <= SMEM_PER_BLOCK:
                p = Plan("skinny", rows, cols, tn, splits, 0, 1, SKINNY_STAGES, smem)
                ctas = splits * tiles
                if ctas >= TARGET_CTAS and _one_wave(smem, ctas):
                    return p
                fits.append((p, ctas))
            cols //= 2
        if fits and M > 4:
            break  # 16 rows a pass fit: no passes of 4
    wide = [f for f in fits if f[1] >= TARGET_CTAS]  # in two waves or more: the fewest
    if wide:
        return min(wide, key=lambda f: (_waves(f[0].smem, f[1]), -f[0].cols))[0]
    return max(fits, key=lambda f: f[1], default=(None,))[0]


def _tall_block(rows: int, K: int, itemsize: int) -> int:
    """Shared-memory bytes of one window's ``rows`` whole rows: the 16-byte
    units around a contiguous span of x."""
    return -(-rows * K * itemsize // 16) * 16 + 16


def tall_rows_per_thread(tn: int) -> int:
    """Window-rows a tall thread holds at once: each weight it loads feeds
    that many times ``tn`` multiply-adds (2 measured faster than 4 at
    tn = 8: fewer registers, more CTAs an SM)."""
    return 1 if tn == 1 else 2


def _tall_smem(window, rows, K, itemsize, tn, slice_lanes, splits, stages) -> int:
    """Bytes of the tall form's shared memory (csrc ``tall_layout``)."""
    weights = -(-slice_lanes * tn * 4 // 16) * 16
    part = window * rows * tn * 4 if splits > 1 else 0
    return weights + stages * window * _tall_block(rows, K, itemsize) + part


def _plan_tall(M, P, R, n_blocks, bn, window, itemsize, tn: int = 0) -> Plan | None:
    """The tall form at ``tn`` columns a CTA (0: by the block's width)."""
    ke, K = P + R, 2 * P + R
    tn = tn or (1 if bn == 1 else 4 if bn <= 4 else 8)
    col_tiles = n_blocks * -(-bn // tn)
    if col_tiles > MAX_GRID_Y:
        return None
    # a window-row's lanes over a few threads: 16 lanes or more each (24 where
    # every lane feeds tn > 1 columns), at most 8 threads pooled / 16 not; and
    # at least gcd(K, 32) of them, so the rows a warp reads start on other banks
    lanes = min(8 if window == 4 else 16, _pow2_at_most(max(1, ke // (24 if tn > 1 else 16))))
    lanes = max(1, min(32 // window, max(lanes, math.gcd(K, 32) if K else 1)))
    # pooled rows the threads take at once
    base = THREADS * tall_rows_per_thread(tn) // (lanes * window)
    # about STAGE_BYTES of x a stage
    rows = max(base, STAGE_BYTES // max(1, window * K * itemsize) // base * base)
    rows = min(rows, -(-M // base) * base)
    n_sub = -(-M // rows)
    # sub-tiles a CTA: as many as leave eight CTAs an SM (a longer ring,
    # fewer prologues); at least four times the weights' bytes of x a CTA,
    # as far as two CTAs an SM allow
    x_bytes = window * rows * K * itemsize
    by_weights = min(-(-4 * ke * tn * 4 // max(1, x_bytes)), n_sub * col_tiles // TARGET_CTAS)
    subtiles = max(n_sub * col_tiles // TALL_CTAS, by_weights)
    subtiles = max(1, min(TALL_MAX_SUBTILES, subtiles, n_sub))
    groups = -(-n_sub // subtiles)
    splits = 1
    if subtiles == 1 and groups * col_tiles < TARGET_CTAS:
        splits = _splits(ke, -(-TARGET_CTAS // (groups * col_tiles)))
    stages = min(TALL_STAGES, subtiles)  # a slot for each sub-tile in flight
    smem = lambda: _tall_smem(window, rows, K, itemsize, tn, slice_step(ke, splits), splits,
                              stages)
    while smem() > SMEM_PER_BLOCK and rows > base:
        rows -= base
    while smem() > TALL_SMEM and stages > 1:  # four CTAs an SM before a deeper ring
        stages -= 1
    if smem() > SMEM_PER_BLOCK:
        return None
    return Plan("tall", rows, tn, tn, splits, lanes, subtiles, stages, smem())


@functools.cache
def plan(M: int, P: int, R: int, n_blocks: int, bn: int, window: int, itemsize: int) -> Plan:
    """The launch plan of one K1 call: ``M`` output rows, ``P`` pairs and
    ``R`` residual lanes per block, ``n_blocks`` column blocks of ``bn``
    columns, pool ``window`` 1 or 4, element size 4 (fp32) or 2 (bf16)."""
    if itemsize not in SKINNY_SHAPES or window not in (1, 4):
        raise ValueError(f"no plan for itemsize={itemsize}, window={window}")
    skinny = window == 1 and P + R > 0
    if skinny and M <= SKINNY_MAX_ROWS:
        p = _plan_skinny(M, P, R, n_blocks, bn, itemsize)
        if p is not None:
            return p
    p = _plan_tall(M, P, R, n_blocks, bn, window, itemsize)
    if p is None and skinny:  # rows too long to stage: stream them in passes
        p = _plan_skinny(min(M, SKINNY_MAX_ROWS), P, R, n_blocks, bn, itemsize)
    if p is None:
        raise ValueError(f"no K1 plan for M={M}, P={P}, R={R}, blocks={n_blocks}, bn={bn}, "
                         f"window={window}")
    return p


# ---------------------------------------------------------------------------
# K1: the host's check of a plan, the persisted tile cache, measured plans
# ---------------------------------------------------------------------------

#: the pool epilogue's window of each pool the cache keys name
POOL_WINDOWS = {"none": 1, "max2": 4, "avg2": 4}
#: K1's element types by size, under the names the JAX package's keys use
DTYPE_NAMES = {4: "float32", 2: "bfloat16"}
#: K-slices of a column tile that the candidates try (a cluster's CTAs)
CANDIDATE_SPLITS = (1, 2, 4, 8)


def plan_smem(plan: Plan, P: int, R: int, window: int, itemsize: int) -> int:
    """The planner's model of the shared memory ``plan`` lays out (its
    ``smem`` field, whatever it holds)."""
    step = slice_step(P + R, plan.splits)
    if plan.form == "skinny":
        return _skinny_smem(plan.rows, plan.cols, plan.tn, itemsize, step, P, plan.splits)
    return _tall_smem(window, plan.rows, 2 * P + R, itemsize, plan.tn, step, plan.splits,
                      plan.stages)


def _resized(plan: Plan, P, R, window, itemsize, **fields) -> Plan:
    """``plan`` with ``fields`` replaced and its ``smem`` worked out again."""
    p = dataclasses.replace(plan, **fields)
    return dataclasses.replace(p, smem=plan_smem(p, P, R, window, itemsize))


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def refusal(plan: Plan, M: int, P: int, R: int, n_blocks: int, bn: int, window: int,
            itemsize: int) -> str | None:
    """Why the C entry point (``paired_matmul_launch``) would refuse
    ``plan`` for this launch, or None where it takes it: its range checks,
    and the instances the source compiles (``SKINNY_SHAPES``, ``TALL_TN``).
    ``plan.smem`` is not read: the shared memory is worked out from the
    other fields, as the kernel does."""
    ke = P + R
    if plan.form not in ("skinny", "tall"):
        return f"form {plan.form!r}"
    if not 1 <= plan.rows <= 65_536 or plan.cols < 1 or not _pow2(plan.tn):
        return "rows, cols or tn out of range"
    if not 1 <= plan.splits <= MAX_CLUSTER:
        return f"{plan.splits} K-slices (a cluster holds 1 to {MAX_CLUSTER})"
    step = slice_step(ke, plan.splits)
    if ke and (plan.splits - 1) * step >= ke or not ke and plan.splits != 1:
        return f"{plan.splits} K-slices of {ke} lanes leave one empty"
    if plan.form == "skinny":
        if window != 1 or ke < 1:
            return "the skinny form takes no pool and no empty contraction"
        if (plan.rows, plan.tn) not in SKINNY_SHAPES[itemsize]:
            return f"no skinny instance of {plan.rows} rows × {plan.tn} columns"
        if (not _pow2(plan.cols) or bn % plan.tn or plan.cols % plan.tn
                or plan.cols // plan.tn > THREADS):
            return f"a column tile of {plan.cols} at tn={plan.tn}, bn={bn}"
        if plan.stages != SKINNY_STAGES or plan.subtiles != 1:
            return f"the skinny form runs {SKINNY_STAGES} stages and one sub-tile"
    else:
        if plan.tn not in TALL_TN or plan.cols != plan.tn:
            return f"no tall instance of {plan.tn} columns (cols {plan.cols})"
        if not _pow2(plan.lanes) or plan.lanes * window > 32:
            return f"{plan.lanes} threads a window-row"
        if window * plan.rows % (THREADS // plan.lanes * tall_rows_per_thread(plan.tn)):
            return f"{plan.rows} rows a sub-tile do not fill the threads"
        if not 1 <= plan.stages <= TALL_STAGES or plan.subtiles < 1:
            return f"{plan.stages} stages, {plan.subtiles} sub-tiles"
        if plan.splits > 1 and plan.subtiles != 1:
            return "a split contraction takes one sub-tile a CTA"
        groups = -(-(-(-M // plan.rows)) // plan.subtiles)
        if groups * plan.splits > 2**31 - 1:
            return "too many CTAs"
    smem = plan_smem(plan, P, R, window, itemsize)
    if smem > SMEM_PER_BLOCK:
        return f"{smem} bytes of shared memory (at most {SMEM_PER_BLOCK})"
    tiles = n_blocks * -(-bn // plan.cols)
    if tiles > MAX_GRID_Y:
        return f"{tiles} column tiles (at most {MAX_GRID_Y})"
    return None


def candidate_plans(M: int, P: int, R: int, n_blocks: int, bn: int, window: int,
                    itemsize: int) -> list[Plan]:
    """The plans :func:`autotune_plans` measures for one launch: the
    heuristic :func:`plan` first, then variants of its form that the C
    entry point takes, none twice.

    skinny: the instances of the heuristic's rows a pass (``SKINNY_SHAPES``),
    each at the heuristic's column tile, half and twice it, split over 1, 2,
    4 and 8 CTAs (at most 24).  tall: each of ``TALL_TN`` up to the block's
    width, at the heuristic's layout for that width with a ring of 1 to 3
    ``stages``, and at one sub-tile a CTA with the contraction split over 1,
    2, 4 and 8 CTAs (at most 21)."""
    heur = plan(M, P, R, n_blocks, bn, window, itemsize)
    ke, geom = P + R, (P, R, window, itemsize)
    out = [heur]

    def add(p: Plan | None) -> None:
        if p is not None and p not in out and refusal(p, M, *geom[:2], n_blocks, bn,
                                                      *geom[2:]) is None:
            out.append(p)

    if heur.form == "skinny":
        for rows, tn in SKINNY_SHAPES[itemsize]:
            if rows != heur.rows or bn % tn:
                continue
            widest = min(_pow2_at_least(bn), 256, THREADS * tn)
            for cols in (heur.cols, heur.cols // 2, heur.cols * 2):
                cols = max(tn, min(cols, widest))
                for want in CANDIDATE_SPLITS:
                    add(_resized(heur, *geom, tn=tn, cols=cols, splits=_splits(ke, want)))
        return out
    for tn in TALL_TN:
        if tn > _pow2_at_least(bn):
            continue
        base = _plan_tall(M, P, R, n_blocks, bn, window, itemsize, tn)
        if base is None:
            continue
        for stages in range(1, min(TALL_STAGES, base.subtiles) + 1):
            add(_resized(base, *geom, stages=stages))
        for want in CANDIDATE_SPLITS:
            add(_resized(base, *geom, subtiles=1, stages=1, splits=_splits(ke, want)))
    return out


def _at_block_k(p: Plan, M, P, R, n_blocks, bn, window, itemsize, block_k: int) -> Plan:
    """``p`` with its contraction cut in K-slices of at most ``block_k``
    lanes (the fewest that do), the JAX package's explicit ``block_k``."""
    ke, geom = P + R, (P, R, window, itemsize)
    splits = _splits(ke, -(-ke // block_k)) if ke else 1
    if -(-ke // block_k) > MAX_CLUSTER:
        raise ValueError(f"block_k={block_k} cuts {ke} lanes in more than {MAX_CLUSTER} "
                         "K-slices: no K1 plan takes it")
    if p.form == "skinny":
        q = _resized(p, *geom, splits=splits)
        while q.smem > SMEM_PER_BLOCK and q.cols > q.tn:  # a narrower tile gathers less
            q = _resized(q, *geom, cols=q.cols // 2)
    else:
        q = _resized(p, *geom, splits=splits, **({"subtiles": 1, "stages": 1}
                                                  if splits > 1 else {}))
    why = refusal(q, M, P, R, n_blocks, bn, window, itemsize)
    if why:
        raise ValueError(f"block_k={block_k}: no K1 plan takes it ({why})")
    return q


def cache_key(
    M: int,
    N: int,
    P: int,
    R: int,
    *,
    dtype: str = "",
    dtype_bytes: int = 2,
    pool: str = "none",
    blocks: int = 1,
    residual: bool = False,
) -> str:
    """The key of one K1 problem: the JAX package's ``cache_key`` string for
    the same problem (``N``/``P``/``R`` are a block's in the column-blocked
    form and on the expert grid, ``blocks`` the number of blocks)."""
    K = 2 * P + R
    dt = dtype or f"b{dtype_bytes}"
    suffix = f"-x{blocks}" if blocks > 1 else ""
    if residual:
        suffix += "-res"
    return f"M{M}-N{N}-K{K}-{dt}-p{P}r{R}-{pool}{suffix}"


def launch_key(M: int, P: int, R: int, n_blocks: int, bn: int, pool: str, itemsize: int,
               residual: bool = False) -> str:
    """:func:`cache_key` of one launch of K1."""
    return cache_key(M, bn, P, R, dtype=DTYPE_NAMES[itemsize], dtype_bytes=itemsize, pool=pool,
                     blocks=n_blocks, residual=residual)


_KEY = re.compile(r"^M(\d+)-N(\d+)-K\d+-(float32|bfloat16)-p(\d+)r(\d+)-(none|max2|avg2)"
                  r"(?:-x(\d+))?(-res)?$")


def key_problem(key: str) -> tuple[int, int, int, int, int, str, int, bool]:
    """The launch a :func:`launch_key` names: ``(M, P, R, n_blocks, bn,
    pool, itemsize, residual)``."""
    m = _KEY.match(key)
    if m is None:
        raise ValueError(f"not a K1 launch key: {key!r}")
    M, N, dt, P, R, pool, B, res = m.groups()
    return (int(M), int(P), int(R), int(B or 1), int(N), pool,
            next(i for i, d in DTYPE_NAMES.items() if d == dt), bool(res))


#: The port's cache schema: the JAX package's version 1 holds Pallas tiles
#: (``block_m``, ``block_n``, ``block_k``), which name no K1 plan.
CACHE_VERSION = 2
DEFAULT_CACHE_PATH = Path(".cache") / "tile_cache.json"
PLAN_FIELDS = ("form", "rows", "cols", "tn", "splits", "lanes", "subtiles", "stages")


_UNSET = object()


def _plan_entry(entry) -> bool:
    return (isinstance(entry, dict) and entry.get("form") in ("skinny", "tall")
            and all(type(entry.get(f)) is int for f in PLAN_FIELDS[1:]))


class TileCache:
    """Versioned on-disk map from :func:`cache_key` to a measured K1 plan.

    ``{"version": 2, "entries": {key: {"form": …, "rows": …, "cols": …,
    "tn": …, "splits": …, "lanes": …, "subtiles": …, "stages": …, "smem":
    …, "time_s": …, "source": …}}}``.  A version mismatch, an unreadable
    file or an entry without a plan's fields loads as empty, so a cache the
    JAX package wrote supplies no plan.  A missing file is an empty cache
    (:func:`load_tile_cache` refuses one)."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else DEFAULT_CACHE_PATH
        self.entries: dict[str, dict] = {}
        # launch → its plan, resized and checked once (None: no entry; str:
        # why K1 refuses the entry); put() starts it again
        self._resolved: dict[tuple, Plan | str | None] = {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return
        if isinstance(raw, dict) and raw.get("version") == CACHE_VERSION and isinstance(
                raw.get("entries"), dict):
            self.entries = {k: v for k, v in raw["entries"].items() if _plan_entry(v)}

    def get(self, key: str) -> Plan | None:
        """The cached plan of ``key`` (its ``smem`` as stored)."""
        e = self.entries.get(key)
        if e is None:
            return None
        return Plan(**{f: e[f] for f in PLAN_FIELDS}, smem=int(e.get("smem", 0)))

    def put(self, key: str, plan: Plan, *, time_s: float | None = None,
            source: str = "measured") -> None:
        entry = dict(dataclasses.asdict(plan), source=source)
        if time_s is not None:
            entry["time_s"] = time_s
        self.entries[key] = entry
        self._resolved.clear()

    def plan_for(self, M: int, P: int, R: int, n_blocks: int, bn: int, pool: str,
                 itemsize: int, residual: bool = False) -> Plan | None:
        """The cached plan of one launch, its ``smem`` worked out for the
        launch, or None where the cache holds no entry for it; raises
        ``RuntimeError`` naming the key where K1 would refuse the entry.
        Each launch's entry is resized and checked once."""
        launch = (M, P, R, n_blocks, bn, pool, itemsize, residual)
        hit = self._resolved.get(launch, _UNSET)
        if hit is _UNSET:
            key = launch_key(*launch)
            hit = self.get(key)
            if hit is not None:
                window = POOL_WINDOWS[pool]
                hit = _resized(hit, P, R, window, itemsize)
                why = refusal(hit, M, P, R, n_blocks, bn, window, itemsize)
                if why:
                    hit = (f"the tile cache {self.path} holds a plan for {key} that K1 "
                           f"refuses: {why} ({hit})")
            self._resolved[launch] = hit
        if isinstance(hit, str):
            raise RuntimeError(hit)
        return hit

    def save(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({"version": CACHE_VERSION, "entries": self.entries},
                                        indent=2))
        return self.path

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)


def load_tile_cache(path: str | Path) -> TileCache:
    """The cache at ``path``, which must exist (the CLI's ``--tile-cache``)."""
    if not Path(path).is_file():
        raise FileNotFoundError(f"no tile cache at {path}")
    return TileCache(path)


_state = threading.local()


def active_tile_cache() -> TileCache | None:
    return getattr(_state, "cache", None)


def active_block_k() -> int:
    return getattr(_state, "block_k", 0)


class _Installed:
    """Sets one thread-local field on entry and restores it on exit (so
    installs nest)."""

    def __init__(self, field: str, value):
        self.field, self.value = field, value

    def __enter__(self):
        self._prev = _state.__dict__.get(self.field, _UNSET)
        setattr(_state, self.field, self.value)
        return self.value

    def __exit__(self, *exc) -> None:
        if self._prev is _UNSET:
            delattr(_state, self.field)
        else:
            setattr(_state, self.field, self._prev)


def use_tile_cache(cache: TileCache | str | Path) -> _Installed:
    """Install a :class:`TileCache` (or the one at a path) for this thread's
    K1 launches: their plans come from it where it holds their key."""
    return _Installed("cache", cache if isinstance(cache, TileCache) else TileCache(cache))


def use_block_k(block_k: int) -> _Installed:
    """An explicit K-slice width for this thread's K1 launches (0: none)."""
    return _Installed("block_k", int(block_k))


def resolve_plan(M: int, P: int, R: int, n_blocks: int, bn: int, pool: str, itemsize: int, *,
                 residual: bool = False) -> Plan:
    """The plan of one K1 launch, as the JAX package's ``resolve_blocks``
    picks tiles: an explicit block_k (:func:`use_block_k`) wins, then the
    active cache's plan for the launch's key, then the heuristic
    :func:`plan`.  A block_k no plan takes raises ``ValueError``; a cached
    plan the C entry point would refuse raises ``RuntimeError`` naming its
    key: there is no fallback to the heuristic.  Each answer is worked out
    once (per cache, per block_k) and then looked up."""
    block_k = active_block_k()
    if block_k:
        return _block_k_plan(M, P, R, n_blocks, bn, POOL_WINDOWS[pool], itemsize, block_k)
    cache = active_tile_cache()
    if cache is not None:
        hit = cache.plan_for(M, P, R, n_blocks, bn, pool, itemsize, residual)
        if hit is not None:
            return hit
    return plan(M, P, R, n_blocks, bn, POOL_WINDOWS[pool], itemsize)


@functools.cache
def _block_k_plan(M, P, R, n_blocks, bn, window, itemsize, block_k: int) -> Plan:
    heur = plan(M, P, R, n_blocks, bn, window, itemsize)
    return _at_block_k(heur, M, P, R, n_blocks, bn, window, itemsize, block_k)


def _graph_s(fn, calls: int, replays: int) -> float:
    """Seconds of one ``fn()`` on the card: ``calls`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (calls * replays)


def measure(fn, *, reps: int = 5, warmup: int = 1) -> float:
    """Seconds of one ``fn()``: where it returns a CUDA tensor, the device
    time over CUDA-graph replays (10 calls a graph, ``reps`` replays);
    otherwise the best of ``reps`` host-clock runs after ``warmup``."""
    out = fn()
    if getattr(out, "is_cuda", False):
        return _graph_s(fn, 10, reps)
    for _ in range(warmup - 1):
        fn()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_plans(runner, M: int, P: int, R: int, n_blocks: int, bn: int, pool: str,
                   itemsize: int, *, residual: bool = False, cache: TileCache | None = None,
                   candidates: list[Plan] | None = None, reps: int = 5,
                   warmup: int = 1) -> tuple[Plan, list[dict]]:
    """Measure every candidate plan of one K1 problem and keep the fastest.

    ``runner(plan)`` launches K1 for this problem at ``plan`` and returns
    its output; :func:`measure` times it.  Returns ``(winner, records)``,
    a record per candidate (its fields, ``time_s``, ``heuristic``); with a
    ``cache`` the winner is written through under the problem's key and the
    cache saved."""
    window = POOL_WINDOWS[pool]
    cands = candidates or candidate_plans(M, P, R, n_blocks, bn, window, itemsize)
    heur = plan(M, P, R, n_blocks, bn, window, itemsize)
    records, best, best_t = [], None, math.inf
    for p in cands:
        t = measure(lambda p=p: runner(p), reps=reps, warmup=warmup)
        records.append({**dataclasses.asdict(p), "time_s": t, "heuristic": p == heur})
        if t < best_t:
            best, best_t = p, t
    if best is None:
        raise ValueError("no candidate plans")
    if cache is not None:
        cache.put(launch_key(M, P, R, n_blocks, bn, pool, itemsize, residual), best,
                  time_s=best_t)
        cache.save()
    return best, records

# ---------------------------------------------------------------------------
# K2: fused decode attention
# ---------------------------------------------------------------------------

K2_THREADS = 256
K2_WARPS = K2_THREADS // 32
K2_TILE = 32  # keys a tile
K2_MAX_D = 256
K2_MAX_SLOTS = 4  # slots a cluster: the projection's rows
K2_W_STAGES = (8, 4)  # weight ring slots a thread (16 bytes each), deepest first
K2_SPLIT_BYTES = 32_768  # a pair's split partials (all G heads) a merging rank may hold
K2_CHUNKS = (4096, 2048, 1024, 512, 256)  # lanes a chunk, where a block's do not fit at once
#: the shared-memory regions, in the order of the kernel's ``struct Plan``
K2_REGIONS = ("wring", "kv", "idx", "vec", "xg", "part", "gath", "coef", "qs", "sc", "corr",
              "red")


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """One launch of K2: ``cluster`` CTAs a cluster own ``slots`` slots; each
    KV head's query heads are cut in ``groups`` groups (units of
    ``G / groups`` heads), each (slot, unit) pair's keys in ``splits``
    ranges; fused form: ``cols`` columns a CTA (inside one column block),
    ``tn`` adjacent columns a thread, ``wstages`` weight ring slots a thread,
    the block's lanes gathered ``chunk`` at a time; ``stages`` K/V ring
    slots.  ``layout`` is the kernel's shared memory: the strides (floats of
    an item's partial, bytes of a K/V row, floats of a query row), then the
    byte offset of each region of :data:`K2_REGIONS`; ``smem`` their end.
    The kernel follows this layout and has none of its own."""

    cluster: int
    slots: int
    splits: int
    groups: int
    cols: int
    tn: int
    stages: int
    wstages: int
    chunk: int
    layout: tuple[int, ...]
    smem: int

    def items(self, KH: int) -> int:
        """Work items a rank: ``ceil(slots · KH · groups · splits / cluster)``."""
        return -(-self.slots * KH * self.groups * self.splits // self.cluster)

    def grid(self, B: int, n_blocks: int, bn: int, proj: bool) -> tuple[int, int]:
        """(x, y) CTAs of the launch: x the clusters' ranks (fused: one
        column tile each, whole clusters), y the slot groups."""
        tiles = n_blocks * -(-bn // self.cols) if proj else self.cluster
        return -(-tiles // self.cluster) * self.cluster, -(-B // self.slots)

    def as_args(self) -> tuple[int, ...]:
        """The C entry point's plan (its ``struct Plan``, in order)."""
        return (self.cluster, self.slots, self.splits, self.groups, self.cols, self.tn,
                self.stages, self.wstages, self.chunk, *self.layout, self.smem)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def k2_layout(H, KH, D, itemsize, proj, cluster, slots, splits, groups, cols, stages, wstages,
              chunk) -> tuple[tuple[int, ...], int]:
    """K2's shared memory for a plan: ``(isz, row_bytes, dq, *offsets)`` and
    the total bytes (see :class:`K2Plan`)."""
    gc = H // KH // groups
    items = -(-slots * KH * groups * splits // cluster)
    pairs = -(-slots * KH * groups // cluster)  # (slot, unit) pairs a rank merges
    isz = (gc * (D + 2) + 3) // 4 * 4  # floats of one item's partial
    row_bytes = _align16(D * itemsize) + 16  # a K/V row, padded off the next one's banks
    dq = (D + 3) // 4 * 4
    sizes = {
        "wring": wstages * K2_THREADS * 16 if proj else 0,
        "kv": stages * 2 * K2_TILE * row_bytes,
        "idx": 2 * chunk * 4 if proj else 0,  # the chunk's I or R lanes, then its J lanes
        "vec": slots * H * D * itemsize if proj else 0,  # attended vectors, the I/O dtype
        "xg": chunk * K2_MAX_SLOTS * 4 if proj else 0,  # the chunk's gathered lanes
        "part": items * isz * 4,  # partial (acc, m, l) of the items
        "gath": pairs * splits * isz * 4 if splits > 1 else 0,  # the splits pushed for merging
        "coef": pairs * (splits + 1) * gc * 4,  # merge weights
        "qs": gc * dq * 4,  # queries
        "sc": K2_WARPS * gc * K2_TILE * 4,  # the warps' partial dots, then p
        "corr": gc * 4,
        "red": K2_WARPS * slots * cols * 4 if proj else 0,  # projection partials
    }
    # the attended vectors and the gathered lanes are written after every
    # rank's attention is done: they reuse the K/V ring where it holds them
    in_ring = _align16(sizes["vec"]) + sizes["xg"] <= sizes["kv"]
    offsets, o = {}, 0
    for name in K2_REGIONS:
        if in_ring and name in ("vec", "xg"):
            offsets[name] = offsets["kv"] + (0 if name == "vec" else _align16(sizes["vec"]))
            continue
        offsets[name] = o
        o += _align16(sizes[name])
    return (isz, row_bytes, dq, *(offsets[n] for n in K2_REGIONS)), o


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@functools.cache
def k2_plan(B: int, S: int, H: int, KH: int, D: int, n_cols: int, bn: int, P: int, R: int,
            itemsize: int) -> K2Plan:
    """The launch plan of one K2 call: ``B`` slots, a cache of ``S`` keys,
    ``H`` query and ``KH`` KV heads of ``D``; ``n_cols`` output columns in
    blocks of ``bn`` with ``P`` pair and ``R`` residual lanes a block, or
    ``n_cols == 0`` for the bare form; element size 4 (fp32) or 2 (bf16).

    Both forms cut each (slot, unit) pair's keys in ``splits`` ranges, as
    many as a cluster of 8 has ranks for the KV heads of ``min(B, 4)`` slots
    (and the cache has 32-key tiles), fewer where a pair's split partials
    would outgrow :data:`K2_SPLIT_BYTES`: a function of (B, S, H, KH, D)
    alone, so a fused launch attends exactly as a bare one does.  Fused: the
    narrowest column tile (at least ``tn`` columns, at most 32 threads
    across it) that keeps the grid within one CTA an SM, a cluster of up to
    8 of those tiles, all slots (up to 4) in one cluster, so each segment is
    read once a launch.  Bare: a cluster per slot, a rank per (unit, key
    range).  Then the first layout that fits 227 KB, trying in turn fewer
    slots a cluster, more head groups, a 3- then 2-stage K/V ring, an 8- then
    4-deep weight ring and the block's lanes whole, then in chunks."""
    if itemsize not in (2, 4) or H < 1 or KH < 1 or H % KH or not 1 <= D <= K2_MAX_D \
            or B < 1 or S < 1:
        raise ValueError(f"no K2 plan for B={B}, S={S}, H={H}, KH={KH}, D={D}, "
                         f"itemsize={itemsize}")
    proj = n_cols > 0
    G = H // KH
    key_tiles = -(-S // K2_TILE)
    splits = max(1, min(MAX_CLUSTER // (min(B, K2_MAX_SLOTS) * KH), key_tiles))
    while splits > 1 and splits * G * (D + 2) * 4 > K2_SPLIT_BYTES:
        splits -= 1
    if proj:
        if bn < 1 or P < 0 or R < 0:
            raise ValueError(f"no K2 plan for n_cols={n_cols}, bn={bn}, P={P}, R={R}")
        vec = 16 // itemsize
        tn = vec if bn % vec == 0 else 1
        n_blocks = -(-n_cols // bn)
        cols, widest = tn, min(32 * tn, _pow2_at_least(bn))
        while cols < widest and n_blocks * -(-bn // cols) > SMS:
            cols *= 2
        tile_cluster = min(MAX_CLUSTER, n_blocks * -(-bn // cols))
        lanes = max(P + R, 1)
        chunks = (lanes, *(c for c in K2_CHUNKS if c < lanes))
        wrings = K2_W_STAGES
    else:
        tn = cols = 1
        chunks, wrings = (0,), K2_W_STAGES[:1]
    slots = min(B, K2_MAX_SLOTS) if proj else 1
    while True:
        for groups in _divisors(G):
            # fused: a cluster of the column tiles, or of 8 where the
            # attention needs more ranks (the extra ones own no tile)
            first = tile_cluster if proj else min(MAX_CLUSTER, KH * groups * splits)
            for cluster in dict.fromkeys((first, MAX_CLUSTER) if proj else (first,)):
                for stages, wstages, chunk in itertools.product((3, 2), wrings, chunks):
                    layout, smem = k2_layout(H, KH, D, itemsize, proj, cluster, slots, splits,
                                             groups, cols, stages, wstages, chunk)
                    if smem <= SMEM_PER_BLOCK:
                        return K2Plan(cluster, slots, splits, groups, cols, tn, stages,
                                      wstages, chunk, layout, smem)
        if slots == 1:
            raise ValueError(f"no K2 plan fits: B={B}, S={S}, H={H}, KH={KH}, D={D}, "
                             f"n_cols={n_cols}, bn={bn}, P={P}, R={R}, itemsize={itemsize}")
        slots //= 2
