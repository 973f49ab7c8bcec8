"""Launch plans for the paired GEMM kernel (K1) and the fused decode
attention (K2) on an H100.

The port's counterpart of the block choice in ``repro.kernels.tuning``
(``choose_blocks``), redone for this card: 132 SMs, 227 KB of shared memory
per block, thread-block clusters of at most 8 CTAs (the portable size).
:func:`plan` is a pure function of the launch's shape; the wrapper passes
its result to the C entry point, which checks it and refuses a plan out of
range.  There is no autotuning and no tile cache.

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
import math

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


def _plan_tall(M, P, R, n_blocks, bn, window, itemsize) -> Plan | None:
    ke, K = P + R, 2 * P + R
    tn = 1 if bn == 1 else 4 if bn <= 4 else 8
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
