"""Weight pairing — the paper's preprocessing stage (§III.A, Algorithm 1).

A numpy copy of ``repro.core.pairing`` (the JAX package's pairing module),
kept here so that the PyTorch port imports nothing from the JAX package.
Every function returns the same metadata as its counterpart, index for
index, on the same float64 inputs; ``tests/test_torch_pairing.py`` holds
the two against each other.

The paper's idea: within one convolution filter (one output channel / output
neuron), two weights K_a > 0 and K_b < 0 with |K_a| ≈ |K_b| can be merged:

    I1*K_a + I2*K_b  =  K_a * (I1 - I2)        when K_a = -K_b          (1)

so one multiply + one add is replaced by one subtract (+ the multiply that
remains).  "≈" is controlled by a *rounding size* r: the pair is combined when
| |K_a| - |K_b| | < r, and both are snapped to the common magnitude
k = (|K_a| + |K_b|) / 2.  Accuracy degrades as r grows; power/area of the
ASIC MAC array shrink (see cost_model.py).

Four implementations live here:

1. ``pair_list_twopointer``  — a direct, line-by-line transcription of the
   paper's Algorithm 1 over one weight list (one filter).  Used as the oracle.
2. ``pair_columns``          — the same greedy two-pointer, vectorised across
   all output neurons of a weight matrix at once (lock-step pointer arrays).
3. ``pair_rows_structured``  — the *structured* variant: one pairing of input
   channels shared by every output neuron, so the paired computation stays a
   dense GEMM with a reduced contraction dimension (see
   kernels/paired_matmul.py).  The per-column magnitude is kept exact; only
   the symmetric part of the paired rows is dropped, bounded by r.
4. ``pair_rows_blocked``     — the spectrum between (2) and (3): one shared-row
   pairing per group of ``block_n`` output neurons.  ``block_n == N`` is
   exactly (3); ``block_n == 1`` reproduces the paper's per-column pairing
   (2) index-for-index.

All pairing is offline preprocessing (runs once, numpy), exactly as in the
paper ("the weights preprocessing occurs once before deploying the weights").
Section 5 constrains the pairing to tensor-parallel shards: no pair spans two
row slabs of a contraction-sharded weight (:func:`pair_rows_structured_sharded`,
:func:`pair_rows_blocked_sharded`, :func:`concat_structured`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# 1. Faithful Algorithm 1 (single list — one filter / one output neuron)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PairingResult:
    """Pairing of a single weight list (indices into the original list)."""

    pair_pos: np.ndarray  # (P,) int — index of the positive member
    pair_neg: np.ndarray  # (P,) int — index of the negative member
    pair_mag: np.ndarray  # (P,) float — common magnitude k = (|a|+|b|)/2
    uncombined: np.ndarray  # (U,) int — indices left untouched

    @property
    def n_pairs(self) -> int:
        return int(self.pair_pos.shape[0])


def pair_list_twopointer(w: np.ndarray, rounding: float) -> PairingResult:
    """Algorithm 1 of the paper, verbatim, on one weight list.

    Sorts positives ascending and negatives by magnitude ascending, then walks
    both lists with two pointers; combines when the magnitudes are within
    ``rounding`` of each other, otherwise retires the pointer whose remaining
    candidates can no longer match.
    """
    w = np.asarray(w).reshape(-1)
    pos_idx = np.nonzero(w > 0)[0]
    neg_idx = np.nonzero(w < 0)[0]
    # Sort ascending by magnitude (paper sorts ascending, splits by sign).
    pos_idx = pos_idx[np.argsort(w[pos_idx], kind="stable")]
    neg_idx = neg_idx[np.argsort(-w[neg_idx], kind="stable")]  # |neg| ascending

    pp, pn = 0, 0
    pair_pos, pair_neg, pair_mag = [], [], []
    un: list[int] = []
    while pp < len(pos_idx) and pn < len(neg_idx):
        p = w[pos_idx[pp]]
        m = -w[neg_idx[pn]]
        if p >= m + rounding:  # negative too small — will never match later p
            un.append(int(neg_idx[pn]))
            pn += 1
        elif p <= m - rounding:  # positive too small
            un.append(int(pos_idx[pp]))
            pp += 1
        else:  # combine
            pair_pos.append(int(pos_idx[pp]))
            pair_neg.append(int(neg_idx[pn]))
            pair_mag.append((p + m) / 2.0)
            pp += 1
            pn += 1
    un.extend(int(i) for i in pos_idx[pp:])
    un.extend(int(i) for i in neg_idx[pn:])
    un.extend(int(i) for i in np.nonzero(w == 0)[0])  # zeros never pair
    return PairingResult(
        pair_pos=np.asarray(pair_pos, dtype=np.int64),
        pair_neg=np.asarray(pair_neg, dtype=np.int64),
        pair_mag=np.asarray(pair_mag, dtype=np.float64),
        uncombined=np.asarray(sorted(un), dtype=np.int64),
    )


# ---------------------------------------------------------------------------
# 2. Vectorised per-column pairing (lock-step two-pointer across N columns)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnPairing:
    """Pairing of a (K, N) weight matrix, independently per column.

    ``pair_pos/pair_neg/pair_mag`` are (Pmax, N) arrays padded with -1 / 0;
    ``n_pairs`` is (N,) — the number of valid pairs per column.
    """

    pair_pos: np.ndarray
    pair_neg: np.ndarray
    pair_mag: np.ndarray
    n_pairs: np.ndarray
    shape: tuple[int, int]

    @property
    def total_pairs(self) -> int:
        return int(self.n_pairs.sum())


def pair_columns(W: np.ndarray, rounding: float) -> ColumnPairing:
    """Per-column Algorithm 1, vectorised across columns.

    Semantics are identical to running ``pair_list_twopointer`` on each
    column of ``W`` (tested against it); implementation runs all columns in
    lock-step so that the python loop is O(K) regardless of N.
    """
    W = np.asarray(W)
    assert W.ndim == 2, "pair_columns expects (K, N)"
    return _walk_columns(W, rounding)


def _walk_columns(W: np.ndarray, rounding: float,
                  neg_order: np.ndarray | None = None) -> ColumnPairing:
    """Algorithm 1 on every column of ``W`` in lock-step; ``neg_order``
    lists each column's rows with its negatives by |.| ascending (the order
    the walk meets them, ties included), by default the ascending sort read
    backwards, so tied negatives come last row first."""
    K, N = W.shape

    # --- per-column sorted positive values and |negative| values -----------
    # We sort the columns once; positives ascending, negatives by |.| asc.
    # Positions are padded to the max count with +inf sentinels.
    pos_mask = W > 0
    neg_mask = W < 0
    n_pos = pos_mask.sum(axis=0)  # (N,)
    n_neg = neg_mask.sum(axis=0)
    Pmaxp, Pmaxn = int(n_pos.max(initial=0)), int(n_neg.max(initial=0))

    INF = np.inf
    pos_vals = np.full((Pmaxp, N), INF)
    pos_rows = np.full((Pmaxp, N), -1, dtype=np.int64)
    neg_vals = np.full((Pmaxn, N), INF)
    neg_rows = np.full((Pmaxn, N), -1, dtype=np.int64)

    # argsort the full columns, then compact the signed entries to the top.
    order = np.argsort(W, axis=0, kind="stable")  # ascending values
    Ws = np.take_along_axis(W, order, axis=0)
    # positives: ascending slice of sorted column (they are at the bottom end)
    # Build scatter indices vectorised:
    col_ids = np.broadcast_to(np.arange(N), (K, N))
    is_pos = Ws > 0
    # rank of each positive within its column (0-based, ascending value)
    rank_pos = np.cumsum(is_pos, axis=0) - 1
    sel = is_pos
    pos_vals[rank_pos[sel], col_ids[sel]] = Ws[sel]
    pos_rows[rank_pos[sel], col_ids[sel]] = order[sel]
    # negatives: |.| ascending
    order_desc = order[::-1] if neg_order is None else neg_order
    desc = np.take_along_axis(W, order_desc, axis=0)
    is_neg_d = desc < 0
    rank_neg = np.cumsum(is_neg_d, axis=0) - 1
    seln = is_neg_d
    neg_vals[rank_neg[seln], col_ids[seln]] = -desc[seln]  # store magnitude
    neg_rows[rank_neg[seln], col_ids[seln]] = order_desc[seln]

    # --- lock-step two-pointer walk ----------------------------------------
    Pmax = min(Pmaxp, Pmaxn)
    pair_pos = np.full((max(Pmax, 1), N), -1, dtype=np.int64)
    pair_neg = np.full((max(Pmax, 1), N), -1, dtype=np.int64)
    pair_mag = np.zeros((max(Pmax, 1), N))
    n_pairs = np.zeros(N, dtype=np.int64)

    pp = np.zeros(N, dtype=np.int64)
    pn = np.zeros(N, dtype=np.int64)
    cols = np.arange(N)
    # Each iteration advances every active column's pointer by >= 1, so the
    # loop runs at most Pmaxp + Pmaxn times in total.
    for _ in range(Pmaxp + Pmaxn):
        active = (pp < n_pos) & (pn < n_neg)
        if not active.any():
            break
        p = pos_vals[np.minimum(pp, Pmaxp - 1), cols]
        m = neg_vals[np.minimum(pn, Pmaxn - 1), cols]
        neg_small = active & (p >= m + rounding)
        pos_small = active & (p <= m - rounding)
        combine = active & ~neg_small & ~pos_small
        if combine.any():
            c = cols[combine]
            r = n_pairs[combine]
            pair_pos[r, c] = pos_rows[pp[combine], c]
            pair_neg[r, c] = neg_rows[pn[combine], c]
            pair_mag[r, c] = (p[combine] + m[combine]) / 2.0
            n_pairs[combine] += 1
        pn[neg_small | combine] += 1
        pp[pos_small | combine] += 1

    used = int(n_pairs.max(initial=0))
    return ColumnPairing(
        pair_pos=pair_pos[: max(used, 1)],
        pair_neg=pair_neg[: max(used, 1)],
        pair_mag=pair_mag[: max(used, 1)],
        n_pairs=n_pairs,
        shape=(K, N),
    )


def fold_columns(W: np.ndarray, cp: ColumnPairing) -> np.ndarray:
    """Materialise the *paired-equivalent* weight matrix W'.

    W' is the matrix that a plain dense matmul must use to produce bit-wise
    the same result as the subtractor dataflow: each combined pair (a, b) of
    column n is snapped to (+k, -k) with k = (|W[a,n]| + |W[b,n]|)/2.
    This is how accuracy of the technique is evaluated (the arithmetic
    rewrite (1) is exact once the weights are snapped).
    """
    Wf = np.array(W, copy=True)
    P, N = cp.pair_pos.shape
    valid = cp.pair_pos >= 0
    cols = np.broadcast_to(np.arange(N), (P, N))
    Wf[cp.pair_pos[valid], cols[valid]] = cp.pair_mag[valid]
    Wf[cp.pair_neg[valid], cols[valid]] = -cp.pair_mag[valid]
    return Wf


# ---------------------------------------------------------------------------
# 3. Structured pairing: shared (i, j) pairs across columns
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StructuredPairing:
    """One pairing of *rows* (input channels) shared by all N columns.

    The paired matmul computes::

        y = (x[:, I] - x[:, J]) @ Kmat + x[:, R] @ W_res

    which is exactly ``x @ W_approx`` with W_approx[I] = +Kmat,
    W_approx[J] = -Kmat, W_approx[R] = W_res.  The contraction length drops
    from K to P + (K - 2P): every pair saves one multiply-accumulate lane,
    the GEMM analogue of the paper's mult+add → sub replacement.

    I, J: (P,) int row indices; Kmat: (P, N); resid: (R,) int; W_res: (R, N).
    """

    I: np.ndarray
    J: np.ndarray
    Kmat: np.ndarray
    resid: np.ndarray
    W_res: np.ndarray
    shape: tuple[int, int]

    @property
    def n_pairs(self) -> int:
        return int(self.I.shape[0])

    @property
    def weighted_pairs(self) -> int:
        """Per-column-equivalent pair count: every shared pair removes one
        contraction lane for each of the N columns it spans (the quantity
        Table I compares across pairing modes)."""
        return self.n_pairs * int(self.shape[1])

    def fold(self) -> np.ndarray:
        """Dense W_approx equivalent (for accuracy eval / oracle)."""
        K, N = self.shape
        Wf = np.zeros((K, N), dtype=self.Kmat.dtype)
        Wf[self.I] = self.Kmat
        Wf[self.J] = -self.Kmat
        Wf[self.resid] = self.W_res
        return Wf

    def perm(self) -> np.ndarray:
        """Row permutation [I | J | resid] used by the paired GEMM kernel."""
        return np.concatenate([self.I, self.J, self.resid])


def pair_rows_structured(
    W: np.ndarray,
    rounding: float,
    *,
    criterion: str = "rms",
    magnitudes: bool = True,
) -> StructuredPairing:
    """Find one row pairing shared by every column of W (K, N).

    Greedy two-pointer on the per-row mean weight (the same sort-and-walk
    shape as Algorithm 1, lifted from scalars to row profiles), validated by
    the chosen norm of the *symmetric part* s = (W[i] + W[j]) / 2:

        criterion == "rms":  pair iff  rms(W[i] + W[j]) < rounding
        criterion == "max":  pair iff  max|W[i] + W[j]| < rounding

    For a combined pair the per-column magnitude k_n = (W[i,n] - W[j,n]) / 2
    is kept *exactly*; only s (bounded by `rounding`) is dropped.  Columns
    therefore keep individual magnitudes — only the pair structure is shared,
    which is what lets the computation stay a dense GEMM.

    ``magnitudes=False`` leaves ``Kmat`` and ``W_res`` empty (0, N): the
    lane lists alone, for callers that recompute the magnitudes from live
    weights (``core.transform.pair_params``), without the two gathers of W.
    """
    W = np.asarray(W, dtype=np.float64)
    K, N = W.shape
    mean = W.mean(axis=1)
    pos_idx = np.nonzero(mean > 0)[0]
    # Exactly-zero mean rows never pair (Algorithm 1 skips zero weights);
    # retiring them here also makes the N == 1 case degenerate *exactly* to
    # ``pair_list_twopointer``, which ``pair_rows_blocked(block_n=1)`` relies
    # on to reproduce the paper's per-column ledger.
    neg_idx = np.nonzero(mean < 0)[0]
    zero_idx = np.nonzero(mean == 0)[0]
    pos_idx = pos_idx[np.argsort(mean[pos_idx], kind="stable")]
    neg_idx = neg_idx[np.argsort(-mean[neg_idx], kind="stable")]

    if criterion not in ("rms", "max"):  # pragma: no cover
        raise ValueError(f"unknown criterion {criterion!r}")

    # The walk on Python floats (the same doubles): a step whose means are
    # too far apart retires a row at once.  Where they are near, the walk
    # combines while it can, both pointers stepping along a diagonal
    # (pos_idx[pp + t], neg_idx[pn + t]): a run of those pairs is judged in
    # one batch, with the one-pair comparisons and symmetric-error formula
    # row by row, and the batch doubles while runs go through (capped at
    # 2^16 weights of W).  A run ends at a pair whose means are not near (the
    # next step retires it) or whose profiles do not cancel.
    pos, neg = pos_idx.tolist(), neg_idx.tolist()
    p_mean, m_mean = mean[pos_idx], -mean[neg_idx]  # the walk's p and m
    p_list, m_list = p_mean.tolist(), m_mean.tolist()
    n_p, n_n = len(pos), len(neg)
    row_cap = max(1, (1 << 16) // max(N, 1))
    pp, pn, size = 0, 0, 1
    I_runs, J_runs = [], []
    resid: list[int] = []
    while pp < n_p and pn < n_n:
        p, m = p_list[pp], m_list[pn]
        if p >= m + rounding:
            resid.append(neg[pn])
            pn += 1
            continue
        if p <= m - rounding:
            resid.append(pos[pp])
            pp += 1
            continue
        size = min(size, row_cap, n_p - pp, n_n - pn)
        pv, mv = p_mean[pp:pp + size], m_mean[pn:pn + size]
        near = ~(pv >= mv + rounding) & ~(pv <= mv - rounding)
        run = size if near.all() else int(np.argmin(near))  # ≥ 1: this pair is near
        s = W[pos_idx[pp:pp + run]] + W[neg_idx[pn:pn + run]]
        err = (np.sqrt(np.mean(s * s, axis=1)) if criterion == "rms"
               else np.max(np.abs(s), axis=1))
        ok = err < rounding
        cancels = bool(ok.all())
        run = run if cancels else int(np.argmin(ok))
        I_runs.append(pos_idx[pp:pp + run])
        J_runs.append(neg_idx[pn:pn + run])
        pp, pn = pp + run, pn + run
        size = size * 2 if run == size else max(1, size // 2)
        if not cancels:
            # profiles don't cancel even though means do — retire the one
            # with the smaller mean magnitude (it has fewer future partners)
            if p_list[pp] <= m_list[pn]:
                resid.append(pos[pp])
                pp += 1
            else:
                resid.append(neg[pn])
                pn += 1
    resid.extend(pos[pp:])
    resid.extend(neg[pn:])
    resid.extend(zero_idx.tolist())

    I = np.concatenate(I_runs) if I_runs else []
    J = np.concatenate(J_runs) if J_runs else []
    I_a = np.asarray(I, dtype=np.int64)
    J_a = np.asarray(J, dtype=np.int64)
    R_a = np.asarray(sorted(resid), dtype=np.int64)
    if not magnitudes:
        empty = np.zeros((0, N))
        return StructuredPairing(I=I_a, J=J_a, Kmat=empty, resid=R_a, W_res=empty, shape=(K, N))
    Kmat = (W[I_a] - W[J_a]) / 2.0 if len(I) else np.zeros((0, N))
    return StructuredPairing(
        I=I_a, J=J_a, Kmat=Kmat, resid=R_a, W_res=W[R_a], shape=(K, N)
    )


# ---------------------------------------------------------------------------
# 4. Column-blocked pairing: one shared-row pairing per group of block_n cols
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockedPairing:
    """Independent :class:`StructuredPairing` per contiguous block of columns.

    ``blocks[b]`` pairs columns ``[b·block_n, min((b+1)·block_n, N))`` of the
    (K, N) weight matrix; only the *last* block may span fewer than
    ``block_n`` columns.  ``block_n == N`` collapses to a single structured
    pairing; ``block_n == 1`` is the paper's per-column pairing
    (one Algorithm-1 walk per output neuron).

    The kernel consumes the *packed* layout built by :meth:`index_arrays`:
    every block's ``[I | J | resid]`` lane lists padded to the common
    ``(Pmax, Rmax)`` so one ``(n_blocks, 2·Pmax + Rmax)`` index matrix (and
    one gather) covers all blocks — padded lanes point at row 0 and carry
    zero weights, so they contribute nothing to the contraction.
    """

    blocks: list[StructuredPairing]
    block_n: int
    shape: tuple[int, int]

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_pairs(self) -> int:
        """Subtractions the kernel executes per output position: each block
        computes its own x[I]−x[J] differences, shared by its columns."""
        return sum(sp.n_pairs for sp in self.blocks)

    @property
    def weighted_pairs(self) -> int:
        """Per-column-equivalent pairs (GEMM lanes saved per output position):
        a pair in a block of n_b columns removes one lane from each."""
        return sum(sp.n_pairs * sp.shape[1] for sp in self.blocks)

    @property
    def Pmax(self) -> int:
        return max((sp.n_pairs for sp in self.blocks), default=0)

    @property
    def Rmax(self) -> int:
        return max((len(sp.resid) for sp in self.blocks), default=0)

    def block_cols(self, b: int) -> tuple[int, int]:
        """[start, stop) column range of block ``b``."""
        start = b * self.block_n
        return start, min(start + self.block_n, self.shape[1])

    def fold(self) -> np.ndarray:
        """Dense W_approx equivalent (accuracy eval / kernel oracle)."""
        K, N = self.shape
        Wf = np.zeros((K, N))
        for b, sp in enumerate(self.blocks):
            lo, hi = self.block_cols(b)
            Wf[:, lo:hi] = sp.fold()
        return Wf

    def index_arrays(self) -> dict[str, np.ndarray]:
        """Packed per-block lane metadata for the column-blocked kernel.

        Returns int64 / float64 arrays:

        * ``I``, ``J`` — (n_blocks, Pmax) paired row indices, padded with 0;
        * ``resid``    — (n_blocks, Rmax) residual row indices, padded with 0;
        * ``pair_mask`` / ``resid_mask`` — (n_blocks, Pmax/Rmax) 1.0 on real
          entries, 0.0 on padding (multiplied into the packed weight
          segments, so padded lanes contract against zeros);
        * ``perm``     — (n_blocks, 2·Pmax + Rmax) = [I | J | resid] per
          block: the packed lane-permutation matrix one activation gather
          consumes.
        """
        B, P, R = self.n_blocks, self.Pmax, self.Rmax
        I_m = np.zeros((B, P), dtype=np.int64)
        J_m = np.zeros((B, P), dtype=np.int64)
        R_m = np.zeros((B, R), dtype=np.int64)
        pmask = np.zeros((B, P))
        rmask = np.zeros((B, R))
        for b, sp in enumerate(self.blocks):
            p, r = sp.n_pairs, len(sp.resid)
            I_m[b, :p] = sp.I
            J_m[b, :p] = sp.J
            R_m[b, :r] = sp.resid
            pmask[b, :p] = 1.0
            rmask[b, :r] = 1.0
        return {
            "I": I_m,
            "J": J_m,
            "resid": R_m,
            "pair_mask": pmask,
            "resid_mask": rmask,
            "perm": np.concatenate([I_m, J_m, R_m], axis=1),
        }

    def packed_weights(self) -> tuple[np.ndarray, np.ndarray]:
        """Offline (Kmat, W_res) in the kernel's packed block-major layout.

        ``Kmat`` is (n_blocks, Pmax, block_n) and ``W_res`` is
        (n_blocks, Rmax, block_n); padded rows *and* the short last block's
        padded columns are zero.  The live-weight analogue (differentiable,
        recomputed inside the trace) lives in ``kernels.paired_conv``.
        """
        B, P, R, bn = self.n_blocks, self.Pmax, self.Rmax, self.block_n
        km = np.zeros((B, max(P, 0), bn))
        wr = np.zeros((B, max(R, 0), bn))
        for b, sp in enumerate(self.blocks):
            lo, hi = self.block_cols(b)
            ncols = hi - lo
            km[b, : sp.n_pairs, :ncols] = sp.Kmat
            wr[b, : len(sp.resid), :ncols] = sp.W_res
        return km, wr


def pair_rows_blocked(
    W: np.ndarray,
    rounding: float,
    block_n: int,
    *,
    criterion: str = "rms",
    magnitudes: bool = True,
) -> BlockedPairing:
    """One structured (shared-row) pairing per group of ``block_n`` columns.

    The spectrum knob between the kernel-native structured pairing and the
    paper's per-column pairing:

    * ``block_n >= N`` — a single block: identical to
      :func:`pair_rows_structured` (same I/J/resid).
    * ``block_n == 1`` — one block per column: identical pair indices and
      magnitudes to :func:`pair_columns` / Algorithm 1 (the greedy walk on a
      one-column mean profile *is* Algorithm 1, and the symmetric-error check
      coincides with the rounding window).

    Smaller blocks weaken the shared-row constraint, so the weighted pair
    count is (weakly) monotone as ``block_n`` shrinks on real weights.
    ``magnitudes`` as :func:`pair_rows_structured`'s.
    """
    W = np.asarray(W, dtype=np.float64)
    assert W.ndim == 2, "pair_rows_blocked expects (K, N)"
    K, N = W.shape
    assert block_n >= 1, f"block_n must be >= 1, got {block_n}"
    block_n = min(block_n, N)
    if block_n == 1 and N > 1:
        return BlockedPairing(blocks=_per_column_blocks(W, rounding, magnitudes), block_n=1,
                              shape=(K, N))
    blocks = [
        pair_rows_structured(W[:, lo : min(lo + block_n, N)], rounding,
                             criterion=criterion, magnitudes=magnitudes)
        for lo in range(0, N, block_n)
    ]
    return BlockedPairing(blocks=blocks, block_n=block_n, shape=(K, N))


def _per_column_blocks(W: np.ndarray, rounding: float, magnitudes: bool
                       ) -> list[StructuredPairing]:
    """``pair_rows_structured`` of each column of ``W`` alone, from one
    lock-step walk over all columns: on one column the structured walk is
    Algorithm 1 (its symmetric-error check is the rounding window), with
    tied rows met in ascending row order, the order of its stable sorts."""
    K, N = W.shape
    cp = _walk_columns(W, rounding, np.argsort(-W, axis=0, kind="stable"))
    used = np.zeros((K, N), bool)
    blocks = []
    for c in range(N):
        n = int(cp.n_pairs[c])
        I, J = cp.pair_pos[:n, c].copy(), cp.pair_neg[:n, c].copy()
        used[I, c] = used[J, c] = True
        resid = np.flatnonzero(~used[:, c])
        if magnitudes:
            Kmat, W_res = ((W[I, c] - W[J, c]) / 2.0)[:, None], W[resid, c][:, None]
        else:
            Kmat = W_res = np.zeros((0, 1))
        blocks.append(StructuredPairing(I=I, J=J, Kmat=Kmat, resid=resid, W_res=W_res,
                                        shape=(K, 1)))
    return blocks


# ---------------------------------------------------------------------------
# 5. Shard-constrained pairing: rows never pair across a TP shard boundary
# ---------------------------------------------------------------------------


def concat_structured(parts: list[StructuredPairing], offsets: list[int],
                      shape: tuple[int, int]) -> StructuredPairing:
    """Per-row-shard pairings concatenated into one pairing of the full
    (K, N) matrix: ``parts[s]`` pairs rows ``[offsets[s], offsets[s] +
    parts[s].shape[0])``, its indices rebased to global rows.  Each part's
    residual list is sorted and the offsets increase, so the result's stays
    sorted, and slicing it at the shard boundaries gives back each part."""
    N = shape[1]
    cat = lambda key: (np.concatenate([getattr(p, key) + o for p, o in zip(parts, offsets)])
                       if parts else np.zeros(0, np.int64)).astype(np.int64)
    stack = lambda key: (np.concatenate([getattr(p, key) for p in parts], axis=0)
                         if parts else np.zeros((0, N)))
    return StructuredPairing(I=cat("I"), J=cat("J"), Kmat=stack("Kmat"), resid=cat("resid"),
                             W_res=stack("W_res"), shape=shape)


def pair_rows_structured_sharded(
    W: np.ndarray,
    rounding: float,
    *,
    criterion: str = "rms",
    row_shards: int = 1,
    magnitudes: bool = True,
) -> StructuredPairing:
    """:func:`pair_rows_structured` constrained to ``row_shards`` row slabs.

    A contraction-sharded weight (the attention out-projection, the MLP
    down-projection) gives each rank a contiguous slab of rows, and a pair
    whose rows live on two ranks would need its subtrahend sent every step.
    Each slab is paired on its own (what the rank would build from its
    shard) and the indices rebased, so slicing the result at the slab
    boundaries reproduces the standalone pairings bit for bit.
    ``row_shards`` that do not divide K fall back to the unsharded pairing,
    the degradation ``parallel.sharding`` applies to the weight.
    """
    W = np.asarray(W, dtype=np.float64)
    K, _ = W.shape
    if row_shards <= 1 or K % row_shards:
        return pair_rows_structured(W, rounding, criterion=criterion, magnitudes=magnitudes)
    step = K // row_shards
    offsets = [s * step for s in range(row_shards)]
    parts = [pair_rows_structured(W[o:o + step], rounding, criterion=criterion,
                                  magnitudes=magnitudes) for o in offsets]
    return concat_structured(parts, offsets, shape=W.shape)


def pair_rows_blocked_sharded(
    W: np.ndarray,
    rounding: float,
    block_n: int,
    *,
    criterion: str = "rms",
    row_shards: int = 1,
    magnitudes: bool = True,
) -> BlockedPairing:
    """:func:`pair_rows_blocked` with every block's rows shard-constrained.

    Column sharding needs no constraint: blocks are column-local, so a
    column split on block boundaries partitions the block list, each
    shard's blocks what it would build from its local columns.  Block ``b``
    here is :func:`pair_rows_structured_sharded` of its columns; it is built
    as each row slab's :func:`pair_rows_blocked` (the per-column walk at
    ``block_n == 1``), block by block concatenated: the same pairings.
    """
    W = np.asarray(W, dtype=np.float64)
    assert W.ndim == 2, "pair_rows_blocked_sharded expects (K, N)"
    K, N = W.shape
    assert block_n >= 1, f"block_n must be >= 1, got {block_n}"
    block_n = min(block_n, N)
    if row_shards <= 1 or K % row_shards:
        return pair_rows_blocked(W, rounding, block_n, criterion=criterion,
                                 magnitudes=magnitudes)
    step = K // row_shards
    offsets = [s * step for s in range(row_shards)]
    slabs = [pair_rows_blocked(W[o:o + step], rounding, block_n, criterion=criterion,
                               magnitudes=magnitudes) for o in offsets]
    blocks = [concat_structured([sl.blocks[b] for sl in slabs], offsets,
                                shape=(K, slabs[0].blocks[b].shape[1]))
              for b in range(slabs[0].n_blocks)]
    return BlockedPairing(blocks=blocks, block_n=block_n, shape=(K, N))


# ---------------------------------------------------------------------------
# Op accounting (Table I of the paper)
# ---------------------------------------------------------------------------


def pairing_op_counts(
    total_weights: int, n_pairs: int, positions: int = 1
) -> dict[str, int]:
    """Mult/add/sub counts for one layer under the paper's accounting.

    A layer with ``total_weights`` MAC weights applied at ``positions``
    output positions costs ``total_weights * positions`` multiplies and the
    same number of additions at baseline.  Every combined pair replaces, per
    position, one multiply and one addition with a single subtraction
    (eq. (1): two MACs become one subtract + one MAC).
    """
    base = total_weights * positions
    subs = n_pairs * positions
    return {
        "mults": base - subs,
        "adds": base - subs,
        "subs": subs,
        "total": 2 * base - subs,
        "baseline_total": 2 * base,
    }


def column_pairing_for_conv(kernel: np.ndarray, rounding: float) -> ColumnPairing:
    """Pair a conv kernel (H, W, Cin, Cout) per output channel (per filter).

    This matches the paper: combinations are sought *within one filter*, since
    both members of a pair must accumulate into the same output value for
    eq. (1) to apply.
    """
    H, Wd, Cin, Cout = kernel.shape
    return pair_columns(kernel.reshape(H * Wd * Cin, Cout), rounding)


def sweep_rounding(
    weights: Sequence[np.ndarray],
    positions: Sequence[int],
    roundings: Sequence[float],
) -> list[dict[str, float]]:
    """Table-I style sweep: op counts for a list of conv weight matrices.

    ``weights[i]`` is a (K_i, N_i) per-column weight matrix (already reshaped
    from the conv kernel), applied at ``positions[i]`` output positions.
    """
    rows = []
    for r in roundings:
        mults = adds = subs = 0
        for Wm, pos in zip(weights, positions, strict=True):
            cp = pair_columns(Wm, r)
            c = pairing_op_counts(Wm.size, cp.total_pairs, pos)
            mults += c["mults"]
            adds += c["adds"]
            subs += c["subs"]
        rows.append(
            {
                "rounding": float(r),
                "adds": int(adds),
                "subs": int(subs),
                "mults": int(mults),
                "total": int(adds + subs + mults),
            }
        )
    return rows
