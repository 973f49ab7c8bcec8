"""Pairing artifacts: the paper's one-time weight preprocessing.

The conv and LM halves of ``repro.core.transform``.

* :func:`build_conv_pairings` pairs every conv kernel of a LeNet-style param
  tree and returns one :class:`PairedLayer` per layer, which
  ``kernels.paired_conv.paired_conv`` consumes at inference.
* :func:`pair_params` / :func:`pair_lm_params` pair the decoder (and
  encoder) weights of an LM (``models.lm.LM``: attention, cross-attention,
  MLP, experts, SSM projections), each expert's matrix of an MoE layer on
  its own,
  and return a model that shares its weights and carries each weight's
  metadata (``block.pairing[name]``), with a :class:`PairedModelReport`.
* :func:`fold_lm_params` folds an LM's decoder (and encoder) weights per
  column (the CLIs' ``--paired-rounding``): a model of the paired weights
  themselves, no metadata.
* :func:`pair_model_params` folds every eligible leaf of a weight tree, as
  the JAX package's function does (on an LM tree that pairs the wrong axes:
  the CLIs use :func:`fold_lm_params`).

Pairing runs on float64 numpy copies of the weights, as the reference does,
so the metadata matches it index for index (float32 would change the ties
that the stable sort of the row means sees).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.cost_model import AsicCostModel, OpCounts
from repro_torch.core.pairing import (
    BlockedPairing,
    ColumnPairing,
    StructuredPairing,
    fold_columns,
    pair_columns,
    pair_rows_blocked,
    pair_rows_blocked_sharded,
    pair_rows_structured,
    pair_rows_structured_sharded,
)


@dataclasses.dataclass
class PairedLayer:
    """Per-conv-layer deployment artifact for the paired-conv path.

    Carries only the *index structure* (which patch lanes subtract); the
    magnitudes are recomputed from the live weights in the forward, so the
    artifact stays valid under autograd and after weight updates.
    """

    name: str
    kernel_shape: tuple[int, ...]  # (kh, kw, cin, cout)
    rounding: float
    pairing: StructuredPairing | BlockedPairing
    positions: int = 1  # output spatial positions per image (conv M-dim)

    @property
    def n_pairs(self) -> int:
        """Subtractions the kernel executes per output position (for a
        BlockedPairing: summed over blocks)."""
        return self.pairing.n_pairs

    def measured_op_counts(self) -> dict[str, int]:
        """What the paired kernel *executes* per inference image.

        Baseline GEMM lanes equal the paper's multiply count for the layer
        (K·N·positions); every pair removes one contraction lane from each
        column it spans (``weighted_pairs``) and runs one subtract per
        position.
        """
        kh, kw, cin, cout = self.kernel_shape
        K, N = kh * kw * cin, cout
        baseline = K * N * self.positions
        saved = self.pairing.weighted_pairs * self.positions
        return {
            "baseline_lanes": baseline,
            "paired_lanes": baseline - saved,
            "lanes_saved": saved,
            "subs_executed": self.n_pairs * self.positions,
        }


def _as_numpy(w: Any) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        if not w.is_floating_point():
            return w.detach().cpu().numpy()
        return w.detach().cpu().to(torch.float64).numpy()  # widened on the host
    return np.asarray(w)


def build_conv_pairings(
    params: Any,
    rounding: float,
    *,
    positions: dict[str, int] | None = None,
    criterion: str = "rms",
    mode: str = "structured",
    block_n: int = 0,
) -> dict[str, PairedLayer]:
    """Emit a :class:`PairedLayer` for every conv leaf of ``params``.

    ``params`` is a ``{layer_name: {"w": (kh, kw, cin, cout), ...}}`` tree of
    tensors or numpy arrays (the LeNet layout); each 4-D float ``w`` is
    flattened to the im2col GEMM matrix (K, N) and paired.  ``mode`` is
    ``"structured"`` (one shared-row pairing for all N output channels),
    ``"column_blocked"`` (one pairing per ``block_n`` output channels) or
    ``"per_column"`` (the paper's pairing: column_blocked with
    ``block_n=1``).  ``positions`` maps layer names to output spatial
    positions so the artifacts report per-image op counts.
    """
    if mode == "per_column":
        mode, block_n = "column_blocked", 1
    if mode not in ("structured", "column_blocked"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "column_blocked" and block_n < 1:
        raise ValueError("mode='column_blocked' needs block_n >= 1")
    arts: dict[str, PairedLayer] = {}
    for name, leaf in params.items():
        if not isinstance(leaf, dict) or "w" not in leaf:
            continue
        w = _as_numpy(leaf["w"])
        if w.ndim != 4 or w.dtype.kind != "f":
            continue
        kh, kw, cin, cout = w.shape
        wm = w.reshape(kh * kw * cin, cout).astype(np.float64)
        if mode == "column_blocked":
            sp: StructuredPairing | BlockedPairing = pair_rows_blocked(
                wm, rounding, block_n, criterion=criterion
            )
        else:
            sp = pair_rows_structured(wm, rounding, criterion=criterion)
        arts[name] = PairedLayer(
            name=name,
            kernel_shape=tuple(w.shape),
            rounding=rounding,
            pairing=sp,
            positions=(positions or {}).get(name, 1),
        )
    return arts


# ---------------------------------------------------------------------------
# LM pairing: per-layer metadata for the decoder stack
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LeafReport:
    path: str
    shape: tuple[int, ...]
    n_weights: int
    n_pairs: int
    pair_fraction: float  # fraction of weights absorbed into pairs (2P/K·N)
    # the leaf's pairing, where pair_model_params(keep_pairings=True) keeps it
    pairing: ColumnPairing | StructuredPairing | BlockedPairing | None = None
    # shard-aware builds (pair_params(shards=…)): how the leaf's GEMM view was
    # split, and the per-shard ledger: the per-column-equivalent pairs of
    # each column shard (col_shards > 1) or row shard (row_shards > 1),
    # summed over layers; sum(shard_pairs) == n_pairs
    row_shards: int = 1
    col_shards: int = 1
    shard_pairs: tuple[int, ...] | None = None


@dataclasses.dataclass
class PairedModelReport:
    rounding: float
    mode: str
    leaves: list[LeafReport]

    @property
    def total_weights(self) -> int:
        return sum(leaf.n_weights for leaf in self.leaves)

    @property
    def total_pairs(self) -> int:
        return sum(leaf.n_pairs for leaf in self.leaves)

    @property
    def pair_fraction(self) -> float:
        tw = self.total_weights
        return 2.0 * self.total_pairs / tw if tw else 0.0

    def op_counts(self) -> OpCounts:
        """Whole-model op ledger, one application per weight (GEMM accounting)."""
        base, subs = self.total_weights, self.total_pairs
        return OpCounts(mults=base - subs, adds=base - subs, subs=subs)

    def baseline_op_counts(self) -> OpCounts:
        return OpCounts(mults=self.total_weights, adds=self.total_weights, subs=0)

    def savings(self, model: AsicCostModel | None = None) -> dict[str, float]:
        m = model or AsicCostModel()
        return {
            "power_saving": m.power_saving(self.baseline_op_counts(), self.op_counts()),
            "area_saving": m.area_saving(self.baseline_op_counts(), self.op_counts()),
            "pair_fraction": self.pair_fraction,
        }


# Decoder weights of the dense GQA layers: (sub-block, weight name).  "wo"
# contracts over all but its last axis, every other weight over its first.
LM_PAIRED_WEIGHTS: tuple[tuple[str, str], ...] = (
    ("attn", "wq"),
    ("attn", "wk"),
    ("attn", "wv"),
    ("attn", "wo"),
    ("mlp", "w_gate"),
    ("mlp", "w_up"),
    ("mlp", "w_down"),
)
# What pair_params looks for when no leaves are named, in the JAX package's
# order: the dense layers' weights, MLA's down-projections (w_uk/w_uv are
# latent einsums, never paired), the cross-attention's wq/wo (its wk/wv are
# plain products over the encoder output), the routed experts' and the
# shared experts' (the router is never paired), and the SSM block's six
# projections (its depthwise convs are never paired).
DEFAULT_PAIRED_LEAVES: tuple[tuple[str, str], ...] = LM_PAIRED_WEIGHTS + (
    ("attn", "w_dkv"),
    ("attn", "w_kr"),
    ("xattn", "wq"),
    ("xattn", "wo"),
    ("moe", "w_gate"),
    ("moe", "w_up"),
    ("moe", "w_down"),
    ("moe.shared", "w_gate"),
    ("moe.shared", "w_up"),
    ("moe.shared", "w_down"),
    ("mamba", "w_z"),
    ("mamba", "w_x"),
    ("mamba", "w_B"),
    ("mamba", "w_C"),
    ("mamba", "w_dt"),
    ("mamba", "w_out"),
)


def _resolve_sub(layer, sub_path: str):
    """The block at a dotted ``sub_path`` of a decoder layer (``"attn"``,
    ``"moe.shared"``), or None."""
    node = layer
    for part in sub_path.split("."):
        node = getattr(node, part, None)
        if node is None:
            return None
    return node


def _lm_weight_matrix_shape(name: str, shape: tuple[int, ...]) -> tuple[int, int]:
    """(K, N) GEMM view of one *per-layer* decoder weight shape."""
    if name == "wo":
        return int(np.prod(shape[:-1])), int(shape[-1])
    return int(shape[0]), int(np.prod(shape[1:]))


def _stack_structured(pairings: list[StructuredPairing]) -> dict[str, np.ndarray]:
    """Pad per-layer structured pairings to a common (Pmax, Rmax) and stack.

    Padded pair lanes point ``I == J == 0`` (their subtract is exactly zero)
    and padded residual lanes at row 0 with a zero mask, so padding
    contracts against nothing.
    """
    L = len(pairings)
    P = max((sp.n_pairs for sp in pairings), default=0)
    R = max((len(sp.resid) for sp in pairings), default=0)
    I_m, J_m, R_m = (np.zeros((L, n), np.int32) for n in (P, P, R))
    pmask, rmask = np.zeros((L, P), np.float32), np.zeros((L, R), np.float32)
    for l, sp in enumerate(pairings):
        p, r = sp.n_pairs, len(sp.resid)
        I_m[l, :p], J_m[l, :p], R_m[l, :r] = sp.I, sp.J, sp.resid
        pmask[l, :p] = 1.0
        rmask[l, :r] = 1.0
    return {"I": I_m, "J": J_m, "resid": R_m, "pair_mask": pmask, "resid_mask": rmask}


def _stack_blocked(pairings: list[BlockedPairing]) -> dict[str, np.ndarray]:
    """Pad per-layer blocked index matrices to common (Pmax, Rmax), stack."""
    L, B = len(pairings), pairings[0].n_blocks
    P = max(bp.Pmax for bp in pairings)
    R = max(bp.Rmax for bp in pairings)
    I_m, J_m, R_m = (np.zeros((L, B, n), np.int32) for n in (P, P, R))
    pmask, rmask = np.zeros((L, B, P), np.float32), np.zeros((L, B, R), np.float32)
    for l, bp in enumerate(pairings):
        idx = bp.index_arrays()
        p, r = bp.Pmax, bp.Rmax
        I_m[l, :, :p], J_m[l, :, :p], R_m[l, :, :r] = idx["I"], idx["J"], idx["resid"]
        pmask[l, :, :p] = idx["pair_mask"]
        rmask[l, :, :r] = idx["resid_mask"]
    return {"I": I_m, "J": J_m, "resid": R_m, "pair_mask": pmask, "resid_mask": rmask}


def has_lm_pairing(model) -> bool:
    """True iff some block of ``model`` already carries pairing metadata."""
    return any(getattr(m, "pairing", None) for m in model.modules())


def _structured_shard_ledger(pairings: list[StructuredPairing],
                             row_shards: int) -> tuple[int, ...]:
    """Per-row-shard weighted pair counts (both rows of a shard-constrained
    pair live in one shard, so attribution by I is exact)."""
    out = np.zeros(row_shards, np.int64)
    for sp in pairings:
        step = sp.shape[0] // row_shards
        if len(sp.I):
            idx = np.minimum(np.asarray(sp.I, np.int64) // step, row_shards - 1)
            out += np.bincount(idx, minlength=row_shards) * sp.shape[1]
    return tuple(int(x) for x in out)


def _blocked_shard_ledger(pairings: list[BlockedPairing], row_shards: int,
                          col_shards: int) -> tuple[int, ...] | None:
    """Per-shard weighted pair counts of a blocked build, summed over layers:
    column shards own contiguous runs of blocks; with only row shards, pairs
    count where their rows live."""
    if col_shards > 1:
        out = np.zeros(col_shards, np.int64)
        for bp in pairings:
            per = bp.n_blocks // col_shards
            for b, sp in enumerate(bp.blocks):
                out[min(b // per, col_shards - 1)] += sp.n_pairs * sp.shape[1]
        return tuple(int(x) for x in out)
    if row_shards > 1:
        return _structured_shard_ledger([sp for bp in pairings for sp in bp.blocks], row_shards)
    return None


def _resolve_tree(node, sub_path: str):
    """The sub-dict at a dotted ``sub_path`` of a value or axes tree's layer
    dict, or None."""
    for part in sub_path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node if isinstance(node, dict) else None


def tp_shard_plan(param_axes: Any, params: Any, mesh, rules, *,
                  leaves: tuple[tuple[str, str], ...] | None = None
                  ) -> dict[tuple[str, str], tuple[int, int]]:
    """(row_shards, col_shards) of every paired leaf's per-layer GEMM view.

    ``param_axes`` is ``models.param.param_axes(cfg)``, ``params`` a tree of
    the same layout whose leaves have a ``shape`` (``param_axes_and_shapes``'s
    ``meta`` tensors, or ``models.lm.lm_value_tree``).  Each eligible weight's
    axes resolve against (mesh, rules), the ``spec_for_axes`` call that places
    the weight, and the splits of the GEMM's contraction rows and output
    columns are counted.  A split counts only on the *leading* dim of the
    flattened view (a contiguous chunk; a sharded trailing dim would
    interleave), else the leaf stays at 1, which is always safe.  A leaf
    seen with two different splits (an encoder and a decoder) degrades to
    (1, 1).  ``pair_params(shards=…)`` takes the result.
    """
    from repro_torch.parallel.sharding import spec_for_axes

    def mesh_size(entry) -> int:
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        return int(np.prod([mesh.shape[a] for a in names]))

    specs = tuple(leaves) if leaves is not None else DEFAULT_PAIRED_LEAVES
    plan: dict[tuple[str, str], tuple[int, int]] = {}

    def scan_segments(ax_segments: list, val_segments: list) -> None:
        for ax_seg, val_seg in zip(ax_segments, val_segments, strict=True):
            for sub_path, w_name in specs:
                ax_sub, val_sub = _resolve_tree(ax_seg, sub_path), _resolve_tree(val_seg, sub_path)
                if ax_sub is None or val_sub is None or w_name not in ax_sub:
                    continue
                w_axes = ax_sub[w_name]
                shape = tuple(getattr(val_sub[w_name], "shape", ()))
                if not isinstance(w_axes, tuple) or len(w_axes) != len(shape):
                    continue
                nd = len(shape)
                expert = sub_path.split(".")[-1] == "moe" and nd == 4
                mat0 = 2 if expert else 1
                if nd <= mat0:
                    continue
                spec = spec_for_axes(w_axes, mesh=mesh, rules=rules, dim_sizes=shape)
                if w_name == "wo":
                    row_dims, col_dims = list(range(mat0, nd - 1)), [nd - 1]
                else:
                    row_dims, col_dims = [mat0], list(range(mat0 + 1, nd))

                def split(dims, spec=spec):
                    lead = spec[dims[0]]
                    if lead is None or any(spec[d] is not None for d in dims[1:]):
                        return 1
                    return mesh_size(lead)

                rc = (split(row_dims), split(col_dims))
                key = (sub_path, w_name)
                plan[key] = (1, 1) if key in plan and plan[key] != rc else rc

    scan_segments(param_axes.get("segments", []), params.get("segments", []))
    ax_enc, val_enc = param_axes.get("encoder"), params.get("encoder")
    if isinstance(ax_enc, dict) and isinstance(val_enc, dict):
        scan_segments(ax_enc.get("segments", []), val_enc.get("segments", []))
    return plan


def _effective_shards(K: int, N: int, want: tuple[int, int], mode: str,
                      block_n: int) -> tuple[int, int]:
    """The (row, col) shards a leaf is paired at: a count that does not
    divide its dim degrades to 1, and so does a column split that would cut
    a pairing block; structured pairs are whole rows, which a column split
    never cuts, so only the rows are constrained there."""
    rs = want[0] if want[0] > 1 and K % want[0] == 0 else 1
    cs = want[1] if want[1] > 1 and N % want[1] == 0 else 1
    if mode != "column_blocked":
        return rs, 1
    if cs > 1 and (N // cs) % min(block_n, N):
        cs = 1  # a shard boundary would split a block: keep it whole
    return rs, cs


def _pair_stacks(model, specs, min_dim: int, pair_stack, whole_dims=None):
    """Run ``pair_stack(sub_path, w_name, mats, K, N, expert, segment, first,
    stack)``
    over every eligible weight of each segment of identical layers of the
    model (decoder, then encoder: ``stack`` is ``"segments"`` or
    ``"encoder.segments"``), ``mats`` the segment's (K, N) weight views
    (tensors, ``count × E`` of them for experts; each is copied to float64 by
    :func:`_as_numpy` only as it is paired: a segment of expert matrices in
    float64 at once would not fit the host).  It returns ``(pairings,
    report kwargs)``; the pairings of a segment are padded to one
    (Pmax, Rmax) and each layer gets its slice.  Returns ``(matched,
    reports, layer_pairing, encoder_pairing)``.  A weight is eligible when
    both its GEMM dims reach ``min_dim``: its own, or those
    ``whole_dims(sub_path, w_name, expert, stack, first)`` gives (a rank's
    shard is paired where the whole weight would be)."""
    matched: set[tuple[str, str]] = set()
    report: list[LeafReport] = []

    def stack_of(all_layers, segments, prefix: str) -> list[dict[str, dict]]:
        layer_pairing: list[dict[str, dict]] = [{} for _ in all_layers]
        start = 0
        for si, (_, count) in enumerate(segments):
            layers = all_layers[start:start + count]
            for sub_path, w_name in specs:
                blocks = [_resolve_sub(layer, sub_path) for layer in layers]
                if any(b is None or not hasattr(b, w_name) for b in blocks):
                    continue
                matched.add((sub_path, w_name))
                shape = tuple(getattr(blocks[0], w_name).shape)
                if len(shape) < 2:
                    continue  # matrices only
                # expert weights carry a leading expert axis: one matrix per expert
                expert = sub_path.split(".")[-1] == "moe" and len(shape) == 3
                K, N = _lm_weight_matrix_shape(w_name, shape[1:] if expert else shape)
                Ke, Ne = ((K, N) if whole_dims is None
                          else whole_dims(sub_path, w_name, expert, prefix, start))
                if Ke < min_dim or Ne < min_dim:
                    continue
                mats = [m.reshape(K, N) for b in blocks
                        for m in (getattr(b, w_name) if expert else [getattr(b, w_name)])]
                pairings, extra = pair_stack(sub_path, w_name, mats, K, N, expert, si, start,
                                             prefix)
                blocked = isinstance(pairings[0], BlockedPairing)
                meta = (_stack_blocked if blocked else _stack_structured)(pairings)
                if expert:
                    meta = {k: v.reshape(count, shape[0], *v.shape[1:]) for k, v in meta.items()}
                device = getattr(blocks[0], w_name).device
                for l in range(count):
                    layer_meta = {k: torch.as_tensor(v[l], device=device) for k, v in meta.items()}
                    for k in ("I", "J", "resid"):
                        layer_meta[k] = layer_meta[k].long()
                    layer_pairing[start + l].setdefault(sub_path, dict(blocks[l].pairing))[
                        w_name] = layer_meta
                n_pairs = sum(p.weighted_pairs for p in pairings)
                n_weights = len(mats) * K * N
                report.append(LeafReport(
                    path=f"{prefix}[{si}].{sub_path}.{w_name}", shape=(count, *shape),
                    n_weights=n_weights, n_pairs=int(n_pairs),
                    pair_fraction=2.0 * n_pairs / n_weights, **extra,
                ))
            start += count
        return layer_pairing

    layer_pairing = stack_of(model.layers, model.segments, "segments")
    encoder_pairing = None
    if model.encoder is not None:
        encoder_pairing = stack_of(model.encoder.layers, model.encoder.segments,
                                   "encoder.segments")
    return matched, report, layer_pairing, encoder_pairing


def _check_mode(mode: str, block_n: int) -> tuple[str, int]:
    if mode == "per_column":
        mode, block_n = "column_blocked", 1
    if mode not in ("structured", "column_blocked"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "column_blocked" and block_n < 1:
        raise ValueError("mode='column_blocked' needs block_n >= 1")
    return mode, block_n


def _finish(model, specs, leaves, min_dim, matched, report, layer_pairing, encoder_pairing,
            rounding, mode):
    unmatched = [s for s in specs if s not in matched]
    if leaves is not None and unmatched:
        raise ValueError("pair_params: no weight matched leaf spec(s) "
                         + ", ".join(f"{sp}.{wn}" for sp, wn in unmatched))
    if not report:
        raise ValueError("pair_params: no pairing-eligible weights found; looked for "
                         + ", ".join(f"{sp}.{wn}" for sp, wn in specs)
                         + f" among matrices with GEMM dims >= {min_dim}")
    paired = model.copy(frozen=False, layer_pairing=layer_pairing,
                        encoder_pairing=encoder_pairing)
    return paired, PairedModelReport(rounding=rounding, mode=mode, leaves=report)


def pair_params(
    model,
    rounding: float,
    *,
    mode: str = "structured",
    block_n: int = 0,
    leaves: tuple[tuple[str, str], ...] | None = None,
    criterion: str = "rms",
    min_dim: int = 8,
    shards: dict[tuple[str, str], tuple[int, int]] | None = None,
):
    """Pairing metadata for the decoder weights of an LM (``models.lm.LM``),
    and for its encoder's (reported after them, as ``encoder.segments[…]``).

    Each eligible weight of each layer is paired on a float64 copy, one
    matrix at a time; an MoE layer's ``(E, K, F)`` expert weights pair each
    expert's matrix separately.  Within a segment of identical layers the
    lane lists of all its matrices (``count × E`` of them for experts) pad to
    one (Pmax, Rmax), as the JAX package's stacked metadata does, and each
    layer gets its slice: ``(Pmax,)``/``(B, Pmax)`` for a plain weight,
    ``(E, Pmax)``/``(E, Bc, Pmax)`` for expert weights.
    Leaf selection is by ``(sub-path, weight-name)`` specs, a dotted
    sub-path (``"moe.shared"``) naming a nested block; with
    ``leaves=None`` the :data:`DEFAULT_PAIRED_LEAVES` the layers carry are
    paired, while an explicit list requires every spec to match.  ``mode``
    is ``"structured"``, ``"column_blocked"`` (one pairing per ``block_n``
    columns) or ``"per_column"`` (``block_n=1``, the paper's Algorithm 1).

    ``shards`` makes the build shard-aware, as the JAX package's: a mapping
    from ``(sub_path, weight_name)`` to the ``(row_shards, col_shards)`` of
    the leaf's per-layer GEMM view (:func:`tp_shard_plan`).  Row shards
    constrain the pairing so no pair spans two contraction shards; column
    shards must land on block boundaries (else the leaf is paired whole);
    counts that do not divide a dim degrade to 1.  Each
    :class:`LeafReport` then carries ``row_shards``, ``col_shards`` and the
    per-shard ledger ``shard_pairs``.

    Returns ``(model', report)``: ``model'`` shares the weights of ``model``
    (nothing is copied) and carries ``block.pairing[name]`` — ``I``/``J``/
    ``resid`` (int64) and ``pair_mask``/``resid_mask`` (fp32) on the
    weights' device.  Weights are not folded: the magnitudes are recomputed
    from the live weights (``kernels.ops.lm_paired_segments``).
    """
    mode, block_n = _check_mode(mode, block_n)
    specs = tuple(leaves) if leaves is not None else DEFAULT_PAIRED_LEAVES

    def pair_stack(sub_path, w_name, mats, K, N, expert, si, start, stack):
        # the lane lists alone: the stacking needs nothing else, and a
        # full-depth model's float64 magnitudes would cost time and fill the host
        rs, cs = _effective_shards(K, N, (shards or {}).get((sub_path, w_name), (1, 1)),
                                   mode, block_n)
        if mode == "column_blocked":
            ps = [pair_rows_blocked_sharded(m, rounding, min(block_n, N), criterion=criterion,
                                            row_shards=rs, magnitudes=False)
                  for m in map(_as_numpy, mats)]
            ledger = _blocked_shard_ledger(ps, rs, cs)
        else:
            ps = [pair_rows_structured_sharded(m, rounding, criterion=criterion, row_shards=rs,
                                               magnitudes=False)
                  for m in map(_as_numpy, mats)]
            ledger = _structured_shard_ledger(ps, rs) if rs > 1 else None
        return ps, ({"row_shards": rs, "col_shards": cs, "shard_pairs": ledger}
                    if shards is not None else {})

    found = _pair_stacks(model, specs, min_dim, pair_stack)
    return _finish(model, specs, leaves, min_dim, *found, rounding, mode)


def _pair_one(m: np.ndarray, rounding: float, mode: str, block_n: int, criterion: str):
    if mode == "column_blocked":
        return pair_rows_blocked(m, rounding, min(block_n, m.shape[1]), criterion=criterion,
                                 magnitudes=False)
    return pair_rows_structured(m, rounding, criterion=criterion, magnitudes=False)


def row_lead_dim(w_name: str, expert: bool) -> int:
    """The leading dim of a per-layer weight's GEMM rows (its contraction):
    the expert axis comes first in an expert stack."""
    return 1 if expert and w_name != "wo" else 0


def pair_shard_leaf(whole, local, w_name: str, rounding: float, *, shards: tuple[int, int],
                    expert: bool = False, mode: str = "structured", block_n: int = 0,
                    criterion: str = "rms", row_slab: int = 0):
    """One layer's pairing of one leaf on a tensor-parallel rank, at its
    :func:`tp_shard_plan` split ``shards`` (degraded as :func:`pair_params`
    degrades it): ``whole`` the layer's whole weight (per layer, experts
    first), ``local`` the rank's block of it, ``row_slab`` the rank's index
    among the row shards.  Returns ``(pairings, (Kf, Nf), (rs, cs))``, one
    pairing per matrix the rank holds (per expert of an expert stack):

    * a row-parallel leaf (``rs > 1``): the rank's row slab, paired alone;
      its lane lists index the slab's rows;
    * a column-blocked, column-parallel leaf: the rank's own blocks, from its
      local columns (a split that would cut a block raises);
    * a structured, column-parallel leaf: the lane lists of the whole
      matrix's rows (of the rank's row slab, where the rows split too: FSDP's
      ``wq``), shared by the rank's columns;
    * a replicated leaf, and every expert the rank holds: its whole matrix.
    """
    mode, block_n = _check_mode(mode, block_n)
    Kf, Nf = _lm_weight_matrix_shape(w_name, tuple(whole.shape[1:] if expert else whole.shape))
    K, N = _lm_weight_matrix_shape(w_name, tuple(local.shape[1:] if expert else local.shape))
    rs, cs = _effective_shards(Kf, Nf, shards, mode, block_n)
    if (rs > 1 and K * rs != Kf) or (cs > 1 and N * cs != Nf):
        raise ValueError(f"{w_name}: the rank holds a ({K}, {N}) view of a ({Kf}, {Nf}) "
                         f"matrix split ({rs}, {cs})")
    if mode == "column_blocked" and N != Nf and cs == 1 and shards[1] > 1:
        raise ValueError(f"{w_name}: pair_block_n={block_n} cuts the {Nf // shards[1]}-column "
                         "shards' blocks; pick a block size that divides them")
    if mode == "structured" and N != Nf and not expert:
        # the lane lists of the whole rows the rank holds, shared by its columns
        rows = whole.reshape(Kf, Nf)[row_slab * K:(row_slab + 1) * K]
        ps = [dataclasses.replace(_pair_one(_as_numpy(rows), rounding, mode, block_n,
                                            criterion), shape=(K, N))]
    else:
        ps = [_pair_one(_as_numpy(m.reshape(K, N)), rounding, mode, block_n, criterion)
              for m in (local if expert else [local])]
    return ps, (Kf, Nf), (rs, cs)


def _paired_leaf(name: str, whole, leaves):
    """Parameter ``name``'s ``((stack, layer, sub_path, w_name), expert)``
    where its per-layer weight ``whole`` is a paired leaf's matrix (of
    ``leaves``, :data:`DEFAULT_PAIRED_LEAVES` by default), else None."""
    parts = name.split(".")
    stack = "encoder.segments" if parts[0] == "encoder" else "segments"
    parts = parts[1:] if parts[0] == "encoder" else parts
    if parts[0] != "layers" or whole.ndim < 2:
        return None
    sub_path, w_name = ".".join(parts[2:-1]), parts[-1]
    if (sub_path, w_name) not in (tuple(leaves) if leaves is not None else DEFAULT_PAIRED_LEAVES):
        return None
    expert = sub_path.split(".")[-1] == "moe" and whole.ndim == 3
    return (stack, int(parts[1]), sub_path, w_name), expert


def premade_entry(name: str, whole, block, spec, mesh, rounding: float, *,
                  shards: dict[tuple[str, str], tuple[int, int]], mode: str = "structured",
                  block_n: int = 0, leaves: tuple[tuple[str, str], ...] | None = None,
                  criterion: str = "rms", min_dim: int = 8):
    """The :func:`pair_shard_params` ``premade`` entry of parameter ``name``
    (``"layers.3.attn.wq"``, ``"encoder.layers.0.mlp.w_up"``) from its
    ``whole`` per-layer weight and the rank's ``block`` of it under its
    per-layer ``spec``: ``(key, (pairings, (Kf, Nf), (rs, cs)))``, the
    pairings None where the leaf is too small to pair; None for a parameter
    that is no paired leaf's."""
    found = _paired_leaf(name, whole, leaves)
    if found is None:
        return None
    key, expert = found
    sub_path, w_name = key[2:]
    Kf, Nf = _lm_weight_matrix_shape(w_name, tuple(whole.shape[1:] if expert else whole.shape))
    if Kf < min_dim or Nf < min_dim:
        return key, (None, (Kf, Nf), (1, 1))
    return key, pair_shard_leaf(whole, block, w_name, rounding,
                                shards=shards.get((sub_path, w_name), (1, 1)), expert=expert,
                                mode=mode, block_n=block_n, criterion=criterion,
                                row_slab=mesh.index(spec[row_lead_dim(w_name, expert)]))


def pair_shard_params(
    local,
    full,
    rounding: float,
    *,
    shards: dict[tuple[str, str], tuple[int, int]],
    mode: str = "structured",
    block_n: int = 0,
    leaves: tuple[tuple[str, str], ...] | None = None,
    criterion: str = "rms",
    min_dim: int = 8,
    mesh=None,
    specs: dict | None = None,
    premade: dict | None = None,
):
    """One tensor-parallel rank's pairing: the metadata of ``local``, the
    rank's shard of the model ``full`` (``launch.steps.wire_serve_cell``
    slices it), built from what the rank reads: each leaf of each layer by
    :func:`pair_shard_leaf` at its :func:`tp_shard_plan` split.  ``mesh``
    and ``specs`` (the weights' resolved specs) give the rank's row slab of
    a leaf whose rows and columns both split (FSDP).  ``premade`` (with
    ``full=None``): each leaf's :func:`pair_shard_leaf` result already made,
    keyed ``(stack, layer, sub_path, w_name)`` (``stack`` ``"segments"`` or
    ``"encoder.segments"``; the pairings ``None`` for a leaf too small to
    pair): a rank that builds its shards leaf by leaf pairs each whole
    leaf while it exists (``launch.steps.local_model``).

    Returns ``(local', report)``: ``local'`` shares ``local``'s weights and
    carries the metadata; the report's ``n_pairs`` count the rank's own
    matrices at their local column counts, with the leaf's split.
    """
    mode, block_n = _check_mode(mode, block_n)
    specs_l = tuple(leaves) if leaves is not None else DEFAULT_PAIRED_LEAVES

    def layers_of(model, stack: str):
        return model.encoder.layers if stack == "encoder.segments" else model.layers

    def whole_dims(sub_path, w_name, expert, stack, first):
        if premade is not None:
            return premade[(stack, first, sub_path, w_name)][1]
        shape = tuple(getattr(_resolve_sub(layers_of(full, stack)[first], sub_path),
                              w_name).shape)
        return _lm_weight_matrix_shape(w_name, shape[1:] if expert else shape)

    def row_slab(stack, si, sub_path, w_name, expert):
        if mesh is None:
            return 0
        seg = specs["encoder"]["segments"][si] if stack == "encoder.segments" else \
            specs["segments"][si]
        spec = _resolve_tree(seg, sub_path)[w_name][1:]
        return mesh.index(spec[row_lead_dim(w_name, expert)])

    def pair_stack(sub_path, w_name, mats, K, N, expert, si, first, stack):
        loc = layers_of(local, stack)
        per = getattr(_resolve_sub(loc[first], sub_path), w_name).shape[0] if expert else 1
        ps, rcs = [], None
        for l in range(first, first + len(mats) // per):
            if premade is not None:
                got, _, rcs = premade[(stack, l, sub_path, w_name)]
            else:
                whole = getattr(_resolve_sub(layers_of(full, stack)[l], sub_path), w_name)
                got, _, rcs = pair_shard_leaf(
                    whole, getattr(_resolve_sub(loc[l], sub_path), w_name), w_name, rounding,
                    shards=shards.get((sub_path, w_name), (1, 1)), expert=expert, mode=mode,
                    block_n=block_n, criterion=criterion,
                    row_slab=row_slab(stack, si, sub_path, w_name, expert))
            ps.extend(got)
        return ps, {"row_shards": rcs[0], "col_shards": rcs[1]}

    found = _pair_stacks(local, specs_l, min_dim, pair_stack, whole_dims)
    return _finish(local, specs_l, leaves, min_dim, *found, rounding, mode)


def pair_lm_params(
    model,
    rounding: float,
    *,
    mode: str = "structured",
    block_n: int = 0,
    criterion: str = "rms",
    min_dim: int = 8,
):
    """:func:`pair_params` over whatever of :data:`DEFAULT_PAIRED_LEAVES` the
    model carries."""
    return pair_params(model, rounding, mode=mode, block_n=block_n,
                       criterion=criterion, min_dim=min_dim)


def fold_lm_params(model, rounding: float, *, block_n: int = 1, criterion: str = "rms",
                   min_dim: int = 8):
    """The LM with each eligible decoder (and encoder) weight replaced by
    its paired equivalent: ``pair_lm_params(model, rounding,
    mode="column_blocked", block_n=block_n)`` (1: the paper's per-column
    pairing), each weight then folded by ``kernels.ops.fold_lm_weight`` (an
    expert weight by ``fold_lm_expert_weight``) in fp32 and cast back to its
    dtype.  The CLIs' ``--paired-rounding``: the JAX package's CLIs run
    ``pair_model_params`` on the whole value tree instead, which reads a
    stacked ``(layers, d, H, hd)`` attention weight as a conv filter and
    pairs across layers and heads.

    Returns ``(model', report)``: ``model'`` carries the folded weights (new
    tensors) and the rest of ``model``'s (shared), and no pairing metadata;
    ``report`` is the pairing's :class:`PairedModelReport`."""
    from repro_torch.kernels.ops import fold_lm_expert_weight, fold_lm_weight
    from repro_torch.models.layers import Block, MoE

    paired, report = pair_lm_params(model, rounding, mode="column_blocked", block_n=block_n,
                                    criterion=criterion, min_dim=min_dim)
    folded = model.copy(frozen=False)
    for src, dst in zip(paired.modules(), folded.modules(), strict=True):
        if not isinstance(dst, Block):
            continue
        for name, meta in src.pairing.items():
            w = getattr(src, name)
            if isinstance(src, MoE) and w.ndim == 3:
                wf = fold_lm_expert_weight(w.float(), meta, block_n)
            else:
                wf = fold_lm_weight(src.matrix(name, torch.float32), meta, block_n)
            dst.register_parameter(name, torch.nn.Parameter(
                wf.reshape(w.shape).to(w.dtype), requires_grad=w.requires_grad))
        dst.pairing = {}
    return folded, report


def leaf_folder(rounding: float, *, block_n: int = 1, criterion: str = "rms",
                min_dim: int = 8):
    """:func:`fold_lm_params` a leaf at a time, for a rank that builds its
    blocks leaf by leaf (``launch.steps.local_model``'s ``fold``).  Returns
    ``(fold, report)``: ``fold(name, whole)`` gives parameter ``name``'s
    whole per-layer weight folded, paired as :func:`fold_lm_params` pairs
    it (column-blocked at ``block_n``, each expert's matrix alone), or
    ``whole`` itself where it is no paired leaf's; each folded leaf's
    ledger joins ``report``'s leaves (one a layer: the totals are
    :func:`fold_lm_params`'s)."""
    from repro_torch.kernels.ops import fold_lm_expert_weight, fold_lm_weight

    report = PairedModelReport(rounding=rounding, mode="column_blocked", leaves=[])

    def fold(name: str, whole: torch.Tensor) -> torch.Tensor:
        found = _paired_leaf(name, whole, None)
        if found is None:
            return whole
        (_, _, _, w_name), expert = found
        K, N = _lm_weight_matrix_shape(w_name, tuple(whole.shape[1:] if expert else whole.shape))
        if K < min_dim or N < min_dim:
            return whole
        mats = list(whole) if expert else [whole]
        ps = [_pair_one(_as_numpy(m.reshape(K, N)), rounding, "column_blocked", block_n,
                        criterion) for m in mats]
        meta = {k: torch.as_tensor(v, device=whole.device) for k, v in _stack_blocked(ps).items()}
        for k in ("I", "J", "resid"):
            meta[k] = meta[k].long()
        if expert:
            wf = fold_lm_expert_weight(whole.float(), meta, block_n)
        else:
            wf = fold_lm_weight(whole.reshape(K, N).float(), {k: v[0] for k, v in meta.items()},
                                block_n)
        n_pairs = sum(p.weighted_pairs for p in ps)
        report.leaves.append(LeafReport(path=name, shape=tuple(whole.shape),
                                        n_weights=len(mats) * K * N, n_pairs=int(n_pairs),
                                        pair_fraction=2.0 * n_pairs / (len(mats) * K * N)))
        return wf.reshape(whole.shape).to(whole.dtype)

    return fold, report


# ---------------------------------------------------------------------------
# whole-tree folding (the JAX package's pair_model_params)
# ---------------------------------------------------------------------------


def _tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts (keys in sorted order, as JAX
    walks them), lists and tuples; paths in ``jax.tree_util.keystr``'s
    form (``['segments'][0]['attn']['wq']``)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, tree[k], f"{path}[{k!r}]")
                for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def pair_model_params(
    params: Any,
    rounding: float,
    *,
    mode: str = "per_column",
    block_n: int = 0,
    min_dim: int = 8,
    predicate=None,
    keep_pairings: bool = False,
):
    """Pair and fold every eligible weight leaf of ``params``.

    ``params`` is a tree of nested dicts, lists and tuples whose leaves are
    tensors or numpy arrays.  Eligible: a float leaf with 2 or 4 axes whose
    contraction dims are both at least ``min_dim``, and ``predicate(path,
    leaf)`` (if given) true.  A 4-D leaf is a conv kernel (H, W, Cin, Cout),
    paired per filter as the paper does for LeNet-5; a 2-D leaf (K, N) per
    column (per output neuron).  ``mode``: ``"per_column"`` (the paper's
    Algorithm 1), ``"structured"`` (one shared-row pairing a leaf) or
    ``"column_blocked"`` (one shared-row pairing per ``block_n`` columns).

    Returns ``(params', report)``: the same structure, each eligible leaf
    replaced by its folded equivalent in the leaf's dtype (and device), the
    rest as they were; pairing runs on float64 copies, as in the JAX
    package's ``pair_model_params``.
    """
    if mode == "column_blocked" and block_n < 1:
        raise ValueError("mode='column_blocked' needs block_n >= 1")
    if mode not in ("per_column", "structured", "column_blocked"):
        raise ValueError(f"unknown mode {mode!r}")
    report: list[LeafReport] = []

    def handle(path: str, leaf):
        if not isinstance(leaf, (np.ndarray, torch.Tensor)):
            return leaf
        floating = leaf.is_floating_point() if isinstance(leaf, torch.Tensor) else (
            leaf.dtype.kind == "f")
        if not floating or leaf.ndim not in (2, 4):
            return leaf
        shape = tuple(leaf.shape)
        K, N = (int(np.prod(shape[:-1])), shape[-1]) if len(shape) == 4 else shape
        if K < min_dim or N < min_dim:
            return leaf
        if predicate is not None and not predicate(path, leaf):
            return leaf
        mat = _as_numpy(leaf).astype(np.float64).reshape(K, N)
        if mode == "per_column":
            pairing = pair_columns(mat, rounding)
            folded, n_pairs = fold_columns(mat, pairing), pairing.total_pairs
        elif mode == "structured":
            pairing = pair_rows_structured(mat, rounding)
            folded, n_pairs = pairing.fold(), pairing.weighted_pairs
        else:
            pairing = pair_rows_blocked(mat, rounding, block_n)
            folded, n_pairs = pairing.fold(), pairing.weighted_pairs
        report.append(LeafReport(path=path, shape=shape, n_weights=K * N, n_pairs=int(n_pairs),
                                 pair_fraction=2.0 * n_pairs / (K * N),
                                 pairing=pairing if keep_pairings else None))
        folded = folded.reshape(shape)
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(folded).to(dtype=leaf.dtype, device=leaf.device)
        return folded.astype(leaf.dtype)

    paired = _tree_map_with_path(handle, params)
    return paired, PairedModelReport(rounding=rounding, mode=mode, leaves=report)
