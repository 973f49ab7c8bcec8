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
* :func:`pair_model_params` folds every eligible leaf of a weight tree (the
  training CLI's ``--paired-rounding``): the paired weights themselves,
  no metadata.

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
    pair_rows_structured,
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
        return w.detach().to("cpu", torch.float64).numpy()
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


def pair_params(
    model,
    rounding: float,
    *,
    mode: str = "structured",
    block_n: int = 0,
    leaves: tuple[tuple[str, str], ...] | None = None,
    criterion: str = "rms",
    min_dim: int = 8,
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

    Returns ``(model', report)``: ``model'`` shares the weights of ``model``
    (nothing is copied) and carries ``block.pairing[name]`` — ``I``/``J``/
    ``resid`` (int64) and ``pair_mask``/``resid_mask`` (fp32) on the
    weights' device.  Weights are not folded: the magnitudes are recomputed
    from the live weights (``kernels.ops.lm_paired_segments``).
    """
    if mode == "per_column":
        mode, block_n = "column_blocked", 1
    if mode not in ("structured", "column_blocked"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "column_blocked" and block_n < 1:
        raise ValueError("mode='column_blocked' needs block_n >= 1")
    specs = tuple(leaves) if leaves is not None else DEFAULT_PAIRED_LEAVES
    matched: set[tuple[str, str]] = set()
    report: list[LeafReport] = []

    def pair_matrix(m: np.ndarray):
        # the lane lists alone: the stacking needs nothing else, and a
        # full-depth model's float64 magnitudes would cost time and fill the host
        if mode == "column_blocked":
            return pair_rows_blocked(m, rounding, min(block_n, m.shape[1]), criterion=criterion,
                                     magnitudes=False)
        return pair_rows_structured(m, rounding, criterion=criterion, magnitudes=False)

    def pair_stack(all_layers, segments, prefix: str) -> list[dict[str, dict]]:
        """Each layer's pairing dicts, keyed by sub-path; the leaves' reports
        go to ``report``."""
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
                if K < min_dim or N < min_dim:
                    continue
                mats = [m for b in blocks
                        for m in (getattr(b, w_name) if expert else [getattr(b, w_name)])]
                pairings = [pair_matrix(_as_numpy(m).reshape(K, N)) for m in mats]
                blocked = mode == "column_blocked"
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
                    pair_fraction=2.0 * n_pairs / n_weights,
                ))
            start += count
        return layer_pairing

    layer_pairing = pair_stack(model.layers, model.segments, "segments")
    encoder_pairing = None
    if model.encoder is not None:
        encoder_pairing = pair_stack(model.encoder.layers, model.encoder.segments,
                                     "encoder.segments")

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


# ---------------------------------------------------------------------------
# whole-tree folding (the training CLI's --paired-rounding)
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
