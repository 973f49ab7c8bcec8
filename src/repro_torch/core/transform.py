"""Conv pairing artifacts: the paper's one-time weight preprocessing.

The conv half of ``repro.core.transform``: :func:`build_conv_pairings`
pairs every conv kernel of a LeNet-style param tree and returns one
:class:`PairedLayer` per layer, which ``kernels.paired_conv.paired_conv``
consumes at inference.  Pairing runs on float64 numpy copies of the HWIO
weights, as the reference does, so the metadata matches it index for index
(float32 would change the ties that the stable sort of the row means sees).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.pairing import (
    BlockedPairing,
    StructuredPairing,
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
