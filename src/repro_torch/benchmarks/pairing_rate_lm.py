"""Subtractor-pairing rates across the ten LM archs.

The port of ``benchmarks/pairing_rate_lm.py``.  For each architecture (its
smoke config: the pairing rate is a property of the weight distribution,
which the smoke configs share with their published siblings) every GEMM
weight of every layer is paired per column, the paper's Algorithm 1, and
the pair fraction is priced with the paper's 65 nm ASIC model (power and
area saving); the structured (kernel) pairing rate stands beside it.  The
rounding is relative: :data:`ROUNDING_REL` times the median of the nonzero
per-leaf standard deviations of the JAX package's value tree
(:func:`relative_rounding`).

The rows differ from the JAX bench's on purpose.  That bench calls
``pair_model_params`` on the whole LM value tree, which reads each leaf by
its rank, not by what it is: a stacked ``(layers, d, H, hd)`` attention
weight as a conv filter ``(H, W, Cin, Cout)``, the embedding as a GEMM,
while it skips the 3-D MLP stacks ``(layers, d, d_ff)``.  So its rows
price the wrong axes of the wrong leaves.  Here each layer's GEMMs are
paired as the kernel runs them (``core.transform.pair_params``, with
``min_dim=4`` as the JAX bench asks); the JAX package's ``pair_params``
gives the same report on the same weights, which the tests hold.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only pairing_rate_lm [--quick]
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import fmt_table, write_result
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.core.transform import pair_params
from repro_torch.device import resolve_device
from repro_torch.models import lm as M

ROUNDING_REL = 0.25  # rounding as a fraction of the per-leaf weight std
MIN_DIM = 4


def _value_leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in tree.values() if isinstance(tree, dict) else tree:
            yield from _value_leaves(v)
    else:
        yield tree


def relative_rounding(model: M.LM) -> float:
    """:data:`ROUNDING_REL` × the median of the nonzero standard deviations
    of the model's leaves, each leaf as the JAX value tree holds it (a
    segment's layers stacked), its std in float32 as ``np.std`` takes it."""
    stds = [float(np.std(leaf.cpu().numpy()))
            for leaf in _value_leaves(M.lm_value_tree(model))]
    return ROUNDING_REL * float(np.median([s for s in stds if s > 0]))


def rows(model: M.LM, r_abs: float) -> dict:
    """The bench's row of one model at the absolute rounding ``r_abs``: the
    paired weights, the per-column pair fraction and its modelled power and
    area savings, and the structured pair fraction (in %)."""
    _, rep = pair_params(model, r_abs, mode="per_column", min_dim=MIN_DIM)
    _, rep_s = pair_params(model, r_abs, mode="structured", min_dim=MIN_DIM)
    s = rep.savings()
    return {"weights": rep.total_weights,
            "pair_frac_%": 100 * rep.pair_fraction,
            "power_saving_%": 100 * s["power_saving"],
            "area_saving_%": 100 * s["area_saving"],
            "structured_frac_%": 100 * rep_s.pair_fraction}


def run(quick: bool = False, *, device=None) -> dict:
    """Every arch (the first three under ``quick``) on seed-0 weights made
    on ``device`` (the GPU unless ``"cpu"`` is asked for; the pairing itself
    runs on the host); writes ``benchmarks/results/torch_pairing_rate_lm.json``."""
    dev = resolve_device(device)
    out_rows = []
    for arch in ALL_ARCHS[:3] if quick else ALL_ARCHS:
        model = M.init_lm(get_smoke_config(arch), 0, device=dev)
        r_abs = relative_rounding(model)
        out_rows.append({"arch": arch, "r_abs": r_abs, **rows(model, r_abs)})
    out = {"rounding_rel": ROUNDING_REL, "rows": out_rows}
    print(fmt_table(out_rows, list(out_rows[0]),
                    f"Subtractor pairing on LM archs (relative rounding {ROUNDING_REL}·std)"))
    write_result("pairing_rate_lm", out)
    return out
