"""Model-zoo pairing sweep: every config family through the paired path.

The port of ``benchmarks/model_zoo.py``.  For each of the ten architecture
families (dense, MoE, MLA, SSM, hybrid, encoder-decoder, vision prefix) at
the smoke config's size, in fp32:

1. **r=0 parity**: ``lm_forward`` under ``PerfKnobs(gemm="pallas_paired",
   conv="pallas_paired")`` on a ``pair_params(model, 0.0)`` model must
   match the plain forward (``gemm="xla"``: ``torch.matmul``) to ≤ 1e-5
   relative.  At rounding 0 the criterion admits no pairs, every lane
   lands in the residual GEMM, and K1 must reproduce the exact matmul.
2. **r=0.05 pairing ledger**: per-column pairing at the paper's working
   rounding, reported per leaf and per family; a nonzero rate everywhere,
   at least one MoE *expert* weight among them where the family has experts.

The forward runs eagerly (the JAX bench's ``jax.jit`` and ``perf_context``
have no counterpart) and, on the card, under :func:`common.full_fp32`, so
that the plain side's ``torch.matmul`` is not TF32.
:func:`family_record` takes the model and batch (the tests hand it the JAX
package's weights); :func:`run` seeds them.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only model_zoo [--family ARCH]
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.benchmarks.common import fmt_table, full_fp32, write_result
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.core.transform import pair_params
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import make_batch
from repro_torch.models import lm as M

B, S = 2, 16
QUICK_FAMILIES = ("qwen2-1.5b", "olmoe-1b-7b")  # dense + MoE cover both of K1's grids

_BASE = dict(q_chunk=8, k_chunk=8, remat="none")
KNOBS_XLA = M.PerfKnobs(**_BASE)
KNOBS_PAIRED = M.PerfKnobs(**_BASE, gemm="pallas_paired", conv="pallas_paired")

PARITY_TOL = 1e-5
LEDGER_ROUNDING = 0.05


def is_expert_leaf(path: str) -> bool:
    """A routed expert weight (an MoE's shared experts are not)."""
    return ".moe." in path and ".moe.shared." not in path


def families(quick: bool = False, family: str | None = None) -> tuple[str, ...]:
    """The archs a run covers: ``family`` alone, else the quick two or all ten."""
    if family is not None:
        if family not in ALL_ARCHS:
            raise ValueError(f"unknown family {family!r}; choose from {ALL_ARCHS}")
        return (family,)
    return QUICK_FAMILIES if quick else tuple(ALL_ARCHS)


@torch.no_grad()
def family_record(cfg, model: M.LM, batch: dict) -> dict:
    """One family's record: r=0 parity of the paired forward against the
    plain one on ``batch`` (``make_batch``'s prefill batch), and the
    r=0.05 per-column ledger of ``model`` (the config's paired leaves)."""
    leaves = cfg.paired_leaves or None
    paired0, _ = pair_params(model, 0.0, mode="structured", leaves=leaves)
    extras = {k: batch[k] for k in M.EXTRAS if k in batch} or None
    want, _ = M.lm_forward(cfg, model, batch["tokens"], knobs=KNOBS_XLA, extras=extras)
    got, _ = M.lm_forward(cfg, paired0, batch["tokens"], knobs=KNOBS_PAIRED, extras=extras)
    rel = float((got - want).abs().max() / want.abs().max())

    _, rep = pair_params(model, LEDGER_ROUNDING, mode="per_column", leaves=leaves)
    records = [{"path": lf.path, "shape": list(lf.shape), "n_pairs": lf.n_pairs,
                "pair_fraction": lf.pair_fraction, "is_expert": is_expert_leaf(lf.path)}
               for lf in rep.leaves]
    expert_fracs = [r["pair_fraction"] for r in records if r["is_expert"]]
    return {
        "family": cfg.family,
        "parity_rel_err": rel,
        "parity_ok": rel <= PARITY_TOL,
        "pair_fraction_r005": rep.pair_fraction,
        "n_leaves": len(rep.leaves),
        "moe_expert_pair_fraction": max(expert_fracs) if expert_fracs else None,
        "leaves": records,
    }


def run(quick: bool = False, family: str | None = None, *, device=None) -> dict:
    """Every family of :func:`families` on seed-0 weights on ``device`` (the
    GPU unless ``"cpu"`` is asked for); writes
    ``benchmarks/results/torch_model_zoo.json`` and raises ``AssertionError``
    on a failed gate, as the JAX bench does."""
    dev = resolve_device(device)
    rows, fam_results, failures = [], {}, []
    for arch in families(quick, family):
        t0 = time.time()
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = M.init_lm(cfg, 0, device=dev)
        batch = make_batch(cfg, B, S, "prefill", device=dev)
        with full_fp32():
            res = family_record(cfg, model, batch)
        res["wall_clock_s"] = round(time.time() - t0, 2)
        fam_results[arch] = res
        rows.append({"arch": arch, "family": res["family"], "rel_err_r0": res["parity_rel_err"],
                     "pair_frac_r005": res["pair_fraction_r005"],
                     "expert_frac": res["moe_expert_pair_fraction"] or "-",
                     "leaves": res["n_leaves"]})
        if not res["parity_ok"]:
            failures.append(f"{arch}: r=0 rel err {res['parity_rel_err']:.2e} > "
                            f"{PARITY_TOL:.0e}")
        if not res["pair_fraction_r005"] > 0:
            failures.append(f"{arch}: zero pairing rate at r={LEDGER_ROUNDING}")
        if res["moe_expert_pair_fraction"] is not None and not (
                res["moe_expert_pair_fraction"] > 0):
            failures.append(f"{arch}: MoE expert weights pair nothing")

    print(fmt_table(rows, ["arch", "family", "rel_err_r0", "pair_frac_r005", "expert_frac",
                           "leaves"],
                    title=f"model zoo: r=0 parity + r={LEDGER_ROUNDING} per-column pairing rate"))
    write_result("model_zoo", {"rounding": LEDGER_ROUNDING, "parity_tol": PARITY_TOL,
                               "device": dev.type, "families": fam_results,
                               "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))
    return {"perf_summary": {
        "rounding": LEDGER_ROUNDING,
        "families": {a: {k: v for k, v in r.items() if k != "leaves"}
                     for a, r in fam_results.items()},
    }}
