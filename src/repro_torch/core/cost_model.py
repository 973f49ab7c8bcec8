"""The paper's 65 nm ASIC power/area model over op counts (§IV).

A copy of the ASIC half of ``repro.core.cost_model`` for the PyTorch port
(the port imports nothing from the JAX package), the classic useful-FLOP
counts of a step (:func:`model_flops_train`, :func:`model_flops_decode`),
and, in place of the JAX package's ``TpuRoofline`` / ``TPU_V5E``, the
three-term roofline of one GPU (:class:`GpuRoofline`, :data:`H100_SXM`):
the dry run's per-rank FLOPs, HBM bytes and collective wire bytes
(``launch.dryrun``) over the card's peaks.  Those peaks are a data sheet's,
not measurements: device times of the port come from the card
(``chip_smoke.py``).

The paper synthesises IEEE-754 FP multiply / add / subtract units with
Synopsys Design Compiler @ 1 GHz on TSMC 65 nm and reports, for LeNet-5 with
rounding = 0.05 (Table I: 242 153 mult, 242 153 add, 163 447 sub vs. baseline
405 600 mult + 405 600 add):

        power saving = 32.03 %,   area saving = 24.59 %.

The paper does not publish the per-unit numbers, so the two free ratios of
the linear model are calibrated from its own headline results (sub and add
cost the same — a subtractor is an adder with negated input):

    power:  242153·(e+1) + 163447 = (1-0.3203)·405600·(e+1)
            →  E_mul / E_add = 3.874
    area:   242153·(a+1) + 163447 = (1-0.2459)·405600·(a+1)
            →  A_mul / A_add = 1.566
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpCounts:
    mults: int
    adds: int
    subs: int

    @property
    def total(self) -> int:
        return self.mults + self.adds + self.subs


@dataclasses.dataclass(frozen=True)
class AsicCostModel:
    """Linear energy/area model over op counts (units of one FP adder)."""

    e_add: float = 1.0
    e_sub: float = 1.0  # subtractor == adder with one operand negated
    e_mul: float = 3.8742
    a_add: float = 1.0
    a_sub: float = 1.0
    a_mul: float = 1.5655

    def energy(self, ops: OpCounts) -> float:
        return ops.mults * self.e_mul + ops.adds * self.e_add + ops.subs * self.e_sub

    def area(self, ops: OpCounts) -> float:
        """Area of a MAC array provisioned proportionally to the op mix.

        The paper sizes the accelerator datapath to the operation profile of
        the workload (dedicated multiplier/adder/subtractor banks), so area
        scales with the same linear combination as energy but with area
        coefficients.
        """
        return ops.mults * self.a_mul + ops.adds * self.a_add + ops.subs * self.a_sub

    def power_saving(self, base: OpCounts, new: OpCounts) -> float:
        """Fractional power saving (1GHz fixed clock → power ∝ energy/op-mix)."""
        return 1.0 - self.energy(new) / self.energy(base)

    def area_saving(self, base: OpCounts, new: OpCounts) -> float:
        return 1.0 - self.area(new) / self.area(base)


def paper_table1() -> list[dict[str, int | float]]:
    """Table I of the paper, verbatim (LeNet-5, conv layers only)."""
    rows = [
        (0.0, 405600, 0, 405600),
        (0.0001, 399372, 6228, 399372),
        (0.005, 313545, 92055, 313545),
        (0.01, 288887, 116713, 288887),
        (0.015, 276692, 128908, 276692),
        (0.02, 265480, 140120, 265480),
        (0.025, 259789, 145811, 259789),
        (0.05, 242153, 163447, 242153),
        (0.1, 233698, 171902, 233698),
        (0.15, 228752, 176848, 228752),
        (0.2, 225988, 179612, 225988),
        (0.25, 223630, 181970, 223630),
        (0.3, 222742, 182858, 222742),
    ]
    return [
        {"rounding": r, "adds": a, "subs": s, "mults": m, "total": a + s + m}
        for (r, a, s, m) in rows
    ]


# ---------------------------------------------------------------------------
# (b) GPU roofline model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuRoofline:
    """One card's peaks and the three-term roofline evaluation (the JAX
    package's ``TpuRoofline.terms``, with the card's link in place of the
    TPU's ICI link)."""

    name: str
    peak_flops: float  # FLOP/s, bf16 dense on the tensor cores
    peak_flops_fp32: float  # FLOP/s, fp32 outside the tensor cores
    hbm_bw: float  # B/s
    hbm_bytes: float  # bytes of device memory
    link_bw: float  # B/s each way, the card's NVLink

    def terms(
        self,
        flops: float,
        hbm_bytes: float,
        collective_bytes: float,
    ) -> dict[str, float]:
        """Roofline terms in seconds.  Inputs are PER-RANK quantities (one
        rank a card): the FLOPs at the bf16 tensor-core peak, the HBM bytes
        over the memory rate, the collectives' wire bytes over the link."""
        t_compute = flops / self.peak_flops
        t_memory = hbm_bytes / self.hbm_bw
        t_collective = collective_bytes / self.link_bw
        bound = max(
            ("compute", t_compute),
            ("memory", t_memory),
            ("collective", t_collective),
            key=lambda kv: kv[1],
        )[0]
        return {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_collective,
            "bound": bound,  # type: ignore[dict-item]
            "t_bound_s": max(t_compute, t_memory, t_collective),
        }


#: NVIDIA H100 SXM5 80 GB, the data sheet's peaks at the card's 700 W limit:
#: 989 TFLOP/s bf16 dense (tensor cores), 67 TFLOP/s fp32 (CUDA cores),
#: 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s both ways (450 each way).  A
#: card set below 700 W runs slower under load: a roofline share printed
#: from these peaks stands beside the card's ``power.limit``.
H100_SXM = GpuRoofline(
    name="h100-sxm",
    peak_flops=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    link_bw=450e9,
)


def model_flops_train(n_params: int, n_tokens: int) -> float:
    """Classic 6·N·D estimate for one training step (fwd+bwd)."""
    return 6.0 * n_params * n_tokens


def model_flops_decode(n_params: int, n_tokens: int) -> float:
    """2·N per token for one forward (decode) step."""
    return 2.0 * n_params * n_tokens
