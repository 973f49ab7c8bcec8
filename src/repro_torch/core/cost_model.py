"""The paper's 65 nm ASIC power/area model over op counts (§IV).

A copy of the ASIC half of ``repro.core.cost_model`` for the PyTorch port
(the port imports nothing from the JAX package).  The JAX package's TPU
roofline model has no counterpart here: device numbers of the port come
from measurements on the GPU (``chip_smoke.py``).

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
