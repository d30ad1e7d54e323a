"""Chiplet-aware execution planner (a pure-Python copy of
`repro/core/planner.py`).

The paper's system-level thesis — pick the integration/orchestration strategy
from an analytical cost model instead of reacting at runtime — applied to a
compiled cell's roofline terms: decide which optimizations to enable (the
"AI-optimized" configuration of the framework). The hardware constants are
the reference's (a TPU v5e-class chip), so the decisions equal its decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# TPU v5e-class hardware constants (per chip), per the assignment brief.
PEAK_FLOPS_BF16 = 197e12       # FLOP/s
PEAK_FLOPS_INT8 = 394e12       # FLOP/s (2x bf16 on the MXU)
HBM_BW = 819e9                 # bytes/s  (same figure as the paper's HBM3 stack)
ICI_BW = 50e9                  # bytes/s per link


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one compiled (arch x shape x mesh) cell."""

    flops: float               # total HLO FLOPs for one step
    hbm_bytes: float           # total HLO bytes accessed
    collective_bytes: float    # summed collective operand bytes
    chips: int
    model_flops: float = 0.0   # 6*N*D / 6*N_active*D / 2*N*D (analytic)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * ICI_BW)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is 'useful'.

        <1 flags remat recompute / redundancy; >1 flags fused or rematerialized
        estimates (or analytic undercount, e.g. attention FLOPs not in 6ND).
        """
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-time / bound-time: fraction of the roofline achieved if the
        step runs exactly at its dominant bound."""
        if self.model_flops <= 0:
            return 0.0
        ideal_s = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return min(1.0, ideal_s / self.bound_s) if self.bound_s else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,  # type: ignore[dict-item]
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """Which 'AI-optimized' features the planner turns on, and why."""

    compress_grads: bool
    int8_weights: bool
    remat_policy: str          # none | dots | full
    reason: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def plan(
    terms: RooflineTerms,
    *,
    is_training: bool,
    hbm_per_chip_bytes: float = 16e9,
    resident_bytes_per_chip: Optional[float] = None,
) -> PlanDecision:
    """Pick the optimized configuration from the dominant roofline term.

    Mirrors the paper's scenario choice: 'basic chiplet' = everything off;
    'AI-optimized' = the features that attack the measured bottleneck.
    """
    dom = terms.dominant
    compress = bool(is_training and dom == "collective")
    int8 = bool(not is_training and dom == "memory")

    if resident_bytes_per_chip is None:
        remat = "dots" if is_training else "none"
        fit_note = ""
    else:
        frac = resident_bytes_per_chip / hbm_per_chip_bytes
        if not is_training:
            remat = "none"
        elif frac > 0.9:
            remat = "full"
        elif frac > 0.5:
            remat = "dots"
        else:
            remat = "none"
        fit_note = f"; residency {frac:.0%} of HBM"

    reason = (
        f"dominant={dom} "
        f"(compute {terms.compute_s:.3e}s, memory {terms.memory_s:.3e}s, "
        f"collective {terms.collective_s:.3e}s){fit_note}"
    )
    return PlanDecision(
        compress_grads=compress,
        int8_weights=int8,
        remat_policy=remat,
        reason=reason,
    )
