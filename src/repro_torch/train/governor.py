"""Power-aware step governor (a pure-Python copy of
`repro/train/governor.py`): the paper's I1 adaptive DVFS as a decision
layer.

The card's clocks are not the program's to set, so the controller that
survives is the choice of execution knobs (microbatch count, remat policy,
compression) from simulated power telemetry (`core.dvfs`, `core.thermal`)
and the roofline terms of the current configuration, as the SoC's DVFS
governor picks P-states. `core.planner.plan()` supplies the bottleneck
verdict; the governor turns it into step overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.planner import PlanDecision, RooflineTerms, plan


@dataclasses.dataclass(frozen=True)
class GovernorState:
    power_budget_w: float = 300.0     # per-host envelope (analytic)
    headroom_ema: float = 0.0
    steps: int = 0


def step_governor(state: GovernorState, *, simulated_power_w: float,
                  alpha: float = 0.1) -> GovernorState:
    """EMA of power headroom, the I1 'workload phase predictor'."""
    headroom = max(0.0, 1.0 - simulated_power_w / state.power_budget_w)
    ema = (1 - alpha) * state.headroom_ema + alpha * headroom
    return dataclasses.replace(state, headroom_ema=ema, steps=state.steps + 1)


def overrides_from_plan(decision: PlanDecision,
                        state: Optional[GovernorState] = None) -> Dict:
    """PlanDecision → step overrides (the 'P-state')."""
    out: Dict = {"remat": decision.remat_policy}
    if decision.compress_grads:
        out["grad_compression"] = "int8"
    if decision.int8_weights:
        out["weight_quant"] = "int8"
    if state is not None and state.headroom_ema > 0.25:
        # plenty of headroom: spend it on throughput (fewer microbatches)
        out["n_micro_bias"] = -1
    return out


def govern(terms: RooflineTerms, *, is_training: bool,
           resident_bytes_per_chip: Optional[float] = None,
           state: Optional[GovernorState] = None) -> Dict:
    """Roofline terms → overrides dict, in one call."""
    decision = plan(terms, is_training=is_training,
                    resident_bytes_per_chip=resident_bytes_per_chip)
    return overrides_from_plan(decision, state)
