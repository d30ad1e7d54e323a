"""Core — the paper's contribution: chiplet SoC models and orchestration
(port of `repro/core`).

Faithful layer (paper §II-§V):
  scenarios / workloads    Table I / Table II
  perf_model               reconstructed closed-form model (Table III, Fig 2)
  dvfs / ucie / thermal / security   innovations I1-I4
  soc                      time-stepped SoC simulator, batched over designs

Beyond-paper layer:
  planner                  roofline-driven plan selection
"""

from repro_torch.core.perf_model import PerfResult, predict, predict_grid, predict_noisy
from repro_torch.core.planner import PlanDecision, RooflineTerms, plan
from repro_torch.core.scenarios import (
    AI_OPTIMIZED,
    BASIC_CHIPLET,
    MONOLITHIC,
    POOR_INTEGRATION,
    SCENARIO_ORDER,
    SCENARIOS,
    Scenario,
    get_scenario,
)
from repro_torch.core.soc import (
    SoCConfig,
    SoCParams,
    build_soc,
    simulate,
    simulate_batch,
    soc_params,
)
from repro_torch.core.workloads import (
    MOBILENET_V2,
    REALTIME_VIDEO,
    RESNET_50,
    WORKLOAD_ORDER,
    WORKLOADS,
    Workload,
    get_workload,
)

__all__ = [
    "AI_OPTIMIZED",
    "BASIC_CHIPLET",
    "MOBILENET_V2",
    "MONOLITHIC",
    "POOR_INTEGRATION",
    "PerfResult",
    "PlanDecision",
    "REALTIME_VIDEO",
    "RESNET_50",
    "RooflineTerms",
    "SCENARIOS",
    "SCENARIO_ORDER",
    "Scenario",
    "SoCConfig",
    "SoCParams",
    "WORKLOADS",
    "WORKLOAD_ORDER",
    "Workload",
    "build_soc",
    "get_scenario",
    "get_workload",
    "plan",
    "predict",
    "predict_grid",
    "predict_noisy",
    "simulate",
    "simulate_batch",
    "soc_params",
]
