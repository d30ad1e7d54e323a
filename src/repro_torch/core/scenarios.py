"""Integration scenarios — Table I of the paper, as typed configs (port of
`repro/core/scenarios.py`).

Each scenario describes one way of integrating the SoC's chiplets:
  monolithic       — single large die, no die-to-die links (the yield-limited baseline)
  basic_chiplet    — naive 2.5D chiplet integration over UCIe 1.x-class links
  ai_optimized     — the paper's proposal: UCIe 2.0 + streaming FLITs + prefetch +
                     compression-aware transfers + adaptive DVFS (innovations I1+I2)
  poor_integration — pathological integration (slow links, high protocol overhead)

All parameters are the paper's Table I values verbatim; the dataclass holds
Python floats and `as_vector` makes the f32 tensor on a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One integration scenario (a row of Table I)."""

    name: str
    # -- Table I columns ------------------------------------------------------
    link_latency_us: float        # die-to-die link latency (one-way), microseconds
    link_bandwidth_gbps: float    # die-to-die bandwidth, Gbit/s (inf for monolithic)
    base_power_mw: float          # SoC base (max dynamic+static) power envelope, mW
    comm_power_mw_per_ms: float   # incremental link power per ms of transfer, mW/ms
    efficiency_factor: float      # compute-time multiplier (<1 = faster silicon)
    throttle_threshold: float     # sustained-utilization level that triggers derating
    static_power_ratio: float     # fraction of base power that is static/leakage
    voltage_scale: float          # supply scaling vs nominal (power ~ v^2)
    protocol_overhead: float      # transfer-time multiplier from the link protocol
    # -- paper §II mechanism flags (I1/I2) ------------------------------------
    prefetch_overlap: bool = False    # I2: predictive prefetch hides T_comm
    compression_ratio: float = 1.0    # I2: effective payload ratio (<1 = compressed)
    dvfs_adaptive: bool = False       # I1: power-headroom clock boost enabled
    dvfs_boost_max: float = 0.0       # I1: max fractional clock boost (e.g. 0.032)

    @property
    def is_monolithic(self) -> bool:
        return math.isinf(self.link_bandwidth_gbps)

    def as_vector(self, device=None) -> torch.Tensor:
        """Numeric encoding for batched design-space sweeps, (12,) f32."""
        bw = 1e9 if self.is_monolithic else self.link_bandwidth_gbps
        return torch.tensor(
            [
                self.link_latency_us,
                bw,
                self.base_power_mw,
                self.comm_power_mw_per_ms,
                self.efficiency_factor,
                self.throttle_threshold,
                self.static_power_ratio,
                self.voltage_scale,
                self.protocol_overhead,
                1.0 if self.prefetch_overlap else 0.0,
                self.compression_ratio,
                self.dvfs_boost_max if self.dvfs_adaptive else 0.0,
            ],
            dtype=torch.float32,
            device=resolve_device(device),
        )

    @staticmethod
    def vector_fields() -> Tuple[str, ...]:
        return (
            "link_latency_us",
            "link_bandwidth_gbps",
            "base_power_mw",
            "comm_power_mw_per_ms",
            "efficiency_factor",
            "throttle_threshold",
            "static_power_ratio",
            "voltage_scale",
            "protocol_overhead",
            "prefetch_overlap",
            "compression_ratio",
            "dvfs_boost",
        )


MONOLITHIC = Scenario(
    name="monolithic",
    link_latency_us=0.0,
    link_bandwidth_gbps=math.inf,
    base_power_mw=1500.0,
    comm_power_mw_per_ms=0.0,
    efficiency_factor=1.00,
    throttle_threshold=0.95,
    static_power_ratio=0.40,
    voltage_scale=1.00,
    protocol_overhead=1.0,  # '—' in Table I: no die-to-die protocol
)

BASIC_CHIPLET = Scenario(
    name="basic_chiplet",
    link_latency_us=1.5,
    link_bandwidth_gbps=16.0,
    base_power_mw=1200.0,
    comm_power_mw_per_ms=35.0,
    efficiency_factor=0.95,
    throttle_threshold=0.85,
    static_power_ratio=0.45,
    voltage_scale=1.00,
    protocol_overhead=1.15,
)

AI_OPTIMIZED = Scenario(
    name="ai_optimized",
    link_latency_us=0.8,
    link_bandwidth_gbps=24.0,
    base_power_mw=1100.0,
    comm_power_mw_per_ms=25.0,
    efficiency_factor=0.90,
    throttle_threshold=0.80,
    static_power_ratio=0.42,
    voltage_scale=0.95,
    protocol_overhead=1.08,
    # Paper §II: streaming FLITs + predictive prefetching + compression-aware
    # transfers (I2) and adaptive cross-chiplet DVFS (I1).
    prefetch_overlap=True,
    compression_ratio=0.75,
    dvfs_adaptive=True,
    dvfs_boost_max=0.032,
)

POOR_INTEGRATION = Scenario(
    name="poor_integration",
    link_latency_us=8.0,
    link_bandwidth_gbps=8.0,
    base_power_mw=1800.0,
    comm_power_mw_per_ms=80.0,
    efficiency_factor=1.10,
    throttle_threshold=1.00,
    static_power_ratio=0.50,
    voltage_scale=1.05,
    protocol_overhead=1.25,
)

SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (MONOLITHIC, BASIC_CHIPLET, AI_OPTIMIZED, POOR_INTEGRATION)
}

# Order used throughout benchmarks/plots (matches the paper's tables).
SCENARIO_ORDER = ("monolithic", "basic_chiplet", "ai_optimized", "poor_integration")


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from e
