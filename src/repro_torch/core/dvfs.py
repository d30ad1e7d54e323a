"""I1 — Adaptive cross-chiplet DVFS controller (port of `repro/core/dvfs.py`).

Per-chiplet voltage islands driven by on-chip regulators permit nanosecond-scale
P-state changes; the controller is therefore evaluated every simulator tick:

  1. *Workload-phase prediction*: an EMA of each chiplet's load demand predicts
     the next phase.
  2. *Per-chiplet P-state selection*: the lowest voltage/frequency level whose
     throughput covers the predicted demand.
  3. *Cross-chiplet power redistribution*: over the SoC power budget the
     least-loaded chiplets give up levels first; with headroom the most-loaded
     chiplets are boosted.

`step` takes any leading batch axes, chiplets on the last axis; config fields
may be tensors of per-design values over the same batch axes. Its f32
arithmetic rounds as the reference's compiled tick does (`rounding`): the
P-state choice compares against exact thresholds, so one ulp moves a level.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core._batch import constant, flag, sum_last
from repro_torch.rounding import const, fma, recip


@dataclasses.dataclass(frozen=True)
class DVFSConfig:
    """P-state table + controller gains.

    `voltages`/`freqs` are normalized to the nominal operating point (1.0, 1.0).
    Dynamic power scales ~ v^2 * f; throughput scales ~ f.
    """

    voltages: Tuple[float, ...] = (0.70, 0.76, 0.82, 0.88, 0.94, 1.00, 1.05, 1.10)
    freqs: Tuple[float, ...] = (0.50, 0.60, 0.70, 0.80, 0.90, 1.00, 1.05, 1.10)
    ema_decay: float = 0.8          # phase-prediction smoothing
    power_budget_mw: float = 1100.0  # SoC-level budget the controller enforces
    guard_band: float = 0.05         # demand margin when picking a P-state
    adaptive: bool = True            # False = fixed nominal state (basic chiplet)

    @property
    def n_levels(self) -> int:
        return len(self.voltages)

    def tables(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        device = resolve_device(device)
        return (constant(tuple(self.voltages), device),
                constant(tuple(self.freqs), device))


@dataclasses.dataclass
class DVFSState:
    level: torch.Tensor       # (..., n_chiplets) int32 current P-state index
    load_ema: torch.Tensor    # (..., n_chiplets) f32 predicted normalized demand
    energy_mj: torch.Tensor   # (...,) f32 accumulated dynamic energy


def uniform_power_model(n_chiplets: int, peak_dyn_mw: float = 400.0,
                        static_mw: float = 40.0, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chiplet power-model arrays for a fleet of identical NPU chiplets."""
    device = resolve_device(device)
    return (torch.full((n_chiplets,), peak_dyn_mw, dtype=torch.float32,
                       device=device),
            torch.full((n_chiplets,), static_mw, dtype=torch.float32,
                       device=device))


def init_state(n_chiplets: int, cfg: DVFSConfig, shape=(),
               device=None) -> DVFSState:
    """Every chiplet at the nominal P-state; `shape` is the batch shape."""
    device = resolve_device(device)
    nominal = min(range(len(cfg.freqs)), key=lambda i: abs(cfg.freqs[i] - 1.0))
    return DVFSState(
        level=torch.full((*shape, n_chiplets), nominal, dtype=torch.int32,
                         device=device),
        load_ema=torch.zeros((*shape, n_chiplets), dtype=torch.float32,
                             device=device),
        energy_mj=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _chiplet_power(idx, util, peak_dyn_mw, static_mw, volts, freqs):
    """static + peak·util·v·v·f at P-states `idx` (int64), the last product
    fused into the add."""
    v = volts[idx]
    return fma(peak_dyn_mw * util * v * v, freqs[idx], static_mw)


def _util(load_demand, f):
    return torch.clamp(load_demand / torch.clamp(f, min=1e-6), 0.0, 1.0)


def step(
    state: DVFSState,
    load_demand: torch.Tensor,
    cfg: DVFSConfig,
    peak_dyn_mw: torch.Tensor,
    static_mw: torch.Tensor,
    tick_ms: float,
) -> Tuple[DVFSState, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One controller tick.

    Args:
      load_demand: (..., n_chiplets) normalized demand in [0, +inf) — fraction
        of nominal-clock throughput each chiplet must deliver this tick.
      peak_dyn_mw / static_mw: (..., n_chiplets) power model per chiplet.

    Returns (new_state, (freq_scale, power_mw, util)), each (..., n_chiplets).
    """
    dev = load_demand.device
    volts, freqs = cfg.tables(dev)
    # `adaptive` and the budget may be per-design tensors or Python values,
    # lined up here against the chiplet axis; both P-state policies are
    # computed branchlessly and selected.
    adaptive = flag(cfg.adaptive, dev)[..., None]
    budget = torch.as_tensor(cfg.power_budget_mw, dtype=torch.float32,
                             device=dev)[..., None]
    ema = fma(cfg.ema_decay, state.load_ema,
              (1.0 - cfg.ema_decay) * load_demand)
    predicted = ema * (1.0 + cfg.guard_band)

    # Minimal level whose frequency covers predicted demand: freqs is
    # sorted ascending, so take the first True (argmax of a 0/1 cast, which
    # returns the first maximum). Non-adaptive controllers hold the state.
    ok = freqs >= torch.minimum(predicted, freqs[-1])[..., None]
    level = torch.where(adaptive,
                        torch.argmax(ok.to(torch.uint8), dim=-1).to(torch.int32),
                        state.level)

    idx = level.long()
    util = _util(load_demand, freqs[idx])
    power = _chiplet_power(idx, util, peak_dyn_mw, static_mw, volts, freqs)

    # --- cross-chiplet redistribution (adaptive controllers only) -----------
    total = sum_last(power)[..., None]
    over = total > budget
    # Over budget: scale every chiplet's dynamic-power knob v²·f so the
    # fleet lands on the budget, idle chiplets giving up levels first.
    g = volts * volts * freqs                       # (n_levels,) ascending
    static_total = sum_last(static_mw)[..., None]
    dyn_total = torch.clamp(total - static_total, min=1e-6)
    scale_dyn = torch.clamp((budget - static_total) / dyn_total, 0.05, 1.0)
    idle_rank = 1.0 - torch.clamp(ema, 0.0, 1.0)
    per_chip_scale = scale_dyn * fma(-0.5, idle_rank, 1.0)
    g_target = g[idx] * per_chip_scale
    ok_g = g <= g_target[..., None]
    level_budget = torch.clamp(ok_g.sum(dim=-1, dtype=torch.int32) - 1, min=0)
    # Boost: spend headroom on the busiest chiplets. Budget fraction unused
    # -> up to +1 level for loaded dies.
    headroom = torch.clamp(1.0 - total / budget, 0.0, 1.0)
    up = ((~over) & (ema > 0.7) & (headroom > 0.08)).to(torch.int32)
    redist = torch.where(over, torch.minimum(level, level_budget), level + up)
    redist = torch.clamp(redist, 0, cfg.n_levels - 1)
    level = torch.where(adaptive, redist, level)
    idx = level.long()
    freq = freqs[idx]
    util = _util(load_demand, freq)
    power = _chiplet_power(idx, util, peak_dyn_mw, static_mw, volts, freqs)

    new_state = DVFSState(
        level=level,
        load_ema=ema,
        energy_mj=fma(sum_last(power), const(tick_ms, recip(1000.0)),
                      state.energy_mj),
    )
    return new_state, (freq, power, util)
