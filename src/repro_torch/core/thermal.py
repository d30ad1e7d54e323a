"""I4 — RC thermal network + sensor-driven predictive load migration (port of
`repro/core/thermal.py`).

Each chiplet is one RC node (Cauer-style compact model):

    C_i dT_i/dt = P_i - (T_i - T_amb)/R_i + sum_j G_ij (T_j - T_i)

with G the uniform interposer lateral-coupling conductance. Forward-Euler
integration per simulator tick (0.1 ms, far below R*C ~ 10-100 ms).

The paper's predictive policy: per-chiplet sensors extrapolate T over a horizon
h; when an NPU's *predicted* temperature crosses T_migrate, a fraction of its
load shifts to the coolest NPU chiplet *before* any derating is needed.
Reactive designs instead clip the clock once T crosses T_throttle.

Every function takes leading batch axes, chiplets on the last axis; config
fields may be per-design tensors. The arithmetic rounds as the reference's
compiled tick does (`rounding`), since migration and throttling compare
temperatures against exact trip points.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core._batch import constant, flag, sum_last
from repro_torch.rounding import fma, recip


@dataclasses.dataclass(frozen=True)
class ThermalConfig:
    r_k_per_w: Tuple[float, ...]       # per-chiplet junction->ambient resistance
    c_j_per_k: Tuple[float, ...]       # per-chiplet thermal capacitance
    coupling_w_per_k: float = 0.05     # lateral interposer conductance (uniform)
    t_ambient_c: float = 45.0
    t_throttle_c: float = 95.0         # reactive derating point
    t_critical_c: float = 105.0
    t_migrate_c: float = 88.0          # predictive migration point
    predict_horizon_ms: float = 5.0
    migrate_fraction: float = 0.25     # load moved per migration event
    predictive: bool = True            # False = reactive throttling only

    def arrays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(r, c): the per-chiplet tuples as f32 tensors, or the per-design
        tensors they hold in a batched sweep."""
        def arr(x):
            if isinstance(x, torch.Tensor):
                return x
            return constant(tuple(x), resolve_device(device))
        return arr(self.r_k_per_w), arr(self.c_j_per_k)


@dataclasses.dataclass
class ThermalState:
    temp_c: torch.Tensor          # (..., n_chiplets)
    migrations: torch.Tensor      # (...,) int32 cumulative migration events
    throttle_ticks: torch.Tensor  # (...,) int32 ticks spent derated


def init_state(cfg: ThermalConfig, shape=(), device=None) -> ThermalState:
    device = resolve_device(device)
    n = len(cfg.r_k_per_w) if not isinstance(cfg.r_k_per_w, torch.Tensor) \
        else cfg.r_k_per_w.shape[-1]
    return ThermalState(
        temp_c=torch.full((*shape, n), cfg.t_ambient_c, dtype=torch.float32,
                          device=device),
        migrations=torch.zeros(shape, dtype=torch.int32, device=device),
        throttle_ticks=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def _dTdt(temp: torch.Tensor, power_mw: torch.Tensor,
          cfg: ThermalConfig) -> torch.Tensor:
    """dT/dt in K/s from power in mW: ((P - (T - T_amb)/R) + G·(ΣT - n·T))/C,
    with the mW→W scale and both products fused into the adds."""
    r, c = cfg.arrays(temp.device)
    n = temp.shape[-1]
    total = sum_last(temp)[..., None]
    lateral_sum = fma(-float(n), temp, total)          # ΣT - n·T
    heat = fma(power_mw, recip(1e3), -((temp - cfg.t_ambient_c) / r))
    return fma(cfg.coupling_w_per_k, lateral_sum, heat) / c


def predict(state: ThermalState, power_mw: torch.Tensor, cfg: ThermalConfig,
            tick_ms: float) -> torch.Tensor:
    """Per-chiplet SENSOR reading: next-tick temperature plus the linear
    extrapolation over the predictive horizon — the value the migration
    policy acts on, without advancing the RC state."""
    deriv = _dTdt(state.temp_c, power_mw, cfg)
    temp = fma(deriv, tick_ms / 1e3, state.temp_c)
    return fma(deriv, cfg.predict_horizon_ms / 1e3, temp)


def step(
    state: ThermalState,
    power_mw: torch.Tensor,
    npu_mask: torch.Tensor,
    npu_load: torch.Tensor,
    cfg: ThermalConfig,
    tick_ms: float,
) -> Tuple[ThermalState, Tuple[torch.Tensor, torch.Tensor]]:
    """One thermal tick.

    Args:
      power_mw: (..., n) per-chiplet power this tick.
      npu_mask: (n,) bool — which chiplets are NPUs (migration candidates).
      npu_load: (..., n) current normalized load per chiplet.

    Returns (state, (clock_scale, new_npu_load)):
      clock_scale: (..., n) thermal derating multiplier in (0, 1];
      new_npu_load: (..., n) load after any predictive migration.
    """
    dev = power_mw.device
    deriv = _dTdt(state.temp_c, power_mw, cfg)
    temp = fma(deriv, tick_ms / 1e3, state.temp_c)

    # --- predictive migration (I4) -------------------------------------------
    predicted = fma(deriv, cfg.predict_horizon_ms / 1e3, temp)
    hot = npu_mask & (predicted > cfg.t_migrate_c) & (npu_load > 0.0)
    any_hot = hot.any(dim=-1) & flag(cfg.predictive, dev)
    # Donor: hottest loaded NPU. Receiver: coolest NPU (the same if only
    # one); both take the first index on a tie, as the reference's do.
    inf = constant(float("inf"), dev)
    donor = torch.argmax(torch.where(hot, predicted, -inf), dim=-1,
                         keepdim=True)
    receiver = torch.argmin(torch.where(npu_mask, predicted, inf), dim=-1,
                            keepdim=True)
    do_migrate = any_hot & (receiver != donor)[..., 0]
    moved = torch.where(do_migrate[..., None],
                        torch.gather(npu_load, -1, donor) * cfg.migrate_fraction,
                        0.0)
    idx = constant(tuple(range(npu_load.shape[-1])), dev, torch.int64)
    new_load = torch.where(idx == donor, npu_load - moved, npu_load)
    new_load = torch.where(idx == receiver, new_load + moved, new_load)

    # --- reactive derating (what basic/poor integration fall back to) --------
    over = torch.clamp(
        (temp - cfg.t_throttle_c) * recip(cfg.t_critical_c - cfg.t_throttle_c),
        0.0,
        1.0,
    )
    clock_scale = fma(-0.5, over, 1.0)  # linear derate, floor at 0.5x
    throttled = (over > 0.0).any(dim=-1)

    return (
        ThermalState(
            temp_c=temp,
            migrations=state.migrations + do_migrate.to(torch.int32),
            throttle_ticks=state.throttle_ticks + throttled.to(torch.int32),
        ),
        (clock_scale, new_load),
    )
