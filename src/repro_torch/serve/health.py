"""Per-shard health state machine driven by chiplet sensor readings (port of
`repro/serve/health.py`).

Each shard (one NPU chiplet) is one RC node in `core/thermal`'s compact
model; its serving occupancy rides through `core/dvfs`'s P-state controller
as the load demand, and the resulting *predicted* temperature
(`core/thermal.predict`, the extrapolated reading the simulator's migration
policy uses) drives a five-state machine:

    HEALTHY ──hot──▶ DEGRADED ──sustained hot──▶ DRAINING ─┐
       ▲                 │cool                      │      │death
       │                 ▼                          ▼      ▼
       └──cooldown── REJOINING ◀──rejoin fault──── DEAD ◀──┘

  * HEALTHY   — in placement.
  * DEGRADED  — sensor hot: new admissions avoid the shard, existing slots
    keep decoding. Cools back to HEALTHY.
  * DRAINING  — sustained hot: the shard's live slots re-home elsewhere;
    once cool, the shard returns to HEALTHY through REJOINING's cooldown.
  * DEAD      — hard failure (fault-injected); inert until a rejoin event.
  * REJOINING — free list reset; after `rejoin_ticks` the shard re-enters
    placement.

Transitions are deterministic functions of (occupancy history, injected
sensor biases): the sensor step runs the ported `core.dvfs` / `core.thermal`
tick on the monitor's device, so a seeded `FaultPlan` replays the same
transition schedule, and the schedule equals the reference monitor's. The
engine that reacts to DRAINING/DEAD (the sharded engine) is ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import thermal as thermal_mod


class Health(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DRAINING = "draining"
    DEAD = "dead"
    REJOINING = "rejoining"


# states the scheduler may place new work on
PLACEABLE = (Health.HEALTHY,)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    degrade_after: int = 1     # consecutive hot sensor ticks → DEGRADED
    drain_after: int = 3       # consecutive hot ticks → DRAINING (migrate off)
    cool_after: int = 2        # consecutive cool ticks → leave DEGRADED/DRAINING
    rejoin_ticks: int = 2      # REJOINING dwell before placement resumes
    tick_ms: float = 1.0       # engine tick, for the RC/DVFS integration
    # power model per shard-chiplet: full serving occupancy stays below
    # t_migrate without an injected sensor fault
    peak_dyn_mw: float = 400.0
    static_mw: float = 40.0
    r_k_per_w: float = 60.0    # junction->ambient resistance per chiplet
    c_j_per_k: float = 0.005


class ShardHealthMonitor:
    """Holds the per-shard thermal/DVFS state and the health machine.

    `step(occupancy)` advances one engine tick and returns the transitions
    that fired; `placeable()` is what a scheduler reads. `device=None`
    means CUDA, as everywhere in the port; the CPU tests pass "cpu"."""

    def __init__(self, n_shards: int, cfg: Optional[HealthConfig] = None,
                 device=None):
        self.n = n_shards
        self.cfg = cfg or HealthConfig()
        self.device = resolve_device(device)
        self.state: List[Health] = [Health.HEALTHY] * n_shards
        self._hot = np.zeros((n_shards,), np.int32)   # consecutive hot ticks
        self._cool = np.zeros((n_shards,), np.int32)  # consecutive cool ticks
        self._rejoin_at: Dict[int, int] = {}          # shard -> healthy tick
        self._bias_c = np.zeros((n_shards,), np.float64)
        self._bias_until = np.zeros((n_shards,), np.int64)
        self._tick = 0
        c, dev = self.cfg, self.device
        self._tcfg = thermal_mod.ThermalConfig(
            r_k_per_w=(c.r_k_per_w,) * n_shards,
            c_j_per_k=(c.c_j_per_k,) * n_shards)
        self._dcfg = dvfs_mod.DVFSConfig()
        self._tstate = thermal_mod.init_state(self._tcfg, device=dev)
        self._dstate = dvfs_mod.init_state(n_shards, self._dcfg, device=dev)
        self._peak, self._static = dvfs_mod.uniform_power_model(
            n_shards, c.peak_dyn_mw, c.static_mw, device=dev)
        self._npu_mask = torch.ones((n_shards,), dtype=torch.bool, device=dev)
        self.sensor_c = np.full((n_shards,), self._tcfg.t_ambient_c)
        self.clock_scale = np.ones((n_shards,))

    def _sense(self, load: torch.Tensor):
        """occupancy → P-state/power (core/dvfs) → RC node heat and the
        extrapolated sensor reading (core/thermal.predict)."""
        c = self.cfg
        self._dstate, (freq, power_mw, _) = dvfs_mod.step(
            self._dstate, load, self._dcfg, self._peak, self._static,
            c.tick_ms)
        predicted = thermal_mod.predict(self._tstate, power_mw, self._tcfg,
                                        c.tick_ms)
        self._tstate, (clock, _) = thermal_mod.step(
            self._tstate, power_mw, self._npu_mask, load, self._tcfg,
            c.tick_ms)
        return predicted, freq * clock

    # --------------------------------------------------------------- injection
    def inject_sensor(self, shard: int, delta_c: float, ticks: int) -> None:
        """A hot/stuck sensor: bias the shard's reading for `ticks` ticks."""
        self._bias_c[shard] = delta_c
        self._bias_until[shard] = self._tick + max(1, ticks)

    def force_dead(self, shard: int) -> bool:
        """Hard shard failure. Returns True if the shard held recoverable
        state (was not already dead)."""
        was = self.state[shard]
        self.state[shard] = Health.DEAD
        self._hot[shard] = self._cool[shard] = 0
        return was != Health.DEAD

    def begin_rejoin(self, shard: int) -> bool:
        """Dead shard comes back: REJOINING for `rejoin_ticks`, then
        HEALTHY. No-op unless the shard is DEAD."""
        if self.state[shard] != Health.DEAD:
            return False
        self.state[shard] = Health.REJOINING
        self._rejoin_at[shard] = self._tick + self.cfg.rejoin_ticks
        return True

    # -------------------------------------------------------------------- step
    def step(self, occupancy: np.ndarray) -> List[Tuple[int, Health, Health]]:
        """One tick: integrate sensors from per-shard occupancy, then run
        the state machine. Returns [(shard, old, new)] transitions."""
        self._tick += 1
        load = torch.as_tensor(np.clip(occupancy, 0.0, 1.0),
                               dtype=torch.float32).to(self.device)
        predicted, clock = self._sense(load)
        bias = np.where(self._bias_until >= self._tick, self._bias_c, 0.0)
        self.sensor_c = predicted.cpu().numpy().astype(np.float64) + bias
        self.clock_scale = clock.cpu().numpy().astype(np.float64)
        hot = self.sensor_c > self._tcfg.t_migrate_c
        self._hot = np.where(hot, self._hot + 1, 0).astype(np.int32)
        self._cool = np.where(~hot, self._cool + 1, 0).astype(np.int32)

        out: List[Tuple[int, Health, Health]] = []

        def move(shard: int, new: Health):
            out.append((shard, self.state[shard], new))
            self.state[shard] = new

        cfg = self.cfg
        for s in range(self.n):
            st = self.state[s]
            if st == Health.HEALTHY and self._hot[s] >= cfg.degrade_after:
                move(s, Health.DEGRADED)
                st = Health.DEGRADED
            if st == Health.DEGRADED:
                if self._hot[s] >= cfg.drain_after:
                    move(s, Health.DRAINING)
                elif self._cool[s] >= cfg.cool_after:
                    move(s, Health.HEALTHY)
            elif st == Health.DRAINING:
                if self._cool[s] >= cfg.cool_after:
                    # drained and cool: come back through the rejoin cooldown
                    move(s, Health.REJOINING)
                    self._rejoin_at[s] = self._tick + cfg.rejoin_ticks
            elif st == Health.REJOINING \
                    and self._tick >= self._rejoin_at.get(s, self._tick):
                move(s, Health.HEALTHY)
        return out

    # ------------------------------------------------------------------- views
    def placeable(self) -> List[bool]:
        return [st in PLACEABLE for st in self.state]

    def n_placeable(self) -> int:
        return sum(self.placeable())

    def summary(self) -> Dict[str, object]:
        return {"state": [st.value for st in self.state],
                "sensor_c": [round(float(t), 2) for t in self.sensor_c],
                "clock_scale": [round(float(s), 3)
                                for s in self.clock_scale]}
