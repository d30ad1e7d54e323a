"""Elastic runtime: heartbeats, straggler governor, failure handling.

A copy of `repro/train/elastic.py` (pure Python): the port imports nothing
of the JAX package, not even its dependency-free modules.

Paper tie-in (I4): the SoC migrates load off a hot NPU chiplet before it
throttles, driven by sensor prediction. At pod scale the "sensors" are
per-step telemetry (step walltime, per-host heartbeat age) and "migration"
is (a) re-balancing work away from stragglers and (b) elastic re-shard from
the latest checkpoint when a host is declared dead.

Everything here is deliberately dependency-free and unit-testable: the
policies are pure functions over telemetry dataclasses; `launch/train.py`
wires them to the real loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times_s: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True

    def record_step(self, t: float, now: Optional[float] = None):
        self.step_times_s.append(t)
        if len(self.step_times_s) > 64:
            self.step_times_s.pop(0)
        self.last_heartbeat = now if now is not None else time.time()


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    heartbeat_timeout_s: float = 60.0
    straggler_ratio: float = 1.5      # step time vs fleet median
    straggler_patience: int = 8       # consecutive slow steps before action
    min_hosts: int = 1


class HeartbeatRegistry:
    """Failure detector: hosts that stop heartbeating are declared dead."""

    def __init__(self, n_hosts: int, policy: ElasticPolicy = ElasticPolicy()):
        now = time.time()
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}
        self.policy = policy

    def beat(self, host_id: int, step_time_s: Optional[float] = None,
             now: Optional[float] = None):
        h = self.hosts[host_id]
        now = now if now is not None else time.time()
        h.last_heartbeat = now
        if step_time_s is not None:
            h.record_step(step_time_s, now)

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [i for i, h in self.hosts.items()
                if h.alive and now - h.last_heartbeat > self.policy.heartbeat_timeout_s]

    def mark_dead(self, host_id: int):
        self.hosts[host_id].alive = False

    def alive_count(self) -> int:
        return sum(h.alive for h in self.hosts.values())


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def detect_stragglers(registry: HeartbeatRegistry) -> List[int]:
    """I4 'sensor-driven prediction': hosts persistently slower than the
    fleet median by straggler_ratio."""
    p = registry.policy
    recents = {i: h.step_times_s[-p.straggler_patience:]
               for i, h in registry.hosts.items()
               if h.alive and len(h.step_times_s) >= p.straggler_patience}
    if len(recents) < 2:
        return []
    med = median([median(v) for v in recents.values()])
    if med <= 0:
        return []
    return [i for i, v in recents.items()
            if all(t > p.straggler_ratio * med for t in v)]


@dataclasses.dataclass(frozen=True)
class MigrationDecision:
    kind: str                 # none | rebalance | reshard
    drop_hosts: Tuple[int, ...] = ()
    reason: str = ""


def plan_migration(registry: HeartbeatRegistry,
                   now: Optional[float] = None) -> MigrationDecision:
    """The I4 policy: dead host → elastic reshard; persistent straggler →
    rebalance (drop it from the data-parallel group until it recovers)."""
    dead = registry.dead_hosts(now)
    if dead:
        if registry.alive_count() - len(dead) < registry.policy.min_hosts:
            return MigrationDecision(
                "none", reason=f"hosts {dead} dead but below min_hosts")
        return MigrationDecision("reshard", tuple(dead),
                                 f"heartbeat timeout on hosts {dead}")
    slow = detect_stragglers(registry)
    if slow:
        return MigrationDecision("rebalance", tuple(slow),
                                 f"stragglers {slow} > "
                                 f"{registry.policy.straggler_ratio}× median")
    return MigrationDecision("none")


def elastic_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid on the surviving devices (model fixed)."""
    assert n_devices >= model_parallel
    data = n_devices // model_parallel
    return data, model_parallel


def rebalanced_batch_split(global_batch: int, weights: Dict[int, float]
                           ) -> Dict[int, int]:
    """Work-proportional microbatch split (straggler gets less), summing to
    the global batch. weights: host → relative speed (1/median step time)."""
    total = sum(weights.values())
    raw = {h: global_batch * w / total for h, w in weights.items()}
    out = {h: int(math.floor(r)) for h, r in raw.items()}
    rem = global_batch - sum(out.values())
    for h, _ in sorted(raw.items(), key=lambda kv: kv[1] - math.floor(kv[1]),
                       reverse=True)[:rem]:
        out[h] += 1
    return out
