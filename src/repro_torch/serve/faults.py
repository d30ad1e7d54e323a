"""Deterministic fault injection for the serving stack (port of
`repro/serve/faults.py`, its own copy: the port imports nothing of `repro`).

A `FaultPlan` is PURE DATA: a sorted tuple of `FaultEvent`s, each pinned to
an engine tick. The engine applies whatever events land on the current tick
at the tick boundary (before admission), so a plan replays bit-for-bit —
same plan + same traffic → the same event schedule, the same preemptions,
the same recoveries, and (the chaos-parity guarantee) the same emitted
tokens as the fault-free engine. Nothing in this module touches a clock or
an unseeded RNG.

Event kinds:
  * ``shard_death``  — the shard fails hard: every live slot it holds is
    recovered by re-prefill replay on a healthy shard (serve/health drives
    the state machine; serve/sharded performs the recovery) and the shard
    leaves placement until a ``shard_rejoin`` arrives.
  * ``shard_rejoin`` — the dead shard comes back: its free list resets and,
    after the health monitor's rejoin cooldown, it re-enters placement.
  * ``sensor_hot``   — a faulty/hot sensor reading: ``delta_c`` is added to
    the shard's predicted temperature (core/thermal's sensor extrapolation)
    for ``ticks`` ticks. Sustained hot readings walk the shard through
    DEGRADED → DRAINING. Unlike a death, a DRAINING shard's pool bytes are
    still alive, so its slots re-home by LIVE PAGE MIGRATION over the
    modeled UCIe link (serve/migration) — O(bytes), no re-prefill — with
    replay as the fallback when nothing can place them. This is the
    paper's §II sensor-driven load migration, at serving granularity.
  * ``page_squeeze`` — free-list exhaustion: up to ``pages`` pages vanish
    from the shard's free list (fragmentation / a co-tenant landing on the
    chiplet). Queued requests that can no longer reserve starve, which is
    what drives the engine's preemption-based backpressure.
  * ``page_restore`` — every page stolen from the shard so far returns.

The single-host engine honors the page events (its pool is "shard 0") and
ignores the shard-level ones; the reference's sharded engine honors all
five (its port, with serve/sharded and serve/migration, is ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

KINDS = ("shard_death", "shard_rejoin", "sensor_hot",
         "page_squeeze", "page_restore")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    tick: int                  # engine tick the event fires on (1-based)
    kind: str                  # one of KINDS
    shard: int = 0
    pages: int = 0             # page_squeeze: pages to steal
    delta_c: float = 0.0       # sensor_hot: sensor bias in °C
    ticks: int = 0             # sensor_hot: bias duration in ticks

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Replayable fault schedule. ``events`` is kept sorted by tick; the
    ``seed`` records provenance when the plan came from `chaos_plan`."""
    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.tick, e.shard,
                                                     KINDS.index(e.kind)))))
        by_tick: Dict[int, List[FaultEvent]] = {}
        for e in self.events:
            by_tick.setdefault(e.tick, []).append(e)
        object.__setattr__(self, "_by_tick", by_tick)

    def events_at(self, tick: int) -> List[FaultEvent]:
        return self._by_tick.get(tick, [])

    @property
    def max_tick(self) -> int:
        return self.events[-1].tick if self.events else 0

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS}
        for e in self.events:
            out[e.kind] += 1
        return out


def chaos_plan(seed: int, *, n_shards: int, n_ticks: int,
               deaths: int = 1, death_dwell: int = 8,
               squeezes: int = 3, squeeze_pages: int = 8,
               squeeze_dwell: int = 6,
               sensor_storms: int = 0, sensor_delta_c: float = 60.0,
               sensor_ticks: int = 6) -> FaultPlan:
    """Seeded chaos schedule: `deaths` death→rejoin pairs, `squeezes`
    page-steal→restore pairs and `sensor_storms` hot-sensor windows spread
    deterministically over ``n_ticks`` ticks.

    Pure function of its arguments — the same seed generates the same plan
    bit-for-bit (`FaultPlan` equality; tests pin it). At most ``n_shards-1``
    shards are ever dead at once, so the fleet always has somewhere to
    recover to."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if deaths and n_shards < 2:
        raise ValueError("shard deaths need >= 2 shards to recover onto")
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    dead_until: Dict[int, int] = {}        # shard -> rejoin tick

    def alive_at(tick: int) -> List[int]:
        return [s for s in range(n_shards)
                if not (s in dead_until and tick < dead_until[s])]

    for _ in range(deaths):
        t = int(rng.integers(2, max(3, n_ticks - death_dwell)))
        cands = [s for s in alive_at(t) if s in alive_at(t + death_dwell)]
        # keep a quorum: never kill the last-but-one live shard
        if len(cands) <= 1:
            continue
        shard = int(rng.choice(cands))
        events.append(FaultEvent(tick=t, kind="shard_death", shard=shard))
        events.append(FaultEvent(tick=t + death_dwell, kind="shard_rejoin",
                                 shard=shard))
        dead_until[shard] = t + death_dwell
    for _ in range(squeezes):
        t = int(rng.integers(2, max(3, n_ticks - squeeze_dwell)))
        shard = int(rng.integers(0, n_shards))
        events.append(FaultEvent(tick=t, kind="page_squeeze", shard=shard,
                                 pages=squeeze_pages))
        events.append(FaultEvent(tick=t + squeeze_dwell, kind="page_restore",
                                 shard=shard))
    for _ in range(sensor_storms):
        t = int(rng.integers(2, max(3, n_ticks - sensor_ticks)))
        shard = int(rng.integers(0, n_shards))
        events.append(FaultEvent(tick=t, kind="sensor_hot", shard=shard,
                                 delta_c=float(sensor_delta_c),
                                 ticks=sensor_ticks))
    return FaultPlan(events=tuple(events), seed=seed)
