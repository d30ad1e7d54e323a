"""Live cross-shard KV page migration over the compression-aware UCIe link
(port of `repro/serve/migration.py`): the host-side planner.

Recovery by re-prefill replay is correct and token-exact but recomputes
prefill, O(FLOPs) in the prompt length. The paper's sensor-driven load
migration moves STATE over the die-to-die link instead, at O(bytes) and the
UCIe's transfer cost. The device side is `serve/sharded`'s move program
(`models.transformer.gather_pool_pages` / `set_pool_page`); the host
bookkeeping re-homes atomically in `ShardScheduler.migrate_slot`.

Three triggers share the one primitive:

  * **drain**: a DRAINING shard's live slots re-home instead of being
    released and replayed (DEAD shards still replay: their bytes are
    gone).
  * **rebalance**: when the queue head starves on one shard while another
    idles, or the busy-slot gap between shards exceeds
    `rebalance_threshold`, a young decoding slot moves.
  * **prefix replication**: a registry hit that exists only on a remote
    shard copies the hot prefix's pages instead of re-prefilling them
    (guarded by `min_prefix_hits`).

Exactness: the data path moves POOL-NATIVE bytes, verbatim. An int8 pool's
int8 rows and f16 scale rows are its block-compressed wire format (half
the bf16 bytes), so migrated pages stay bit-exact; float pools move their
float bytes unchanged. `UCIeConfig.compression_ratio` prices compression in
the cost model only.

Cost model: `migration_cost` charges every move through `core/ucie`'s
`transfer()` closed form, the function the SoC simulator drains its link
through; `ucie.migration_ticks` turns its time into engine ticks, and the
engine holds a migrated slot for that long before its next step. The
serving code owns no link math of its own. The cost is host policy and is
computed on the CPU, whatever device serves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core import ucie
from repro_torch.serve.engine import prefix_digests


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs of the migration planner.

    `tick_us` maps link time onto engine ticks (1 tick = 1 ms, the scale
    `serve/health.HealthConfig.tick_ms` integrates the sensors at).
    `rebalance_threshold` is the busy-slot gap that triggers an elastic
    move; 0 turns rebalancing off (drain migration stays on: it replaces a
    strictly more expensive replay)."""
    ucie: ucie.UCIeConfig = dataclasses.field(default_factory=ucie.UCIeConfig)
    tick_us: float = 1000.0
    wave_moves: int = 4              # pages a shard sends or takes a wave
    rebalance_threshold: int = 0
    min_prefix_hits: int = 2         # replication guard: prefix hotness


def page_payload_bytes(pools) -> int:
    """Bytes ONE physical page occupies across every pool tensor (the page
    axis is axis 1). Pool-native: an int8 pool counts its int8 rows and f16
    scales, about half a bf16 pool's bytes."""
    return int(sum(x.numel() // x.shape[1] * x.element_size()
                   for x in pools.values()))


def migration_cost(payload_bytes: float,
                   cfg: MigrationConfig) -> Tuple[int, float]:
    """(hold_ticks, wire_bytes) of one migration transfer, both from
    `core/ucie.transfer`'s closed form (through `ucie.migration_ticks`)."""
    ticks = ucie.migration_ticks(payload_bytes, cfg.ucie, tick_us=cfg.tick_us,
                                 device="cpu")
    _, _, wire = ucie.transfer(
        torch.tensor(float(payload_bytes), dtype=torch.float32), cfg.ucie)
    return ticks, float(wire)


# --------------------------------------------------------------- planners
#
# Pure policy over ShardScheduler state: each returns WHAT to move; the
# engine moves it (device waves, `migrate_slot`, the hold). `movable(shard,
# slot)` is the engine's veto (decoding, not held, not mid-prefill), so the
# policy here never needs the engine's tick state.

def plan_rebalance(sched, threshold: int, placeable: List[bool],
                   movable: Callable[[int, int], bool]
                   ) -> Optional[Tuple[int, int, int]]:
    """One busy-gap move: when a shard runs more than `threshold` live
    slots above the idlest placeable shard, its youngest movable slot
    re-homes there. Deterministic (most busy, then the youngest rid; least
    busy, then lowest id as destination). Returns (src_shard, src_slot,
    dst_shard)."""
    if threshold <= 0:
        return None
    busy = [sum(r is not None for r in s.slots) for s in sched.shards]
    dst = None
    for i, s in enumerate(sched.shards):
        if not placeable[i] or None not in s.slots:
            continue
        if dst is None or (busy[i], i) < (busy[dst], dst):
            dst = i
    if dst is None:
        return None
    best = None
    for i, s in enumerate(sched.shards):
        if i == dst or busy[i] - busy[dst] <= threshold:
            continue
        for slot, r in enumerate(s.slots):
            if r is None or slot in s.prefill_fifo or not movable(i, slot):
                continue
            if sched.shards[dst].allocatable() < len(s.slot_pages[slot]):
                continue
            key = (busy[i], r.rid)
            if best is None or key > best[0]:
                best = (key, i, slot)
    return None if best is None else (best[1], best[2], dst)


def plan_starvation_rescue(sched, need: int, placeable: List[bool],
                           movable: Callable[[int, int], bool]
                           ) -> Optional[Tuple[int, int, int]]:
    """Migration instead of preemption: a decoding slot whose re-homing
    (a) frees its source shard enough for the starved queue head to admit
    there (the victim's exclusive pages plus the shard's allocatable ones
    cover `need`, and its slot frees up) and (b) fits whole on another
    shard. The head admits without any decoded work thrown away;
    preemption stays the fallback. The victim is the youngest rid, as in
    `preempt_candidate`."""
    best = None
    for i, s in enumerate(sched.shards):
        if not placeable[i]:          # the head must admit on the source
            continue
        for slot, r in enumerate(s.slots):
            if r is None or slot in s.prefill_fifo or not movable(i, slot):
                continue
            exclusive = sum(1 for p in s.slot_pages[slot].values()
                            if s.ref[p] == 1)
            if exclusive + s.allocatable() < need:
                continue
            n_pages = len(s.slot_pages[slot])
            dst = None
            for k, d in enumerate(sched.shards):
                if k == i or not placeable[k] or None not in d.slots:
                    continue
                if d.allocatable() < n_pages:
                    continue
                busy_k = sum(x is not None for x in d.slots)
                key = (d.pages_in_use, busy_k, k)
                if dst is None or key < dst[0]:
                    dst = (key, k)
            if dst is None:
                continue
            if best is None or r.rid > best[0]:
                best = (r.rid, i, slot, dst[1])
    return None if best is None else (best[1], best[2], best[3])


def plan_prefix_replication(sched, r, cfg: MigrationConfig,
                            placeable: List[bool]
                            ) -> Optional[Tuple[int, int, List[bytes]]]:
    """Cross-shard prefix reuse: if the longest cached run of the queue
    head's prompt lives on a shard it cannot admit on, and the prefix is
    hot (`min_prefix_hits` admissions have hit its first page), copy the
    missing run onto the best admitting shard. Returns (src_shard,
    dst_shard, the digests to copy in chain order) or None."""
    if not sched.prefix_cache:
        return None
    lp = r.live_prompt()
    n_cand = lp.shape[0] // sched.page_size
    if n_cand == 0:
        return None
    digs = prefix_digests(lp, sched.page_size, n_cand, r.seed_digest)
    runs = []
    for s in sched.shards:
        n = 0
        while n < n_cand and digs[n] in s.by_hash:
            n += 1
        runs.append(n)
    local = [i for i in range(sched.n_shards)
             if placeable[i] and None in sched.shards[i].slots]
    if not local:
        return None
    dst = min(local, key=lambda i: (-runs[i], sched.shards[i].pages_in_use, i))
    src = min(range(sched.n_shards), key=lambda i: (-runs[i], i))
    gain = runs[src] - runs[dst]
    if gain <= 0:
        return None
    if sched.digest_hits.get(digs[0], 0) < cfg.min_prefix_hits:
        return None
    if sched.shards[dst].allocatable() < gain:
        return None
    return src, dst, digs[runs[dst]:runs[src]]
