"""Shard scheduler: admission, placement and prefill interleaving for the
sharded serving engine (port of `repro/serve/scheduler.py`, host-only
numpy and Python, as the reference's).

The single-host `ServeEngine` folds admission into the engine tick: one
free list, one FIFO of mid-prefill slots, one chunk per tick. Sharded
serving differs in three ways, and this object is where they live:

  * **Per-shard free lists.** Every shard owns a private page range
    (LOCAL page ids; page 0 is the shard's null page): a request's
    reservation comes from ONE shard's pool, so its page-table row stays
    inside its shard's range. The scheduler never mixes pages across
    shards.
  * **Least-loaded placement.** The queue head admits onto the shard with
    a free slot, enough allocatable pages and the least load (the longest
    cached run of its prompt first, then fewest pages in use, fewest busy
    slots, lowest shard id: a total order, so the same traffic schedules
    the same way run to run). Admission stays FIFO: if no shard can take
    the head, nothing overtakes it.
  * **Interleaved prefill.** Each shard advances AT MOST ONE chunk of its
    own oldest mid-prefill slot per engine tick, whatever the other shards
    do, so a long prompt on one shard never stalls decode on another.

Token streams do not depend on the schedule (a row does not depend on its
chunk, its batch or its shard), so none of these policies changes WHAT a
request generates, only when: the sharded engine gives the single-host
engine's tokens under another admission order.

Retirement at any stage (queued, mid-prefill, decoding) drains the slot's
chunk queue and returns every reserved page to its shard in one step.
Live migration (`migrate_slot`, `replicate_page`) re-homes a slot's or a
prefix's bookkeeping atomically; the engine moves the bytes.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import (
    Request, lookup_prefix_hits, page_row_of, prefix_digests,
    prefix_share_plan, recycle_dead_pages, register_prefix_pages,
    reserve_page_count, window_page_budget)


@dataclasses.dataclass
class ShardState:
    """Host bookkeeping of one shard's slots and page pool.

    The pool is ref-counted and content-addressed PER SHARD: page ids are
    local, so each shard keeps its own prefix registry and LRU, and a
    cached page is shared only by slots of the same shard (placement
    prefers the shard that holds the prefix). `pages_in_use` counts unique
    live pages (ref >= 1)."""
    free_pages: List[int]                 # LOCAL ids, 1..n_pages-1 (0 = null)
    slots: List[Optional[Request]]
    prefill_fifo: List[int]               # local slot ids mid-prefill, FIFO
    chunk_next: List[int]                 # next chunk start per local slot
    slot_pages: List[Dict[int, int]]      # logical page -> LOCAL physical
    slot_cap: List[int]                   # highest writable logical page (excl)
    pages_in_use: int = 0                 # unique pages with ref >= 1
    ref: Optional[np.ndarray] = None      # (n_pages,) int32 refcounts
    page_hash: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    by_hash: Dict[bytes, int] = dataclasses.field(default_factory=dict)
    # refcount-zero pages whose content is still registered: evictable,
    # oldest first
    lru: "OrderedDict[int, None]" = dataclasses.field(
        default_factory=OrderedDict)

    def allocatable(self) -> int:
        """Pages an admission can obtain: free + evictable cached."""
        return len(self.free_pages) + len(self.lru)


@dataclasses.dataclass
class ChunkWork:
    """One shard's prefill work for this tick."""
    shard: int
    slot: int                             # local slot id
    req: Request
    start: int                            # chunk's first global position
    length: int                           # real rows in this chunk
    final: bool                           # last chunk: slot goes live after


@dataclasses.dataclass
class Placement:
    """One admission decision, with its prefix-cache outcome: the COW tail
    clone for the engine to run, and whether the whole prompt was cached."""
    shard: int
    slot: int                             # local slot id
    req: Request
    cached_tokens: int = 0                # page-aligned tokens served cached
    cow: Optional[Tuple[int, int]] = None  # (src, dst) LOCAL page clone
    full_hit: bool = False                # whole prompt cached: zero chunks


class ShardScheduler:
    def __init__(self, *, n_shards: int, slots_per_shard: int, n_pages: int,
                 page_size: int, pages_per_seq: int, max_len: int,
                 chunk_tokens: int, window: int = 0,
                 prefix_cache: bool = True):
        assert n_pages >= 2, n_pages     # local null page + >= 1 usable
        self.n_shards = n_shards
        self.slots_per_shard = slots_per_shard
        self.n_pages = n_pages           # per shard, incl. the local null page
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.max_len = max_len
        self.chunk_tokens = chunk_tokens
        self.window = window
        # sliding-window recycling rewrites remapped pages in place, which
        # sharing cannot survive (the single-host engine's rule)
        self.prefix_cache = bool(prefix_cache) and not window
        # prefix-cache counters, mirrored into EngineStats by the engine
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        # digest -> admissions that hit it: the prefix-hotness signal the
        # cross-shard replication planner thresholds on
        self.digest_hits: Dict[bytes, int] = {}
        # digest -> rid of the live request prefilling it now; a queue head
        # whose first MISS digest is pending waits (without counting as page
        # starvation) instead of prefilling the same pages twice
        self.pending_digest: Dict[bytes, int] = {}
        self.pending_by_rid: Dict[int, List[bytes]] = {}
        self.queue: List[Request] = []
        self.shards = [
            ShardState(free_pages=list(range(n_pages - 1, 0, -1)),
                       slots=[None] * slots_per_shard,
                       prefill_fifo=[],
                       chunk_next=[0] * slots_per_shard,
                       slot_pages=[{} for _ in range(slots_per_shard)],
                       slot_cap=[0] * slots_per_shard,
                       ref=np.zeros((n_pages,), np.int32))
            for _ in range(n_shards)]
        # placement mask, driven by serve/health's state machine: only
        # HEALTHY shards take new admissions (the others keep their live
        # slots until the engine evacuates them)
        self.placeable: List[bool] = [True] * n_shards
        # pages stolen by page_squeeze faults, per shard, until restored
        self.stolen: List[List[int]] = [[] for _ in range(n_shards)]

    # ------------------------------------------------------------ reservation
    def _window_pages(self) -> int:
        return window_page_budget(self.window, self.page_size)

    def pages_for(self, plen: int, max_new: int) -> int:
        """Pages one request reserves at admission: the single-host chunked
        engine's `reserve_page_count` (the full span, or O(window))."""
        return reserve_page_count(plen, max_new, max_len=self.max_len,
                                  page_size=self.page_size,
                                  window=self.window)

    @property
    def pages_in_use(self) -> int:
        return sum(s.pages_in_use for s in self.shards)

    def shard_pages_in_use(self) -> List[int]:
        return [s.pages_in_use for s in self.shards]

    # --------------------------------------------- ref-counted page allocator
    def _unregister(self, s: ShardState, phys: int) -> None:
        h = s.page_hash.pop(phys, None)
        if h is not None and s.by_hash.get(h) == phys:
            del s.by_hash[h]

    def _alloc(self, s: ShardState) -> int:
        """One private page: pop the shard's free list, else evict its
        least recently used refcount-zero cached page."""
        if s.free_pages:
            p = s.free_pages.pop()
        else:
            p, _ = s.lru.popitem(last=False)     # oldest first
            self._unregister(s, p)
            self.prefix_evictions += 1
        s.ref[p] = 1
        s.pages_in_use += 1
        return p

    def _incref(self, s: ShardState, phys: int) -> None:
        if s.ref[phys] == 0:
            s.lru.pop(phys, None)    # back live: safe from eviction
            s.pages_in_use += 1
        s.ref[phys] += 1

    def _count_hit(self, s: ShardState, phys: int) -> None:
        """Count a hit on the digest behind a page: the signal
        `plan_prefix_replication` thresholds on."""
        h = s.page_hash.get(phys)
        if h is not None:
            self.digest_hits[h] = self.digest_hits.get(h, 0) + 1

    def _decref(self, s: ShardState, phys: int) -> None:
        s.ref[phys] -= 1
        assert s.ref[phys] >= 0, int(phys)
        if s.ref[phys] == 0:
            s.pages_in_use -= 1
            if self.prefix_cache and phys in s.page_hash:
                s.lru[phys] = None   # registered content parks in the LRU
            else:
                self._unregister(s, phys)
                s.free_pages.append(phys)

    def _hit_plan(self, s: ShardState, r: Request, lp, plen: int):
        """(hits, n_shared, cow_src, pinned) of placing `r` on shard `s`:
        the shard's cached run over the prompt, the share/COW split, and
        how many of those pages sit in the LRU (they leave the allocatable
        set when an admission increfs them)."""
        if not self.prefix_cache:
            return [], 0, None, 0
        hits = lookup_prefix_hits(s.by_hash, lp, self.page_size,
                                  seed=r.seed_digest)
        n_shared, cow_src = prefix_share_plan(plen, hits, self.page_size)
        pinned = sum(1 for p in hits[:n_shared] if s.ref[p] == 0)
        if cow_src is not None and s.ref[cow_src] == 0:
            pinned += 1
        return hits, n_shared, cow_src, pinned

    def register_prefix(self, shard: int, slot: int, r: Request) -> None:
        """Register a fully prefilled slot's full prompt pages in ITS
        shard's registry (the engine calls this when the slot goes live)."""
        self._clear_pending(r.rid)
        if not self.prefix_cache:
            return
        s = self.shards[shard]
        register_prefix_pages(s.slot_pages[slot], r.live_prompt(),
                              self.page_size, r.seed_digest,
                              s.page_hash, s.by_hash)

    def _clear_pending(self, rid: int) -> None:
        """Drop a request's in-flight claims: when its pages register
        (waiters hit them) or at any release (the prefill died; waiters
        prefill themselves)."""
        for d in self.pending_by_rid.pop(rid, ()):
            if self.pending_digest.get(d) == rid:
                del self.pending_digest[d]

    # -------------------------------------------------------------- placement
    def _eligible(self, need: int) -> Optional[int]:
        """Least-loaded placeable shard with a free slot and `need`
        allocatable (free + evictable cached) pages."""
        best = None
        for i, s in enumerate(self.shards):
            if not self.placeable[i]:
                continue
            if s.allocatable() < need or None not in s.slots:
                continue
            busy = sum(r is not None for r in s.slots)
            key = (s.pages_in_use, busy, i)
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def admit(self) -> List[Placement]:
        """Admit queued requests FIFO onto cache-aware least-loaded shards.

        Placement prefers the shard holding the longest cached run of the
        request's prompt (pages are shared only within a shard), then the
        least load. Pages are reserved and mapped on return (shared hits
        increfed, private pages allocated); each Placement carries the COW
        clone for the engine to run and the full-hit flag. Stops, without
        overtaking, when the head fits nowhere."""
        placed: List[Placement] = []
        pending_decref: List[Tuple[ShardState, int]] = []
        while self.queue:
            r = self.queue[0]
            # a resumed request (preempted, or recovered off a dead shard)
            # admits on prompt + emitted tokens and its remaining budget,
            # which reserve the pages it first reserved
            lp = r.live_prompt()
            plen = lp.shape[0]
            rem = r.remaining_new()
            need = self.pages_for(plen, rem)
            best = None
            for i, s in enumerate(self.shards):
                if not self.placeable[i] or None not in s.slots:
                    continue
                hits, n_shared, cow_src, pinned = self._hit_plan(
                    s, r, lp, plen)
                if s.allocatable() - pinned < need - n_shared:
                    continue
                busy = sum(x is not None for x in s.slots)
                cached = (n_shared + (cow_src is not None)) * self.page_size
                key = (-cached, s.pages_in_use, busy, i)
                if best is None or key < best[0]:
                    best = (key, i, hits, n_shared, cow_src, cached)
            if best is None:
                break
            _, shard, hits, n_shared, cow_src, cached = best
            s = self.shards[shard]
            # in-flight dedup: if the first page this request would prefill
            # is being prefilled by a live request now, wait; once that
            # prefill registers, this one hits its pages. Nothing overtakes
            # a waiting head, and the claim dies with its owner
            # (`_clear_pending` at release), so nothing deadlocks
            digs = None
            n_cand = plen // self.page_size if self.prefix_cache else 0
            if len(hits) < n_cand:
                digs = prefix_digests(lp, self.page_size, n_cand,
                                      r.seed_digest)
                owner = self.pending_digest.get(digs[len(hits)])
                if owner is not None and owner != r.rid:
                    break
            slot = s.slots.index(None)
            shared = hits[:n_shared]
            # protect the hit pages FIRST (incref takes them out of the
            # eviction set), then allocate the private ones; cow_src stays
            # pinned until the END of the admit wave, because the engine
            # clones it before any of this wave's pages are written
            for p in shared:
                self._incref(s, p)
                self._count_hit(s, p)
            cow = None
            if cow_src is not None:
                self._incref(s, cow_src)
                self._count_hit(s, cow_src)
                pending_decref.append((s, cow_src))
            pages = [self._alloc(s) for _ in range(need - n_shared)]
            if cow_src is not None:
                cow = (cow_src, pages[0])
                self.cow_copies += 1
            mapping = {j: p for j, p in enumerate(shared)}
            for k, p in enumerate(pages):
                mapping[n_shared + k] = p
            s.slot_pages[slot] = mapping
            s.slot_cap[slot] = -(-min(self.max_len, plen + rem)
                                 // self.page_size)
            s.slots[slot] = r
            r.cached_prompt_tokens = cached
            if self.prefix_cache:
                if cached:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += cached
                else:
                    self.prefix_misses += 1
            full = cached >= plen
            s.chunk_next[slot] = cached
            if full:
                # the whole prompt is pooled (shared run + COW'd tail): no
                # prefill chunks; register now, the engine puts the slot
                # live straight from this placement
                self.register_prefix(shard, slot, r)
            else:
                s.prefill_fifo.append(slot)
                if digs is not None:
                    # claim the full pages this prefill will register, so
                    # identical first misses wait for it
                    mine = self.pending_by_rid.setdefault(r.rid, [])
                    for d in digs[len(hits):]:
                        if d not in self.pending_digest:
                            self.pending_digest[d] = r.rid
                            mine.append(d)
            self.queue.pop(0)
            placed.append(Placement(shard=shard, slot=slot, req=r,
                                    cached_tokens=cached, cow=cow,
                                    full_hit=full))
        for s, p in pending_decref:
            self._decref(s, p)
        return placed

    # ---------------------------------------------------------------- prefill
    def next_chunks(self) -> List[ChunkWork]:
        """One chunk of work per shard that has any (oldest slot first): no
        shard's prefill costs another shard a tick."""
        work = []
        for i, s in enumerate(self.shards):
            if not s.prefill_fifo:
                continue
            slot = s.prefill_fifo[0]
            r = s.slots[slot]
            st = s.chunk_next[slot]
            plen = r.live_prompt().shape[0]
            if self.window and st:
                # recycle pages no chunk row >= st can read; the slot's
                # table row is still null, so this is host bookkeeping only
                self.recycle(i, slot, st)
            work.append(ChunkWork(
                shard=i, slot=slot, req=r, start=st,
                length=min(self.chunk_tokens, plen - st),
                final=st + self.chunk_tokens >= plen))
        return work

    def advance_chunk(self, w: ChunkWork) -> None:
        s = self.shards[w.shard]
        if w.final:
            s.prefill_fifo.pop(0)
        else:
            s.chunk_next[w.slot] = w.start + self.chunk_tokens

    def page_row(self, shard: int, slot: int):
        """The slot's (pages_per_seq,) LOCAL physical page row (null page 0
        beyond the mapping): what a chunk reads and, once the slot is live,
        its page-table row."""
        return page_row_of(self.shards[shard].slot_pages[slot],
                           self.pages_per_seq)

    # --------------------------------------------------------------- windowing
    def recycle(self, shard: int, slot: int, progress: int):
        """Free pages fully below `progress - window` (the single-host
        `recycle_dead_pages`) against this shard's free list. Returns
        [(j_dead, j_new, phys)] remaps and [j_dead] unmaps, for the engine
        to mirror into a live slot's page-table row."""
        s = self.shards[shard]
        remaps, unmaps = recycle_dead_pages(
            s.slot_pages[slot], s.slot_cap[slot],
            self.page_size, self.window, progress)
        for _, phys in unmaps:
            # window pages are owned by one slot (the prefix cache is off
            # under a window): the decref frees them
            self._decref(s, phys)
        return remaps, [j for j, _ in unmaps]

    # -------------------------------------------------------------- retirement
    def release(self, shard: int, slot: int) -> None:
        """Retire a slot at ANY stage: drain its chunk queue and drop one
        reference per mapped page. A shared page survives its releasing
        slot; it returns to the free list (or parks in the LRU if it is
        registered) at refcount zero."""
        s = self.shards[shard]
        if s.slots[slot] is not None:
            self._clear_pending(s.slots[slot].rid)
        s.slots[slot] = None
        if slot in s.prefill_fifo:
            s.prefill_fifo.remove(slot)
        s.chunk_next[slot] = 0
        freed = s.slot_pages[slot]
        if freed:
            for phys in freed.values():
                self._decref(s, phys)
            s.slot_pages[slot] = {}
        s.slot_cap[slot] = 0

    # -------------------------------------------------------- fault tolerance
    def steal_pages(self, shard: int, n: int) -> int:
        """page_squeeze fault: up to `n` pages vanish from the shard's free
        list, then from its refcount-zero cached LRU; never from live
        reservations. Returns the pages taken."""
        s = self.shards[shard]
        take = min(n, s.allocatable())
        for _ in range(take):
            if s.free_pages:
                p = s.free_pages.pop()
            else:
                p, _ = s.lru.popitem(last=False)
                self._unregister(s, p)
                self.prefix_evictions += 1
            self.stolen[shard].append(p)
        return take

    def restore_pages(self, shard: int) -> int:
        """page_restore fault: every page stolen from the shard returns."""
        s = self.shards[shard]
        n = len(self.stolen[shard])
        s.free_pages.extend(self.stolen[shard])
        self.stolen[shard].clear()
        return n

    def drain_shard(self, shard: int) -> List[Request]:
        """Evacuate a shard: release EVERY live slot and hand the displaced
        requests back, oldest first, for admission elsewhere."""
        s = self.shards[shard]
        live = [(slot, r) for slot, r in enumerate(s.slots) if r is not None]
        for slot, _ in live:
            self.release(shard, slot)
        return [r for _, r in sorted(live, key=lambda t: t[1].rid)]

    def reset_shard(self, shard: int) -> None:
        """Rejoining shard: its pool comes back fresh (full free list, no
        mappings, no stolen pages, no registry). Only on a drained shard."""
        s = self.shards[shard]
        assert all(r is None for r in s.slots), \
            f"reset of shard {shard} with live slots"
        s.free_pages = list(range(self.n_pages - 1, 0, -1))
        s.prefill_fifo = []
        s.chunk_next = [0] * self.slots_per_shard
        s.slot_pages = [{} for _ in range(self.slots_per_shard)]
        s.slot_cap = [0] * self.slots_per_shard
        s.pages_in_use = 0
        # the shard's pool bytes are gone: its prefix registry with them
        s.ref = np.zeros((self.n_pages,), np.int32)
        s.page_hash = {}
        s.by_hash = {}
        s.lru = OrderedDict()
        self.stolen[shard].clear()

    def requeue(self, reqs: List[Request]) -> None:
        """Re-enqueue displaced requests in rid order: each goes back where
        its age puts it, ahead of anything younger."""
        for r in reqs:
            i = 0
            while i < len(self.queue) and self.queue[i].rid < r.rid:
                i += 1
            self.queue.insert(i, r)

    # ---------------------------------------------------- live page migration
    def migration_target(self, src_shard: int, slot: int,
                         placeable: Optional[List[bool]] = None
                         ) -> Optional[int]:
        """Least-loaded placeable shard (never the source) with a free slot
        and enough allocatable pages for the slot's whole mapping: where a
        drained or rebalanced slot re-homes. None when nowhere fits (the
        caller falls back to release and re-prefill)."""
        mask = self.placeable if placeable is None else placeable
        need = len(self.shards[src_shard].slot_pages[slot])
        best = None
        for i, s in enumerate(self.shards):
            if i == src_shard or not mask[i]:
                continue
            if None not in s.slots or s.allocatable() < need:
                continue
            busy = sum(r is not None for r in s.slots)
            key = (s.pages_in_use, busy, i)
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def migrate_slot(self, src_shard: int, slot: int, dst_shard: int
                     ) -> Tuple[int, List[Tuple[int, int]]]:
        """Re-home ONE live slot's bookkeeping src -> dst atomically: a
        fresh destination page per mapped logical page, the mapping, slot
        cap, chunk cursor and prefill-FIFO membership carried over, the
        source references dropped (a shared source page survives through
        its other references; a registered one parks in the source LRU).

        A registered source page's digest registers on the destination too
        (the first registration wins): the copy is byte-exact, and that is
        how a hot prefix becomes visible to placement on another shard.
        Returns (dst_slot, [(src_phys, dst_phys)]) in LOCAL ids. The engine
        must move the bytes before any later allocation can reuse the freed
        source pages (it moves them at once)."""
        assert dst_shard != src_shard, src_shard
        ss, ds = self.shards[src_shard], self.shards[dst_shard]
        r = ss.slots[slot]
        assert r is not None, (src_shard, slot)
        dst_slot = ds.slots.index(None)
        moves: List[Tuple[int, int]] = []
        mapping: Dict[int, int] = {}
        for j in sorted(ss.slot_pages[slot]):
            src_phys = ss.slot_pages[slot][j]
            dst_phys = self._alloc(ds)
            moves.append((src_phys, dst_phys))
            mapping[j] = dst_phys
            h = ss.page_hash.get(src_phys)
            if self.prefix_cache and h is not None \
                    and h not in ds.by_hash and dst_phys not in ds.page_hash:
                ds.page_hash[dst_phys] = h
                ds.by_hash[h] = dst_phys
        ds.slot_pages[dst_slot] = mapping
        ds.slot_cap[dst_slot] = ss.slot_cap[slot]
        ds.chunk_next[dst_slot] = ss.chunk_next[slot]
        ds.slots[dst_slot] = r
        if slot in ss.prefill_fifo:   # mid-prefill: chunking resumes on dst
            ss.prefill_fifo.remove(slot)
            ds.prefill_fifo.append(dst_slot)
        ss.slots[slot] = None
        ss.chunk_next[slot] = 0
        old = ss.slot_pages[slot]
        ss.slot_pages[slot] = {}
        ss.slot_cap[slot] = 0
        for phys in old.values():
            self._decref(ss, phys)
        return dst_slot, moves

    def replicate_page(self, src_shard: int, dst_shard: int, digest: bytes
                       ) -> Optional[Tuple[int, int]]:
        """Cross-shard prefix replication: allocate a destination page for
        `digest` (registered on the source), register it and park it at
        refcount zero in the destination LRU; the admission that motivated
        the copy takes it through the normal hit path, and until then it is
        evictable like any cached page. Returns (src_phys, dst_phys) for the
        device move, or None if either side cannot."""
        ss, ds = self.shards[src_shard], self.shards[dst_shard]
        src_phys = ss.by_hash.get(digest)
        if src_phys is None or digest in ds.by_hash \
                or ds.allocatable() == 0:
            return None
        dst_phys = self._alloc(ds)
        ds.page_hash[dst_phys] = digest
        ds.by_hash[digest] = dst_phys
        self._decref(ds, dst_phys)
        return src_phys, dst_phys

    def page_starved(self, need: int) -> bool:
        """True when the head fits nowhere but a placeable shard exists:
        preempting a young decoding slot there can unblock it."""
        if self._eligible(need) is not None:
            return False
        return any(self.placeable)

    def preempt_candidate(self, need: int, head_rid: int,
                          max_preemptions: int) -> Optional[Tuple[int, int]]:
        """The YOUNGEST (max rid) decoding slot on a placeable shard that is
        strictly younger than the head, under its preemption budget, and
        whose release lets the shard take the head (its exclusive pages
        plus the shard's allocatable ones cover `need`). Strict rid order
        keeps progress monotone: no preemption livelock."""
        best = None
        for i, s in enumerate(self.shards):
            if not self.placeable[i]:
                continue
            for slot, r in enumerate(s.slots):
                if r is None or slot in s.prefill_fifo:
                    continue
                if r.rid <= head_rid or r.preemptions >= max_preemptions:
                    continue
                # only the victim's exclusively owned pages (ref 1) become
                # allocatable at release; shared ones drop a reference
                exclusive = sum(1 for p in s.slot_pages[slot].values()
                                if s.ref[p] == 1)
                if exclusive + s.allocatable() < need:
                    continue
                if best is None or r.rid > best[0]:
                    best = (r.rid, i, slot)
        return None if best is None else (best[1], best[2])

    def assert_accounting(self) -> None:
        """The ref-counted pool invariant: per shard, every non-null page is
        in EXACTLY one of {free list, live (mapped by >= 1 slot), cached
        LRU, stolen}, so free + uniquely mapped + cached + stolen ==
        n_pages - 1; the mapping references equal the refcounts, and
        `pages_in_use` equals the unique live count."""
        for i, s in enumerate(self.shards):
            free, lru = set(s.free_pages), set(s.lru)
            live = {p for m in s.slot_pages for p in m.values()}
            stolen = set(self.stolen[i])
            assert len(free) == len(s.free_pages), (i, "free duplicates")
            groups = (free, lru, live, stolen)
            for gi, a in enumerate(groups):
                assert 0 not in a, (i, "null page leaked into the pool")
                for b in groups[gi + 1:]:
                    assert not (a & b), (i, free, lru, live, stolen)
            assert len(free) + len(lru) + len(live) + len(stolen) \
                == self.n_pages - 1, \
                (i, len(free), len(lru), len(live), len(stolen))
            refs = np.zeros_like(s.ref)
            for m in s.slot_pages:
                for p in m.values():
                    refs[p] += 1
            assert np.array_equal(refs, s.ref), (i, refs, s.ref)
            assert s.pages_in_use == len(live), (i, s.pages_in_use, len(live))
            for p in s.lru:
                assert p in s.page_hash, (i, p)

    def find(self, req: Request) -> Optional[Tuple[int, int]]:
        for i, s in enumerate(self.shards):
            for slot, r in enumerate(s.slots):
                if r is req:
                    return i, slot
        return None

    def assert_local(self) -> None:
        """Locality: every mapped physical page id is a LOCAL id inside its
        own shard's range; no row can name another shard's page."""
        for i, s in enumerate(self.shards):
            for slot, m in enumerate(s.slot_pages):
                for j, p in m.items():
                    assert 0 < p < self.n_pages, (i, slot, j, p)
