"""Sharded multi-chiplet serving: the slot- and page-partitioned engine (port
of `repro/serve/sharded.py`).

The paper's scale-out (dual NPU chiplets behind a UCIe link) as a serving
runtime: `ShardedServeEngine` partitions the decode batch's slots and the
paged KV pool into shards, one a chiplet, and serves them all with ONE
global decode step a tick. The reference places a shard on each device of
a mesh and runs its programs under `shard_map`; on one card the port keeps
the same layout in one device's memory:

  * **One global pool, contiguous page ranges per shard.** Pools are
    (L, n_shards · n_pages, page_size, ...); shard s owns pages
    [s·n_pages, (s+1)·n_pages) and its local page 0, global s·n_pages, is
    its own null page.
  * **Local, host-authoritative page tables.** Table entries are LOCAL
    page ids (0..n_pages-1), reserved from the slot's own shard only, as
    in the reference. They are translated to global ids (local +
    s·n_pages) once a tick where they enter the device, so a slot's row
    lies in its shard's range by construction (`assert_local_page_tables`).
    Inactive slots, slots on a migration hold and a shard's chunk padding
    write into their own shard's null page, never into another shard's.
  * **One global decode step** over all n_slots, the single-host engine's
    batch: paged decode attention launches once a layer a tick. Tokens
    are the only per-step device-to-host copy; the page table, positions,
    tokens, the write mask and the null pages go up in one non-blocking
    copy from pinned staging.
  * **Per-shard chunk prefill.** Each shard with chunk work runs the
    single-host engine's chunk program on its own page row and null page
    (one paged chunk-attention launch a layer a chunk), so a long prompt
    on one shard costs only that shard a chunk a tick.
  * **Compile once**, as the single-host engine (`serve/graphs.py`): the
    global decode step (greedy, and sampled on the first tick that
    samples) and the chunk step that every shard shares are captured once
    as CUDA graphs under the single-host labels, so `COMPILE_BUDGETS`
    apply unchanged, and the page move once under "move", the
    reference's label (no `EngineStats` counter, as in the reference);
    `eager=True` runs them per op.
  * **Shared weights.** Every shard reads one copy of the weights: shards
    on one device are replicas of the same tensors.

Admission runs through `serve/scheduler.ShardScheduler` (per-shard free
lists and registries, least-loaded placement, per-shard interleaved chunk
work). A row does not depend on which slots are live beside it, nor a chunk
row on its shard (fixed row blocks and f64 norm sums on the card), so this
engine gives the single-host `ServeEngine`'s tokens for the same
submissions, under another schedule.

Live page migration: the move step takes one wave of the reference's fixed
shape, (n_shards, wave_moves) index arrays padded with each shard's null
page (exporting and importing a null page is a no-op by contract), so
drain, recovery, elastic rebalancing and prefix replication all replay one
program. It gathers a wave's source pages out of the pool before it writes
any of them into their freshly allocated destinations (`gather_pool_pages`
/ `set_pool_page`), so a DRAINING
shard's slots re-home at O(bytes), priced through `core/ucie.transfer`,
instead of re-prefilling at O(FLOPs); DEAD shards replay (their bytes are
gone). The same move serves elastic rebalancing, migration instead of
preemption, and cross-shard replication of hot prefix pages;
`serve/migration` plans, `ShardScheduler.migrate_slot` re-homes the
bookkeeping. A migrated slot sits out the link's hold on its shard's null
page, then resumes token-exact. Placing shards on separate cards waits for
a machine with more than one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import (
    alloc_cache, copy_pool_page, gather_pool_pages, set_pool_page)
from repro_torch.serve.engine import (
    _KV_DTYPES, EngineOverloaded, EngineStats, Request, ServeEngine,
    check_extras, chunk_patch_rows, engine_params, request_seed_digest)
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.health import (
    EVACUATED, Health, HealthConfig, ShardHealthMonitor)
from repro_torch.serve.migration import (
    MigrationConfig, migration_cost, page_payload_bytes,
    plan_prefix_replication, plan_rebalance, plan_starvation_rescue)
from repro_torch.serve.sampling import clamp_sample_params, sample_tokens
from repro_torch.serve.scheduler import ShardScheduler
from repro_torch.tree import tree_leaves


class ShardedServeEngine:
    """Continuous batching over a shard-partitioned paged KV pool.

    API as `ServeEngine`'s (submit / step / run_to_completion / cancel /
    stats) and the reference's: `n_slots` is the GLOBAL decode batch (a
    multiple of the mesh's shard count) and `n_pages` the PER-SHARD pool,
    its null page included. `mesh` is a `launch.mesh.ServeMesh`; the
    engine runs on its device. The health monitor's few scalars a shard
    step on the host, so health tracking adds no device sync. `eager=True`
    runs the decode and chunk steps per op, without CUDA graph capture."""

    COMPILE_BUDGETS = ServeEngine.COMPILE_BUDGETS

    def __init__(self, model, *, mesh, axis: str = "data",
                 n_slots: int = 4, max_len: int = 128, params=None,
                 page_size: int = 32, n_pages: Optional[int] = None,
                 wdtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 chunk_pages: int = 2,
                 prefix_cache: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 ttl_ticks: Optional[int] = None,
                 preempt_after: int = 2,
                 max_preemptions: int = 3,
                 fault_plan: Optional[FaultPlan] = None,
                 health_cfg: Optional[HealthConfig] = None,
                 migration: bool = True,
                 migration_cfg: Optional[MigrationConfig] = None,
                 rebalance_threshold: Optional[int] = None,
                 eager: bool = False):
        self.model = model
        self.cfg = model.cfg
        if self.cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                "ShardedServeEngine shards paged attention-family caches "
                f"(dense/moe/vlm), not {self.cfg.family!r} (encdec needs a "
                "sharded cross-cache paste, as in the reference)")
        if model.prefill_chunk is None:
            raise ValueError("sharded serving requires chunked prefill")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {dict(mesh.shape)}")
        for a, n in mesh.shape.items():
            if a != axis and n != 1:
                raise ValueError(
                    f"mesh axis {a!r} (size {n}) is unsupported: tensor "
                    "parallelism inside a shard is not ported; shard slots "
                    f"over a 1-D {axis!r} mesh (launch/mesh.make_serve_mesh)")
        if params is None:
            raise ValueError("ShardedServeEngine needs params")
        self.mesh, self.axis = mesh, axis
        self.device = mesh.device
        self.n_shards = mesh.shape[axis]
        if n_slots % self.n_shards:
            raise ValueError(f"n_slots {n_slots} must divide over "
                             f"{self.n_shards} shards")
        self.n_slots = n_slots
        self.slots_per_shard = n_slots // self.n_shards
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} % page_size {page_size} != 0")
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = max_len // page_size

        if wdtype not in (None, "bf16", "int8"):
            raise ValueError(f"wdtype must be None/'bf16'/'int8', got {wdtype!r}")
        self.wdtype = wdtype
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.kv_dtype = _KV_DTYPES[kv_dtype]
        if self.kv_dtype == torch.float8_e5m2:
            raise ValueError("kv_dtype fp8/e5m2 supports the dense cache "
                             "layout only; the sharded engine is paged")
        # one copy of the weights, read by every shard
        self.params = engine_params(params, self.cfg, wdtype, self.device)

        self._window = self.cfg.window or 0
        # windowed slots chunk one page at a time (the reservation of
        # ceil(window/page)+2 pages must cover the chunk's write-ahead)
        self.chunk_pages = 1 if self._window else max(1, int(chunk_pages))
        self.chunk_tokens = self.chunk_pages * page_size
        # per-shard pool: the local null page + the shard's worst case
        self.n_pages = (1 + self.slots_per_shard * self.pages_per_seq
                        if n_pages is None else n_pages)
        assert self.n_pages >= 2, self.n_pages

        # the prefix cache: per-shard ref-counted registries; on by
        # default, off under a sliding window (recycling rewrites pages)
        self.prefix_cache = (not self._window) if prefix_cache is None \
            else (bool(prefix_cache) and not self._window)
        self._sched = ShardScheduler(
            n_shards=self.n_shards, slots_per_shard=self.slots_per_shard,
            n_pages=self.n_pages, page_size=page_size,
            pages_per_seq=self.pages_per_seq, max_len=max_len,
            chunk_tokens=self.chunk_tokens, window=self._window,
            prefix_cache=self.prefix_cache)

        self.stats = EngineStats()
        # ---- fault tolerance and backpressure ------------------------------
        self.max_queue = max_queue
        self.ttl_ticks = ttl_ticks
        self.preempt_after = max(1, int(preempt_after))
        self.max_preemptions = max(0, int(max_preemptions))
        self.fault_plan = fault_plan
        # the health monitor exists only when fault injection or health
        # tracking is asked for, so the default engine is the fault-free one
        self._monitor = (ShardHealthMonitor(self.n_shards, health_cfg,
                                            device="cpu")
                         if fault_plan is not None or health_cfg is not None
                         else None)
        self._tick = 0               # engine tick counter (fault/TTL clock)
        self._starved = 0            # consecutive page-starved ticks
        self._any_ttl = ttl_ticks is not None
        self._recover_started: Dict[int, int] = {}  # rid -> requeue tick
        # ---- live page migration -------------------------------------------
        self._mig_cfg = migration_cfg or MigrationConfig()
        if rebalance_threshold is not None:
            self._mig_cfg = dataclasses.replace(
                self._mig_cfg, rebalance_threshold=int(rebalance_threshold))
        self._migration = bool(migration)
        # per-slot link hold: a migrated slot's pages are on the wire for
        # migration_ticks(bytes) engine ticks; it neither decodes nor
        # chunks until the modeled transfer lands
        self._hold = np.zeros((n_slots,), np.int32)
        self._resume_live = [False] * n_slots
        self._replica_hold = None    # (rid, ticks) of a replicated prefix
        self.shard_tokens = [0] * self.n_shards
        self.shard_occupancy_sum = [0.0] * self.n_shards
        self._slots: List[Optional[Request]] = [None] * n_slots
        self._fresh = [False] * n_slots
        # slots whose replay of the prompt's last token writes its K/V row
        # (a vlm prompt that ends in a patch row; `ServeEngine._write_mask`)
        self._replay_writes = np.zeros((n_slots,), bool)
        self._next_rid = 0
        # host-authoritative per-slot state, uploaded each decode step:
        # LOCAL page ids (null rows for free, mid-prefill and held slots)
        self._page_table = np.zeros((n_slots, self.pages_per_seq), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)
        self._active = np.zeros((n_slots,), bool)
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        self._temp = np.zeros((n_slots,), np.float32)
        self._topk = np.zeros((n_slots,), np.int32)
        self._topp = np.ones((n_slots,), np.float32)
        self._sseed = np.zeros((n_slots,), np.int32)
        # each slot's shard's first global page: its null page, and the
        # offset that turns a LOCAL page id into a global one
        self._base = np.repeat(
            np.arange(self.n_shards, dtype=np.int32) * self.n_pages,
            self.slots_per_shard)

        # ---- the global pool -----------------------------------------------
        self._cache = alloc_cache(model.cache_shape(
            n_slots, max_len, self.kv_dtype, page_size=page_size,
            n_pages=self.n_shards * self.n_pages), self.device)
        self._pools = {k: v for k, v in self._cache.items()
                       if k not in ("page_table", "pos")}
        self._page_bytes = page_payload_bytes(self._pools)

        # ---- the captured steps --------------------------------------------
        self.eager = eager
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" and not eager
                            else None)
        n, pps, C = n_slots, self.pages_per_seq, self.chunk_tokens
        self._decode_spec = {"page_table": ((n, pps), torch.int32),
                             "pos": ((n,), torch.int32),
                             "tokens": ((n, 1), torch.int32),
                             "write": ((n,), torch.bool),
                             "null_page": ((n,), torch.int32)}
        spec = {"tokens": ((1, C), torch.int32),
                "start": ((1,), torch.int32), "length": ((1,), torch.int32),
                "page_row": ((pps,), torch.int32),
                "null_page": ((1,), torch.int32)}
        if self.cfg.family == "vlm":
            spec["patch_rows"] = ((1, C, self.cfg.d_model), torch.float32)
            spec["n_patch"] = ((1,), torch.int32)
        self.steps = {
            "decode": self._step(ShardedServeEngine._greedy_step,
                                 self._decode_spec, "decode"),
            "chunk": self._step(ShardedServeEngine._chunk_step, spec,
                                "chunk")}
        S, M = self.n_shards, self._mig_cfg.wave_moves
        self.steps["move"] = StepGraph(
            self, ShardedServeEngine._move_step,
            {"out_idx": ((S, M), torch.int64), "in_src": ((S, M), torch.int64),
             "in_dst": ((S, M), torch.int64)},
            state=ShardedServeEngine._step_state, stat=None, label="move",
            device=self.device, eager=eager, pool=self._graph_pool)

    def _step(self, fn, spec, label) -> StepGraph:
        return StepGraph(self, fn, spec,
                         state=ShardedServeEngine._step_state,
                         stat=f"{label}_compiles", label=label,
                         device=self.device, eager=self.eager,
                         pool=self._graph_pool)

    def _step_state(self):
        """The tensors a captured step reads: the pool and the weights."""
        return tree_leaves([self._cache, self.params])

    # ------------------------------------------------------------- lifecycle
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               extras: Optional[Dict[str, np.ndarray]] = None,
               sample_params: Optional[tuple] = None,
               seed: int = 0, ttl_ticks: Optional[int] = None) -> Request:
        """Queue a request, the single-host contract: a malformed request
        raises ValueError (nothing enqueued), a full queue raises
        EngineOverloaded."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be a 1-D token array, got shape {prompt.shape}")
        if prompt.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.shape[0] > self.max_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds engine max_len "
                f"{self.max_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        extras = check_extras(self.cfg, extras, prompt.shape[0])
        need = self._sched.pages_for(prompt.shape[0], max_new_tokens)
        if need > self.n_pages - 1:
            raise ValueError(f"request needs {need} pages; each shard's pool "
                             f"has {self.n_pages - 1}")
        if self.max_queue is not None \
                and len(self._sched.queue) >= self.max_queue:
            self.stats.rejected += 1
            raise EngineOverloaded(
                f"admission queue at cap ({self.max_queue}); retry later")
        temperature, top_k, top_p = 0.0, 0, 1.0
        if sample_params is not None:
            temperature, top_k, top_p = clamp_sample_params(*sample_params)
        self._next_rid += 1
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, extras=extras,
                      seed_digest=request_seed_digest(extras),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed),
                      t_enqueue=time.time(), submit_tick=self._tick,
                      ttl_ticks=ttl_ticks)
        if ttl_ticks is not None:
            self._any_ttl = True
        self._sched.queue.append(req)
        return req

    def cancel(self, req: Request) -> None:
        """Retire a request at any stage: queued (dequeued), mid-prefill
        (its chunk queue drained, every reserved page freed) or decoding
        (its slot released). Pool accounting stays exact in all three."""
        if req.done:
            return
        if req in self._sched.queue:
            self._sched.queue.remove(req)
        else:
            at = self._sched.find(req)
            if at is not None:
                self._release(self._gslot(*at))
        req.done = True
        req.t_done = time.time()

    def _gslot(self, shard: int, slot: int) -> int:
        return shard * self.slots_per_shard + slot

    def _release(self, g: int):
        shard, slot = divmod(g, self.slots_per_shard)
        self._sched.release(shard, slot)
        self._slots[g] = None
        self._active[g] = False
        self._fresh[g] = False
        self._replay_writes[g] = False
        self._page_table[g] = 0         # back on the shard's null page
        self._temp[g], self._topk[g] = 0.0, 0
        self._topp[g], self._sseed[g] = 1.0, 0
        self._hold[g] = 0
        self._resume_live[g] = False
        self.stats.pages_in_use = self._sched.pages_in_use

    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._pools.values())

    def global_page_table(self) -> np.ndarray:
        """The page table the device reads: each slot's LOCAL ids plus its
        shard's first global page (local 0, the null page, included)."""
        return self._page_table + self._base[:, None]

    def assert_local_page_tables(self) -> None:
        """Locality: every page-table entry is a LOCAL id of its own
        shard's range, and every translated row lies inside that shard's
        global pages."""
        self._sched.assert_local()
        assert int(self._page_table.max(initial=0)) < self.n_pages, \
            self._page_table.max()
        assert int(self._page_table.min(initial=0)) >= 0
        table = self.global_page_table()
        lo = self._base[:, None]
        assert np.all((table >= lo) & (table < lo + self.n_pages)), table

    # ---------------------------------------------------------------- prefill
    def _prefill_tick(self) -> bool:
        work = self._sched.next_chunks()
        # held slots (mid-migration) do not chunk: their pages are on the wire
        work = [w for w in work
                if not self._hold[self._gslot(w.shard, w.slot)]]
        if not work:
            return False
        C = self.chunk_tokens
        for w in work:
            # one chunk call a shard, on the shard's own translated page row
            lp = w.req.live_prompt()   # a resumed request re-prefills its output
            base = w.shard * self.n_pages
            toks = np.zeros((1, C), np.int32)
            toks[0, :w.length] = lp[w.start:w.start + w.length]
            inputs = {"tokens": toks, "start": w.start, "length": w.length,
                      "page_row": self._sched.page_row(w.shard, w.slot) + base,
                      "null_page": base}
            if self.cfg.family == "vlm":
                inputs.update(chunk_patch_rows(w.req, w.start, C,
                                               self.cfg.d_model))
            self.steps["chunk"](**inputs)
        self.stats.prefill_chunks += len(work)
        self.stats.prefill_pad_tokens += sum(C - w.length for w in work)
        for w in work:
            self._sched.advance_chunk(w)
            if w.final:
                self._sched.register_prefix(w.shard, w.slot, w.req)
                self._go_live(w.shard, w.slot, w.req)
        return True

    def _go_live(self, shard: int, slot: int, r) -> None:
        """A prefilled (or fully cached) slot goes live: its LOCAL table row
        and replay position into the host-authoritative state."""
        g = self._gslot(shard, slot)
        lp = r.live_prompt()
        self._page_table[g] = self._sched.page_row(shard, slot)
        self._pos[g] = lp.shape[0] - 1
        self._next_tok[g, 0] = int(lp[-1])
        self._fresh[g] = True
        self._active[g] = True
        pe = (r.extras or {}).get("patch_embeds")
        self._replay_writes[g] = pe is not None and pe.shape[0] >= lp.shape[0]
        started = self._recover_started.pop(r.rid, None)
        if started is not None:   # a recovered stream back live
            self.stats.recovery_ticks_sum += self._tick - started

    # ----------------------------------------------------------------- decode
    def _place(self, placements) -> None:
        for p in placements:
            g = self._gslot(p.shard, p.slot)
            r = p.req
            self._slots[g] = r
            self._active[g] = False
            self._fresh[g] = False
            self._temp[g], self._topk[g] = r.temperature, r.top_k
            self._topp[g], self._sseed[g] = r.top_p, r.seed
            self.stats.prefills += 1
            self.stats.prefill_tokens += (r.live_prompt().shape[0]
                                          - p.cached_tokens)
        # the COW tail clones, after the whole admit wave and before any of
        # its pages is written (the scheduler pins each source until then)
        for p in placements:
            if p.cow is not None:
                base = p.shard * self.n_pages
                copy_pool_page(self._cache, base + p.cow[0], base + p.cow[1])
        for p in placements:
            if p.full_hit:
                # every prompt page came from the cache: zero prefill chunks,
                # the slot goes live straight from placement
                self._go_live(p.shard, p.slot, p.req)
            if self._replica_hold is not None \
                    and p.req.rid == self._replica_hold[0]:
                # this admission rides freshly replicated prefix pages: it
                # waits out the modeled UCIe transfer first
                g = self._gslot(p.shard, p.slot)
                self._hold[g] = self._replica_hold[1]
                if p.full_hit:
                    self._active[g] = False
                    self._page_table[g] = 0
                    self._resume_live[g] = True
                self._replica_hold = None

    def _sync_prefix_stats(self) -> None:
        sc, st = self._sched, self.stats
        st.prefix_hits = sc.prefix_hits
        st.prefix_misses = sc.prefix_misses
        st.prefix_hit_tokens = sc.prefix_hit_tokens
        st.prefix_evictions = sc.prefix_evictions
        st.cow_copies = sc.cow_copies
        st.prefix_cached_pages = sum(len(s.lru) for s in sc.shards)

    def _chunk_step(self, inp):
        """The captured chunk step every shard shares: its page row and
        null page are inputs."""
        self.model.prefill_chunk(self.params, dict(inp), self._cache)

    def _decode_core(self, inp) -> torch.Tensor:
        """One global decode step over every slot, from the uploaded
        translated page table, positions, tokens, write mask and null
        pages (copied into the cache's own tensors); inactive slots decode
        position 0 on their shard's null page. Returns the (n_slots, vocab)
        logits."""
        cache = self._cache
        cache["page_table"].copy_(inp["page_table"])
        pos = cache["pos"]
        pos.copy_(inp["pos"])
        logits, _ = self.model.decode(
            self.params, {"tokens": inp["tokens"], "write": inp["write"],
                          "null_page": inp["null_page"]}, cache)
        cache["pos"] = pos               # positions are the host's
        return logits[:, -1, :self.cfg.vocab_size]

    def _greedy_step(self, inp):
        return torch.argmax(self._decode_core(inp), dim=-1).to(torch.int32)

    def _sampled_step(self, inp):
        return sample_tokens(self._decode_core(inp).float(), inp["temp"],
                             inp["topk"], inp["topp"], inp["seed"],
                             inp["counter"])

    def _sampled(self) -> StepGraph:
        """The sampled decode step, built on the first tick that samples."""
        step = self.steps.get("decode_sampled")
        if step is None:
            n = self.n_slots
            spec = dict(self._decode_spec, temp=((n,), torch.float32),
                        topk=((n,), torch.int32), topp=((n,), torch.float32),
                        seed=((n,), torch.int32), counter=((n,), torch.int32))
            step = self.steps["decode_sampled"] = self._step(
                ShardedServeEngine._sampled_step, spec, "decode")
        return step

    def step(self) -> bool:
        """One engine tick: count down migration holds, apply the fault
        plan's events, advance shard health (DRAINING evacuates by live page
        migration, DEAD by replay), expire TTLs, replicate a hot prefix for
        the queue head if it is remote, admit (rescuing a page-starved head
        by migrating a victim away before falling back to preemption),
        rebalance by one move, then each shard's chunk and ONE global decode
        step."""
        self._tick += 1
        self._advance_holds()
        if self.fault_plan is not None:
            self._apply_faults()
        if self._monitor is not None:
            self._health_tick()
        if self._any_ttl:
            self._expire_ttl()
        if self._migration:
            self._replicate_prefix()
        self._place(self._sched.admit())
        rebalance = self._migration and self._mig_cfg.rebalance_threshold > 0
        if self._sched.queue:
            head = self._sched.queue[0]
            need = self._sched.pages_for(head.live_prompt().shape[0],
                                         head.remaining_new())
            if self._sched.page_starved(need):
                self._starved += 1
                if rebalance and self._rescue(need):
                    # migration instead of preemption: the head admits and
                    # no decoded work is thrown away
                    self._place(self._sched.admit())
                    self._starved = 0
                elif self._starved >= self.preempt_after:
                    cand = self._sched.preempt_candidate(
                        need, head.rid, self.max_preemptions)
                    if cand is not None:
                        self._preempt(*cand)
                        self._place(self._sched.admit())
            else:
                self._starved = 0
        else:
            self._starved = 0
        if rebalance:
            self._rebalance_tick()
        self.stats.pages_in_use = self._sched.pages_in_use
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.stats.pages_in_use)
        self._sync_prefix_stats()
        chunk_ran = self._prefill_tick()
        decoding = [g for g in range(self.n_slots) if self._active[g]]
        if not decoding:
            return chunk_ran
        inputs = {"page_table": self.global_page_table(),
                  "pos": np.where(self._active, self._pos, 0),
                  "tokens": self._next_tok,
                  "write": ~np.asarray(self._fresh) | self._replay_writes,
                  "null_page": self._base}
        if any(self._temp[g] > 0 for g in decoding):
            toks = self._sampled()(
                **inputs, temp=self._temp, topk=self._topk, topp=self._topp,
                seed=self._sseed,
                counter=[len(r.out_tokens) if r is not None else 0
                         for r in self._slots])
        else:
            toks = self.steps["decode"](**inputs)
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(decoding) / self.n_slots
        for shard in range(self.n_shards):
            busy = sum(1 for g in decoding
                       if g // self.slots_per_shard == shard)
            self.shard_occupancy_sum[shard] += busy / self.slots_per_shard
        nxt = toks.cpu().numpy()             # tokens: the ONE per-step sync
        self._pos[self._active] += 1         # host-authoritative positions
        for g in decoding:
            r = self._slots[g]
            r.out_tokens.append(int(nxt[g]))
            self._next_tok[g, 0] = nxt[g]
            self.stats.tokens_out += 1
            self.shard_tokens[g // self.slots_per_shard] += 1
            if self._fresh[g]:
                if r.t_first_token is None:   # a resumed slot keeps its own
                    r.t_first_token = time.time()
                    r.first_token_tick = self._tick
                self._fresh[g] = False
            if len(r.out_tokens) >= r.max_new_tokens \
                    or int(self._pos[g]) >= self.max_len:
                r.done = True
                r.t_done = time.time()
                self.stats.record_request(r)
                self._release(g)
        if self._window:
            self._recycle_window_pages()
        return True

    def _recycle_window_pages(self):
        """Slide live slots' windows: the scheduler's bookkeeping, mirrored
        into the host page table (the next decode step reads it)."""
        for g in range(self.n_slots):
            if self._slots[g] is None or not self._active[g]:
                continue
            shard, slot = divmod(g, self.slots_per_shard)
            if not self._sched.shards[shard].slot_pages[slot]:
                continue
            remaps, unmaps = self._sched.recycle(shard, slot,
                                                 int(self._pos[g]))
            for j_dead, j_new, phys in remaps:
                self._page_table[g, j_dead] = 0
                self._page_table[g, j_new] = phys
            for j_dead in unmaps:
                self._page_table[g, j_dead] = 0
        self.stats.pages_in_use = self._sched.pages_in_use

    # ------------------------------------------------- live page migration
    def _advance_holds(self):
        """Count down the migration holds; a slot whose hold ends (with its
        request still there) takes its page-table row back and resumes: it
        sat out exactly the link time `core/ucie` charged."""
        for g in np.nonzero(self._hold > 0)[0]:
            self._hold[g] -= 1
            if self._hold[g] == 0 and self._resume_live[g] \
                    and self._slots[g] is not None:
                shard, slot = divmod(int(g), self.slots_per_shard)
                self._page_table[g] = self._sched.page_row(shard, slot)
                self._active[g] = True
                self._resume_live[g] = False

    def _device_move(self, moves) -> None:
        """Run (src_shard, src_phys, dst_shard, dst_phys) page moves (LOCAL
        ids) on the device in waves of at most `wave_moves` outgoing and
        incoming pages a shard, as the reference batches them: each wave is
        one call of the move step, its (n_shards, wave_moves) arrays of
        GLOBAL page ids padded with each shard's null page. A wave gathers
        all its source pages before it writes any destination, and
        destinations are freshly allocated, so the waves' order and the
        moves' order inside a wave do not matter."""
        M = self._mig_cfg.wave_moves
        S = self.n_shards
        null = (np.arange(S, dtype=np.int64) * self.n_pages)[:, None]
        i = 0
        while i < len(moves):
            out_idx = np.repeat(null, M, axis=1)
            in_dst = out_idx.copy()
            in_src = np.zeros((S, M), np.int64)
            out_n = [0] * S
            in_n = [0] * S
            while i < len(moves):
                ss, sp, ds, dp = moves[i]
                if out_n[ss] >= M or in_n[ds] >= M:
                    break
                out_idx[ss, out_n[ss]] = ss * self.n_pages + sp
                in_src[ds, in_n[ds]] = ss * M + out_n[ss]
                in_dst[ds, in_n[ds]] = ds * self.n_pages + dp
                out_n[ss] += 1
                in_n[ds] += 1
                i += 1
            self.steps["move"](out_idx=out_idx, in_src=in_src,
                               in_dst=in_dst)

    def _move_step(self, inp):
        """One move wave: every shard's outbox (`out_idx`, global ids) out
        of every pool, then each incoming page's row of the outbox
        (`in_src`) into its destination (`in_dst`). Padding exports a
        shard's null page and imports onto its null page."""
        outbox = gather_pool_pages(self._cache, inp["out_idx"].reshape(-1))
        src = inp["in_src"].reshape(-1)
        set_pool_page(self._cache, inp["in_dst"].reshape(-1),
                      {k: v.index_select(1, src) for k, v in outbox.items()})

    def _migrate_slot(self, src_shard: int, src_slot: int, dst_shard: int,
                      *, count_recovery: bool = False) -> int:
        """Re-home one live slot: the scheduler's bookkeeping moves
        atomically (`migrate_slot`), the pages cross the modeled UCIe link
        through the move program, and the destination slot is held for the
        link's `migration_ticks` before its next step. Returns the hold."""
        g_src = self._gslot(src_shard, src_slot)
        r = self._slots[g_src]
        # a slot already on hold (a migration or replica wait in flight)
        # keeps its pending go-live across a second move
        was_active = bool(self._active[g_src]) or self._resume_live[g_src]
        prior_hold = int(self._hold[g_src])
        dst_slot, page_moves = self._sched.migrate_slot(
            src_shard, src_slot, dst_shard)
        g_dst = self._gslot(dst_shard, dst_slot)
        self._device_move([(src_shard, sp, dst_shard, dp)
                           for sp, dp in page_moves])
        self._pos[g_dst] = self._pos[g_src]
        self._next_tok[g_dst, 0] = self._next_tok[g_src, 0]
        self._fresh[g_dst] = self._fresh[g_src]
        self._replay_writes[g_dst] = self._replay_writes[g_src]
        self._temp[g_dst], self._topk[g_dst] = \
            self._temp[g_src], self._topk[g_src]
        self._topp[g_dst], self._sseed[g_dst] = \
            self._topp[g_src], self._sseed[g_src]
        self._slots[g_dst], self._slots[g_src] = r, None
        self._temp[g_src], self._topk[g_src] = 0.0, 0
        self._topp[g_src], self._sseed[g_src] = 1.0, 0
        self._fresh[g_src] = False
        self._replay_writes[g_src] = False
        self._active[g_src] = self._active[g_dst] = False
        self._page_table[g_src] = 0     # back on the source's null page
        self._page_table[g_dst] = 0     # stamped when the hold ends
        self._resume_live[g_dst] = was_active
        self._resume_live[g_src] = False
        ticks, wire = migration_cost(
            len(page_moves) * self._page_bytes, self._mig_cfg)
        self._hold[g_dst] = max(ticks, prior_hold)
        self._hold[g_src] = 0
        self.stats.migrations += 1
        self.stats.migrated_pages += len(page_moves)
        self.stats.migrated_bytes_compressed += wire
        if count_recovery:
            self.stats.recoveries += 1
            self.stats.recovery_ticks_sum += ticks
        self.stats.pages_in_use = self._sched.pages_in_use
        return ticks

    def _movable(self, shard: int, slot: int) -> bool:
        """Planner veto: only settled decoding slots move for balance, never
        mid-prefill, never already on the wire."""
        g = self._gslot(shard, slot)
        return bool(self._active[g]) and self._hold[g] == 0

    def _rescue(self, need: int) -> bool:
        """Migration instead of preemption for a page-starved head."""
        plan = plan_starvation_rescue(self._sched, need,
                                      self._sched.placeable, self._movable)
        if plan is None:
            return False
        self._migrate_slot(*plan)
        self.stats.rebalance_events += 1
        return True

    def _rebalance_tick(self) -> None:
        """One elastic move a tick when the busy-slot gap between shards
        exceeds the configured threshold."""
        plan = plan_rebalance(self._sched, self._mig_cfg.rebalance_threshold,
                              self._sched.placeable, self._movable)
        if plan is not None:
            self._migrate_slot(*plan)
            self.stats.rebalance_events += 1

    def _replicate_prefix(self) -> None:
        """Cross-shard prefix reuse for the queue head: copy a hot remote
        prefix run onto the shard admission will pick, as page moves
        instead of re-prefill. The admission that rides the copies waits
        out the link time."""
        if not self._sched.queue or not self._sched.prefix_cache \
                or self._replica_hold is not None:
            return
        r = self._sched.queue[0]
        plan = plan_prefix_replication(self._sched, r, self._mig_cfg,
                                       self._sched.placeable)
        if plan is None:
            return
        src, dst, digests = plan
        moves = []
        for d in digests:
            mv = self._sched.replicate_page(src, dst, d)
            if mv is None:
                break
            moves.append((src, mv[0], dst, mv[1]))
        if not moves:
            return
        self._device_move(moves)
        ticks, wire = migration_cost(
            len(moves) * self._page_bytes, self._mig_cfg)
        self.stats.migrated_pages += len(moves)
        self.stats.migrated_bytes_compressed += wire
        self._replica_hold = (r.rid, ticks)
        self.stats.pages_in_use = self._sched.pages_in_use

    # ------------------------------------------------------- fault tolerance
    def _apply_faults(self):
        """Apply this tick's FaultPlan events, at the tick boundary before
        health and admission, so a plan replays bit for bit."""
        for e in self.fault_plan.events_at(self._tick):
            if e.kind == "shard_death":
                if self._monitor.force_dead(e.shard):
                    self._recover_shard(e.shard)
            elif e.kind == "shard_rejoin":
                if self._monitor.begin_rejoin(e.shard):
                    # the pool comes back fresh; placement resumes once the
                    # monitor's rejoin cooldown makes the shard HEALTHY
                    self._sched.reset_shard(e.shard)
            elif e.kind == "sensor_hot":
                self._monitor.inject_sensor(e.shard, e.delta_c, e.ticks)
            elif e.kind == "page_squeeze":
                self._sched.steal_pages(e.shard, e.pages)
            elif e.kind == "page_restore":
                self._sched.restore_pages(e.shard)
            self.stats.faults_injected += 1

    def _health_tick(self):
        """Advance the sensor-driven health machine one tick and react:
        shards entering DRAINING or DEAD have their live slots recovered, a
        drained shard that cooled resets its pool to rejoin, and the
        scheduler's placement mask follows the monitor."""
        occ = np.zeros((self.n_shards,), np.float64)
        for shard in range(self.n_shards):
            base = shard * self.slots_per_shard
            occ[shard] = sum(
                1 for s in range(self.slots_per_shard)
                if self._slots[base + s] is not None) / self.slots_per_shard
        for shard, old, new in self._monitor.step(occ):
            if new in EVACUATED and old not in EVACUATED:
                # DRAINING bytes are still there: live page migration;
                # DEAD bytes are gone: re-prefill replay is all there is
                self._recover_shard(shard,
                                    migrate=(new == Health.DRAINING))
            if new == Health.REJOINING and old == Health.DRAINING:
                self._sched.reset_shard(shard)
        self._sched.placeable = self._monitor.placeable()

    def _recover_shard(self, shard: int, migrate: bool = False):
        """Evacuate every live slot off a draining or dead shard.

        With `migrate=True` (DRAINING: the pool bytes are alive) each slot
        first tries a live page migration to a healthy shard, at O(bytes):
        no prefill chunk is recomputed and the stream resumes token-exact
        after the link hold. Slots that fit nowhere (or every slot, when
        migration is off or the shard is DEAD) are released, requeued in
        rid order and re-prefilled on whichever healthy shard admission
        picks. Both paths are token-exact with an uninterrupted twin."""
        base = shard * self.slots_per_shard
        remaining = []
        for s in range(self.slots_per_shard):
            g = base + s
            if self._slots[g] is None:
                continue
            if migrate and self._migration:
                placeable = (self._monitor.placeable()
                             if self._monitor is not None
                             else self._sched.placeable)
                dst = self._sched.migration_target(shard, s, placeable)
                if dst is not None:
                    self._migrate_slot(shard, s, dst, count_recovery=True)
                    continue
            remaining.append(s)
        displaced = []
        for s in remaining:
            g = base + s
            displaced.append(self._slots[g])
            self._release(g)
        if not displaced:
            return
        displaced.sort(key=lambda r: r.rid)
        self._sched.requeue(displaced)
        for r in displaced:
            self._recover_started.setdefault(r.rid, self._tick)
            self.stats.recoveries += 1
            self.stats.retries += 1

    def _preempt(self, shard: int, slot: int):
        """Evict one young decoding slot so the starving queue head can
        admit (`ShardScheduler.preempt_candidate` picks the victim)."""
        g = self._gslot(shard, slot)
        victim = self._slots[g]
        victim.preemptions += 1
        self._release(g)
        self._sched.requeue([victim])
        self.stats.preemptions += 1
        self.stats.retries += 1
        self._starved = 0

    def _expire_ttl(self):
        """Retire queued and live requests past their TTL (ticks since
        submit), releasing slots and pages as completion does."""
        def expired(r: Request) -> bool:
            ttl = r.ttl_ticks if r.ttl_ticks is not None else self.ttl_ticks
            return ttl is not None and self._tick - r.submit_tick > ttl

        q = self._sched.queue
        for r in [x for x in q if expired(x)]:
            q.remove(r)
            r.done = r.timed_out = True
            r.t_done = time.time()
            self.stats.timeouts += 1
        for g, r in enumerate(self._slots):
            if r is not None and expired(r):
                r.done = r.timed_out = True
                r.t_done = time.time()
                self.stats.timeouts += 1
                self._release(g)

    def assert_pool_accounting(self) -> None:
        """Exact pool accounting under faults: per shard free + mapped +
        cached + stolen == n_pages - 1, and every slot without a live
        request sits on its shard's null page row."""
        self._sched.assert_accounting()
        for g, r in enumerate(self._slots):
            if r is None:
                assert not self._page_table[g].any(), g

    def health_summary(self) -> Optional[Dict[str, object]]:
        return None if self._monitor is None else self._monitor.summary()

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        ticks = 0
        while (self._sched.queue
               or any(r is not None for r in self._slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.stats

    # ------------------------------------------------------------------ stats
    def shard_summary(self) -> Dict[str, object]:
        """Per-shard balance: tokens, occupancy imbalance, mean occupancy."""
        toks = self.shard_tokens
        mean = sum(toks) / max(1, len(toks))
        imb = (max(toks) - min(toks)) / mean if mean else 0.0
        return {"shard_tokens": list(toks),
                "occupancy_imbalance": imb,
                "shard_occupancy": [
                    s / self.stats.decode_steps if self.stats.decode_steps
                    else 0.0 for s in self.shard_occupancy_sum]}
