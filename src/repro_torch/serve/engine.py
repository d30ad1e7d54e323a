"""Single-host continuous-batching serving engine (port of
`repro/serve/engine.py`).

Three layouts, as in the reference:
- paged, chunked prefill (the default): admission reserves a request's pages
  up front (`_admit`); each tick runs at most one fixed-size prefill chunk
  (`_prefill_tick`: the chunk's K/V stream straight into the shared page
  pool and chunk attention reads the slot's live pages);
- paged, monolithic prefill (`chunked_prefill=False`): admission prefills
  the whole prompt, padded to its power-of-two bucket, and pastes its rows
  page by page into the reserved pages (`_paste`);
- dense (`paged=False`): one (max_len)-row cache per slot; admission
  prefills and pastes the rows into the slot (`_paste`).
Monolithic admissions replay the prompt's last token at position plen - 1,
so the first output token comes from the decode path. Every tick ends in
one batched decode step over the live slots. Physical page 0 is the null
page: retired and mid-prefill slots point their page-table rows at it, so
the batched decode's writes for them can never touch a reserved page.
`generate_greedy` is the single-request oracle (dense, exact-length
prefill) that the other layouts are held to token for token.

Extra prefill inputs (`submit(extras=)`), as in the reference: the vlm
family's `patch_embeds` (P, d_model) take the prompt's first P positions
(monolithic prefill takes them whole, each chunk the rows that overlap
it); the encdec family's `frames` (cross_len, d_model) feed the encoder,
whose cross K/V a chunked admission computes once (`prefill_cross`) and
pastes into the slot's dense cross rows, and a monolithic admission pastes
with the decoder's rows. The prefix cache's digest chain is seeded by the
extras, so only requests with equal extras share pages.

Request features, as in the reference:
- prefix cache (`prefix_cache=None` is on for paged chunked engines without
  a window): a ref-counted, content-addressed page allocator. A request's
  full prompt pages register under a sha1 digest chain when its last chunk
  lands; a later request whose prompt starts with the same pages maps them
  (refcount + 1), clones a fully cached tail page (copy-on-write: the
  replay writes row plen - 1) and resumes chunked prefill after them, or
  goes live with zero chunks on a full hit. Identical prompts in flight
  wait for the first one's pages. Pages at refcount zero stay registered
  in an LRU and are evicted oldest first when the free list is dry.
- per-slot sampling and logit processors (`submit(sample_params=,
  seed=, rep_penalty=, logit_bias=)`, `serve/sampling.py`): a decode step
  with any such slot samples every row through one batched sampler;
  all-greedy steps take the plain argmax.
- sliding windows (`cfg.window > 0`, paged): a slot maps O(window) pages;
  pages that fall out of the window remap to the slot's next logical page
  or return to the pool, between chunks and after every decode step. A
  window turns the prefix cache off (remapped pages are rewritten).

Pools and the page table are torch tensors on the engine's device, written
in place; the host keeps the authoritative free list, page mappings and
registry (numpy / Python). One host sync per decode step brings back the
tokens and positions together.

Compile once, as the reference's jits (`COMPILE_BUDGETS`): the decode step
(the greedy one with its argmax inside; the sampled one, built on the first
tick that samples, with the logit processors and the sampler inside) and
the fixed-shape prefill chunk are `serve/graphs.StepGraph`s; monolithic
prefill and the paste are `serve/graphs.StepFamily`s, one step a
signature: prefill one a bucket length (a vlm prompt also one a patch
count), the paste one a bucket length, as the reference's jits retrace.
On the card each is captured once as a CUDA graph and replayed every later
call; the call's inputs (tokens, active and write masks, the sampler's
per-slot arrays, the chunk's tokens and page row, the prompt's bucket of
tokens, patch rows or frames, the paste's slot, position and page row)
reach its static buffers through one pinned staging buffer and one
non-blocking copy, and no step reads the host. The prefill writes its rows
into a hand-off buffer of its bucket length, outside every graph, that the
paste reads (`serve/graphs`); int8 pools quantize the rows inside the
paste. `decode_compiles`, `chunk_compiles`, `prefill_compiles` and
`paste_compiles` count the builds, as the reference's counters count its
traces. A chunked encoder-decoder engine's encoder and cross K/V paste is
one more step, built once and counted on no counter (the reference jits it
unlabelled). `eager=True` runs the same steps without capture (the twin
that tests, `chip_smoke.py` and the profile tool hold a captured engine
to); on the CPU every engine runs that way. The recurrent families'
prefill runs at the prompt's exact length, as the reference's does, so it
has one signature a prompt length: it counts its builds the same way but
runs per op (a graph per prompt length would be captured for one call);
their state paste does not depend on the length and is one captured step.
The oracle (`generate_greedy`) runs eager.

KV storage: f32, bf16, int8 (f16 per-row scales) in every layout, and fp8
e5m2 (`kv_dtype="fp8"`/`"e5m2"`, bare rows, no scales) in the dense layout
only; a paged fp8 engine raises ValueError, as the reference's does. MLA
models (deepseek-v2-lite) keep one latent pool "k"; every pool loop here
goes through `pool_data_keys` / `copy_pool_page`.

Fault tolerance and backpressure, as in the reference: a `max_queue` cap
(`submit` raises `EngineOverloaded`), engine and per-request TTLs (a
retired request releases its slot and pages as a completed one does), a
`FaultPlan` (`serve/faults.py`) whose page squeezes and restores apply at
the tick boundary, and pools below the worst case. A queue head starved of
pages for PREEMPT_AFTER ticks preempts the youngest decoding slot younger
than it, whose stream resumes token-exact by re-prefilling prompt + emitted
tokens. Admission on one host is FIFO in rid order, so every decoding slot
is older than the head and such a pool only queues; a head older than a
slot comes from a requeue, which the sharded engine's recovery
(`serve/sharded.py`) supplies.

The recurrent families (ssm: mamba2-780m; hybrid: recurrentgemma-2b), as
in the reference: their state (the SSD state and conv rows, or each layer's
LRU state, conv rows and local-attention ring) would carry trailing pad
tokens, so they serve dense (`paged=None` picks it), with no bucketing and
no replay. Admission runs the exact-length `model.prefill`, samples the
first token from its logits (logit processors, then the sampler at counter
0), pastes the state whole into the slot (`_paste_state`) and retires a
request that is done at admission without a decode step. Int8 weights,
a KV dtype other than f32, paged pools, chunked prefill and the prefix
cache raise ValueError, as the reference's engine does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.quantized import is_quantized, quantize_kv_rows
from repro_torch.models.transformer import (
    alloc_cache, copy_pool_page, pool_data_keys)
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.graphs import StepFamily, StepGraph
from repro_torch.serve.sampling import (
    apply_logit_processors, clamp_rep_penalty, clamp_sample_params,
    sample_tokens)
from repro_torch.tree import tree_leaves

_KV_DTYPES = {None: torch.float32, "f32": torch.float32,
              "float32": torch.float32, "bf16": torch.bfloat16,
              "bfloat16": torch.bfloat16, "int8": torch.int8,
              # bare e5m2 rows, no scale tensors (dense layout only)
              "fp8": torch.float8_e5m2, "e5m2": torch.float8_e5m2}
# families whose caches are causal K/V rows: exact under trailing padding,
# so their monolithic prefill may pad to a bucket and replay the last token;
# the recurrent families (ssm, hybrid) keep exact-length prefill
_ATTN_FAMILIES = ("dense", "moe", "vlm", "encdec")
# the reference engine's defaults: page-starved ticks before a preemption,
# and preemptions a request may take
PREEMPT_AFTER = 2
MAX_PREEMPTIONS = 3


class EngineOverloaded(RuntimeError):
    """Backpressure: submit() refused because the admission queue is at its
    cap. Callers shed load (retry later, route elsewhere) instead of growing
    an unbounded queue."""


def bucket_length(plen: int, max_len: int) -> int:
    """Next power of two ≥ plen, clipped to max_len."""
    b = 1
    while b < plen:
        b <<= 1
    return min(b, max_len)


def window_page_budget(window: int, page_size: int) -> int:
    """Mapped pages that always cover [pos - window, pos] plus one page of
    write-ahead slack while the window slides."""
    return (window - 1) // page_size + 3


def reserve_page_count(plen: int, max_new: int, *, max_len: int,
                       page_size: int, window: int, lo: int = 0) -> int:
    """Pages reserved at admission: every row the request can ever write, or
    for window configs the O(window) live span from logical page `lo`."""
    rows = min(max_len, plen + max_new)
    full = -(-rows // page_size)
    if not window:
        return full
    return min(full - lo, window_page_budget(window, page_size))


def recycle_dead_pages(mapping: Dict[int, int], cap: int, page_size: int,
                       window: int, progress: int):
    """Sliding-window recycle core: pages fully below `progress - window`
    remap to the slot's next logical page while it has unwritten pages below
    `cap`, else leave the mapping. Mutates `mapping`; returns
    ([(j_dead, j_new, phys)] remaps, [(j_dead, phys)] unmaps)."""
    dead = sorted(j for j in mapping
                  if (j + 1) * page_size <= progress - window)
    remaps, unmaps = [], []
    if not dead:
        return remaps, unmaps
    nxt = max(mapping) + 1
    for j in dead:
        phys = mapping.pop(j)
        if nxt < cap:
            mapping[nxt] = phys
            remaps.append((j, nxt, phys))
            nxt += 1
        else:
            unmaps.append((j, phys))
    return remaps, unmaps


def page_row_of(mapping: Dict[int, int], pages_per_seq: int) -> np.ndarray:
    """(pages_per_seq,) physical-page row: mapped pages, null page 0 rest."""
    row = np.zeros((pages_per_seq,), np.int32)
    for j, p in mapping.items():
        row[j] = p
    return row


# ---------------------------------------------------------------------------
# Prefix cache: content addressing for page-aligned prompt prefixes. The key
# of logical page j is a digest chain, sha1(prev || page-j tokens), seeded by
# the request's non-token prefill inputs: two requests share page j iff their
# prefixes up to (j + 1) * page_size match.
# ---------------------------------------------------------------------------

def request_seed_digest(extras: Optional[Dict[str, np.ndarray]]) -> bytes:
    """Chain seed covering every non-token prefill input; b'' without any."""
    if not extras:
        return b""
    h = hashlib.sha1()
    for key in sorted(extras):
        arr = np.ascontiguousarray(np.asarray(extras[key]))
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.digest()


def prefix_digests(lp: np.ndarray, page_size: int, n_pages: int,
                   seed: bytes = b"") -> List[bytes]:
    """Digest chain of the first `n_pages` full pages of token prefix `lp`."""
    out, d = [], seed
    for j in range(n_pages):
        d = hashlib.sha1(
            d + lp[j * page_size:(j + 1) * page_size].tobytes()).digest()
        out.append(d)
    return out


def lookup_prefix_hits(by_hash: Dict[bytes, int], lp: np.ndarray,
                       page_size: int, seed: bytes = b"") -> List[int]:
    """Longest cached run over lp's full prompt pages: the hit physical
    pages in logical order, up to the first miss."""
    n_cand = lp.shape[0] // page_size
    hits: List[int] = []
    if not n_cand:
        return hits
    for d in prefix_digests(lp, page_size, n_cand, seed=seed):
        p = by_hash.get(d)
        if p is None:
            break
        hits.append(p)
    return hits


def prefix_share_plan(plen: int, hits: List[int], page_size: int):
    """(n_shared, cow_src): hit pages shared outright, and the one cloned.
    tail = (plen - 1) // page_size is the page the replay decode writes,
    never shared; a hit there (plen % page_size == 0 only) is cloned into a
    private page instead of recomputed."""
    tail = (plen - 1) // page_size
    n_shared = min(len(hits), tail)
    cow_src = hits[tail] if len(hits) > tail else None
    return n_shared, cow_src


def register_prefix_pages(mapping: Dict[int, int], lp: np.ndarray,
                          page_size: int, seed: bytes,
                          page_hash: Dict[int, bytes],
                          by_hash: Dict[bytes, int]) -> None:
    """Register a fully prefilled slot's full prompt pages in the
    (page_hash, by_hash) registry. The first registration of a key wins; a
    page already keying another prefix keeps its key."""
    n_full = lp.shape[0] // page_size
    if not n_full:
        return
    digests = prefix_digests(lp, page_size, n_full, seed=seed)
    for j in range(n_full):
        phys = mapping.get(j)
        if phys is None or digests[j] in by_hash or phys in page_hash:
            continue
        page_hash[phys] = digests[j]
        by_hash[digests[j]] = phys


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 16
    # extra prefill inputs: vlm 'patch_embeds' (P, d_model), encdec
    # 'frames' (cross_len, d_model)
    extras: Optional[Dict[str, np.ndarray]] = None
    # the prefix cache's chain seed, `request_seed_digest(extras)`, hashed
    # once at submit
    seed_digest: bytes = b""
    # sampling: temperature 0 = greedy argmax; top_k 0 and top_p 1.0 are off
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # logit processors: repetition penalty over prompt + emitted tokens
    # (1.0 = off) and an additive per-token bias
    rep_penalty: float = 1.0
    logit_bias: Optional[Dict[int, float]] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_enqueue: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    first_token_tick: Optional[int] = None
    # prompt tokens served from the prefix cache at (last) admission
    cached_prompt_tokens: int = 0
    # fault tolerance: times preempted, retired by TTL rather than by
    # completion, the tick of submit (the TTL clock) and a per-request TTL
    preemptions: int = 0
    timed_out: bool = False
    submit_tick: int = 0
    ttl_ticks: Optional[int] = None
    # f32 logits rows of every decode step, before the logit processors
    # (only with keep_logits=True)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list,
                                                   repr=False)

    def live_prompt(self) -> np.ndarray:
        """The tokens a (resumed) request prefills: prompt plus every token
        already emitted. The re-prefilled rows equal the ones its decode
        steps wrote and sampling continues at counter len(out_tokens), so a
        preempted stream is token-exact with its uninterrupted twin."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])

    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.out_tokens)


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0           # requests admitted into prefill
    decode_steps: int = 0
    tokens_out: int = 0
    occupancy_sum: float = 0.0
    prefill_compiles: int = 0   # monolithic prefill steps built: one a
    #                             bucket (recurrent: a prompt length)
    decode_compiles: int = 0    # decode steps captured (greedy, sampled)
    paste_compiles: int = 0     # paste steps built: one a bucket length
    chunk_compiles: int = 0     # chunk steps captured: ONE (fixed shapes)
    prefill_chunks: int = 0     # chunk-prefill invocations
    pages_in_use: int = 0       # currently reserved pages
    peak_pages_in_use: int = 0
    decode_stall_ticks: int = 0
    prefill_tokens: int = 0     # real prompt tokens prefilled
    prefill_pad_tokens: int = 0  # padded prefill rows (chunk waste)
    preemptions: int = 0        # decoding slots evicted for a starving head
    retries: int = 0            # re-admissions of preempted work
    timeouts: int = 0           # requests retired by TTL
    rejected: int = 0           # submits refused at the queue cap
    faults_injected: int = 0    # FaultPlan events applied
    # the sharded engine's recovery and live page migration (one host
    # leaves them at 0)
    recoveries: int = 0         # slots migrated off a draining/dead shard
    recovery_ticks_sum: int = 0  # requeue -> back-live latency, summed
    migrations: int = 0         # live slots re-homed by page moves
    migrated_pages: int = 0     # physical pages moved across shards
    migrated_bytes_compressed: float = 0.0  # UCIe wire bytes (post-compress)
    rebalance_events: int = 0   # elastic-rebalance slot moves
    prefix_hits: int = 0        # admissions that reused >= 1 cached page
    prefix_misses: int = 0      # admissions with zero cached pages
    prefix_hit_tokens: int = 0  # prompt tokens served from cached pages
    prefix_evictions: int = 0   # refcount-zero cached pages reclaimed
    cow_copies: int = 0         # tail pages cloned instead of recomputed
    prefix_cached_pages: int = 0  # gauge: refcount-zero pages retained
    # raw seconds, one entry per completed request; summary() collapses
    # them to p50/p99
    ttft_s: List[float] = dataclasses.field(default_factory=list, repr=False)
    tpot_s: List[float] = dataclasses.field(default_factory=list, repr=False)

    def record_request(self, r: Request) -> None:
        if r.t_first_token is not None:
            self.ttft_s.append(r.t_first_token - r.t_enqueue)
            if r.t_done is not None and len(r.out_tokens) > 1:
                self.tpot_s.append((r.t_done - r.t_first_token)
                                   / (len(r.out_tokens) - 1))

    def summary(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["mean_occupancy"] = (self.occupancy_sum / self.decode_steps
                               if self.decode_steps else 0.0)
        d["pad_waste_ratio"] = (self.prefill_pad_tokens / self.prefill_tokens
                                if self.prefill_tokens else 0.0)
        d["mean_recovery_ticks"] = (self.recovery_ticks_sum / self.recoveries
                                    if self.recoveries else 0.0)
        for name in ("ttft_s", "tpot_s"):
            samples = d.pop(name)
            d[f"{name[:-2]}_p50_s"] = (
                float(np.percentile(samples, 50)) if samples else 0.0)
            d[f"{name[:-2]}_p99_s"] = (
                float(np.percentile(samples, 99)) if samples else 0.0)
        assert all(math.isfinite(v) for v in d.values()
                   if isinstance(v, (int, float))), d
        return d


class ServeEngine:
    """`params` is a float tree or one whose projections are already
    quantized (`ModelApi.init_int8`, `quantize_params`), which any
    `wdtype` keeps as it is; leaves already on the engine's device in their
    dtype are used as they are, not copied. `eager=True` runs every step
    per op, without CUDA graph capture."""

    # the hot loop's capture budgets for a fixed engine (the reference's):
    # "decode" the greedy and the lazily built sampled step, "chunk" the
    # ONE fixed-shape chunk step; enforced by
    # analysis/sanitizer.compile_budget(**COMPILE_BUDGETS). "prefill" and
    # "paste" build one step a bucket, O(log max_len) with traffic, held
    # against the bucket count by the tests, not here
    COMPILE_BUDGETS = {"decode": 2, "chunk": 1}

    def __init__(self, model, *, n_slots: int = 4, max_len: int = 128,
                 params=None, bucket_prompts: bool = True,
                 paged: Optional[bool] = None, page_size: int = 32,
                 n_pages: Optional[int] = None,
                 wdtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 chunked_prefill: Optional[bool] = None,
                 chunk_pages: int = 2,
                 prefix_cache: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 ttl_ticks: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 keep_logits: bool = False,
                 eager: bool = False,
                 device=None):
        self.model = model
        self.cfg = model.cfg
        self.device = resolve_device(device)
        if params is None:
            raise ValueError("ServeEngine needs params (model.init(seed) or "
                             "bridge.params_from_numpy)")
        self.n_slots = n_slots
        self.max_len = max_len
        if wdtype not in (None, "bf16", "int8"):
            raise ValueError(f"wdtype must be None/'bf16'/'int8', got {wdtype!r}")
        attn_family = self.cfg.family in _ATTN_FAMILIES
        if wdtype == "int8" and not attn_family:
            raise ValueError(f"wdtype='int8' applies to attention families, "
                             f"not {self.cfg.family!r}")
        params = engine_params(params, self.cfg, wdtype, self.device)
        self.wdtype = wdtype
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.kv_dtype = _KV_DTYPES[kv_dtype]
        if self.kv_dtype != torch.float32 and not attn_family:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} applies to attention-family KV "
                f"caches, not {self.cfg.family!r} recurrent state")
        self.params = params
        self.keep_logits = keep_logits
        self.stats = EngineStats()
        self._queue: List[Request] = []
        self._tick = 0               # engine tick counter (fault/TTL clock)
        self.max_queue = max_queue
        self.ttl_ticks = ttl_ticks
        self.fault_plan = fault_plan
        self._starved = 0            # consecutive page-starved ticks
        self._page_blocked = False   # head blocked on pages with a free slot
        self._stolen_pages: List[int] = []   # page_squeeze stash (shard 0)
        self._any_ttl = ttl_ticks is not None
        self._slots: List[Optional[Request]] = [None] * n_slots
        self._fresh: List[bool] = [False] * n_slots
        # slots whose replay of the prompt's last token rewrites its K/V
        # row: a vlm prompt that ends in a patch row (`_write_mask`)
        self._replay_writes = np.zeros((n_slots,), bool)
        self._active = np.zeros((n_slots,), bool)
        self._next_rid = 0
        # the attention families' causal KV caches are exact under
        # trailing padding (moe: pad rows take expert slots after every
        # real row's), so monolithic prefill may pad to a power-of-two
        # bucket and replay the last prompt token; recurrent state carries
        # through pads, so those families prefill at the exact length and
        # take the first token from the prefill logits
        self._replay = attn_family
        self.bucket_prompts = bucket_prompts and self._replay
        if paged and not attn_family:
            raise ValueError(f"paged KV applies to attention families, not "
                             f"{self.cfg.family!r}")
        self.paged = attn_family if paged is None else bool(paged)
        if self.paged and max_len % page_size != 0:
            if paged is None:
                # auto mode must not reject a max_len the dense engine
                # takes: the largest compatible page size, or dense if pages
                # would degenerate below 8 rows
                fit = math.gcd(min(page_size, max_len), max_len)
                if fit >= 8 or fit == max_len:
                    page_size = fit
                else:
                    self.paged = False
            else:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"page_size {page_size}")
        if self.kv_dtype == torch.float8_e5m2 and self.paged:
            raise ValueError(
                "kv_dtype fp8/e5m2 supports the dense cache layout only; "
                "pass paged=False (paged fp8 pools are a follow-on)")
        # sliding-window page recycling: paged slots map O(window) pages
        self._window = self.cfg.window if self.paged else 0
        if self.paged:
            self.page_size = page_size
            self.pages_per_seq = max_len // page_size
            # a pool below the worst case can starve the queue head, which
            # step() answers by preempting a decoding slot
            self.n_pages = (1 + n_slots * self.pages_per_seq
                            if n_pages is None else n_pages)
            if self.n_pages < 2:
                raise ValueError(f"n_pages {self.n_pages}: the pool needs "
                                 "the null page and one more")
            self._free_pages = list(range(self.n_pages - 1, 0, -1))
            self._slot_pages: List[Dict[int, int]] = [
                {} for _ in range(n_slots)]
            # highest logical page the request may ever write (exclusive)
            self._slot_cap = [0] * n_slots
            # ref-counted, content-addressed allocator: every non-null page
            # is free (ref 0, unregistered), mapped by >= 1 slot (ref >= 1)
            # or cached in the LRU (ref 0, registered, evictable)
            self._ref = np.zeros((self.n_pages,), np.int32)
            self._page_hash: Dict[int, bytes] = {}    # phys -> content key
            self._by_hash: Dict[bytes, int] = {}      # content key -> phys
            self._lru: "OrderedDict[int, None]" = OrderedDict()
        # in-flight prefix dedup: page digests a mid-prefill slot will
        # register, so identical prompts behind it wait for its pages
        self._pending_digest: Dict[bytes, int] = {}       # digest -> rid
        self._pending_by_rid: Dict[int, List[bytes]] = {}
        if chunked_prefill is None:
            self.chunked = self.paged
        else:
            self.chunked = bool(chunked_prefill)
            if self.chunked and not self.paged:
                raise ValueError("chunked_prefill requires a paged engine")
        self.chunk_pages = max(1, int(chunk_pages))
        if self.chunked and self._window:
            # windowed slots chunk one page at a time, so the window's page
            # budget also covers the chunk's write-ahead
            self.chunk_pages = 1
        # chunk token budget; for monolithic engines the stall-metric unit
        # (a prefill of blen tokens counts ceil(blen / chunk_tokens) chunk
        # equivalents of decode stall)
        self.chunk_tokens = (self.chunk_pages * page_size if self.paged
                             else min(64, max_len))
        # the prefix cache needs pages to share and the chunk resume; a
        # window turns it off (recycling rewrites remapped pages in place)
        if prefix_cache is None:
            self.prefix_cache = self.paged and self.chunked \
                and not self._window
        else:
            self.prefix_cache = bool(prefix_cache)
            if self.prefix_cache and not (self.paged and self.chunked):
                raise ValueError(
                    "prefix_cache requires a paged chunked-prefill engine "
                    f"(paged={self.paged}, chunked={self.chunked})")
            if self._window:
                self.prefix_cache = False
        self._prefill_fifo: List[int] = []
        self._chunk_next = [0] * n_slots
        self._tick_prefill_tokens = 0
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        # per-slot sampling state and logit processors (host-side; uploaded
        # to the device on ticks that sample)
        vocab = self.cfg.vocab_size
        self._temp = np.zeros((n_slots,), np.float32)
        self._topk = np.zeros((n_slots,), np.int32)
        self._topp = np.ones((n_slots,), np.float32)
        self._sseed = np.zeros((n_slots,), np.int32)
        self._rep_pen = np.ones((n_slots,), np.float32)
        self._seen = np.zeros((n_slots, vocab), bool)
        self._bias = np.zeros((n_slots, vocab), np.float32)
        self._bias_on = np.zeros((n_slots,), bool)
        if self.paged:
            shapes = model.cache_shape(n_slots, max_len, self.kv_dtype,
                                       page_size=page_size,
                                       n_pages=self.n_pages)
        else:
            shapes = model.cache_shape(n_slots, max_len, self.kv_dtype)
        self._cache = alloc_cache(shapes, self.device)
        self.eager = eager
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" and not eager
                            else None)
        B = n_slots
        self._decode_spec = {"tokens": ((B, 1), torch.int32),
                             "active": ((B,), torch.bool),
                             "write": ((B,), torch.bool)}
        self.steps = {"decode": self._step(
            ServeEngine._greedy_step, self._decode_spec, "decode")}
        if self.chunked:
            C, d = self.chunk_tokens, self.cfg.d_model
            spec = {"tokens": ((1, C), torch.int32),
                    "start": ((1,), torch.int32),
                    "length": ((1,), torch.int32),
                    "page_row": ((self.pages_per_seq,), torch.int32)}
            if self.cfg.family == "vlm":
                spec["patch_rows"] = ((1, C, d), torch.float32)
                spec["n_patch"] = ((1,), torch.int32)
            if self.cfg.family == "encdec":
                spec["slot"] = ((1,), torch.int64)
            self.steps["chunk"] = self._step(ServeEngine._chunk_step, spec,
                                             "chunk")
        # monolithic prefill and the paste, one step a signature. What a
        # prefill hands to its paste, by the paste's signature (a bucket
        # length's rows, or a recurrent state's leaves), in buffers kept by
        # (name, shape, dtype)
        self._handoff: Dict[object, object] = {}
        self._handoff_bufs: Dict[tuple, torch.Tensor] = {}
        family = dict(device=self.device, eager=eager, pool=self._graph_pool)
        if self._replay:
            self.steps["prefill"] = StepFamily(
                self, ServeEngine._prefill_step,
                state=ServeEngine._prefill_state, stat="prefill_compiles",
                label="prefill", **family)
            self.steps["paste"] = StepFamily(
                self, ServeEngine._paste_step,
                state=ServeEngine._paste_state, stat="paste_compiles",
                label="paste", **family)
        else:
            self.steps["prefill"] = StepFamily(
                self, ServeEngine._recurrent_prefill_step,
                state=lambda eng, key: tree_leaves(eng.params),
                stat="prefill_compiles", label="prefill", per_op=True,
                **family)
            self.steps["paste"] = StepFamily(
                self, ServeEngine._state_paste_step,
                state=ServeEngine._paste_state, stat="paste_compiles",
                label="paste", **family)
        if self.chunked and model.prefill_cross is not None:
            self.steps["cross"] = StepGraph(
                self, ServeEngine._cross_step,
                {"frames": ((1, self.cfg.cross_len, self.cfg.d_model),
                            torch.float32), "slot": ((1,), torch.int64)},
                state=ServeEngine._step_state, stat=None, label=None,
                **family)

    def _step(self, fn, spec, label) -> StepGraph:
        return StepGraph(self, fn, spec, state=ServeEngine._step_state,
                         stat=f"{label}_compiles", label=label,
                         device=self.device, eager=self.eager,
                         pool=self._graph_pool)

    def _step_state(self):
        """The tensors a captured step reads: the cache and the weights."""
        return tree_leaves([self._cache, self.params])

    # ------------------------------------------------------------- lifecycle
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               extras=None, sample_params: Optional[tuple] = None,
               seed: int = 0, ttl_ticks: Optional[int] = None,
               rep_penalty: float = 1.0,
               logit_bias: Optional[Dict[int, float]] = None) -> Request:
        """Queue a request. sample_params=(temperature, top_k, top_p) samples
        it (None: greedy) with its PRNG stream keyed by `seed`; rep_penalty
        != 1 penalizes its prompt and emitted tokens; logit_bias
        ({token: bias}) adds to their logits; `ttl_ticks` overrides the
        engine's TTL for this request. Degenerate sampling params and
        penalties clamp; malformed requests raise ValueError (nothing is
        enqueued) and a full queue raises EngineOverloaded. `extras`: the
        vlm family's `patch_embeds` (P, d_model) with P <= the prompt
        length, optional; the encdec family's `frames` (cross_len,
        d_model), required."""
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
        extras = self._check_extras(extras, prompt.shape[0])
        if self.paged:
            need = self._pages_for(prompt.shape[0], max_new_tokens)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {need} pages; pool has {self.n_pages - 1}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.stats.rejected += 1
            raise EngineOverloaded(
                f"admission queue at cap ({self.max_queue}); retry later")
        temperature, top_k, top_p = 0.0, 0, 1.0
        if sample_params is not None:
            temperature, top_k, top_p = clamp_sample_params(*sample_params)
        rep_penalty = clamp_rep_penalty(rep_penalty)
        for tok, bias in (logit_bias or {}).items():
            if not 0 <= int(tok) < self.cfg.vocab_size:
                raise ValueError(
                    f"logit_bias token {tok} outside vocab "
                    f"[0, {self.cfg.vocab_size})")
            if not math.isfinite(float(bias)):
                raise ValueError(
                    f"logit_bias[{tok}] must be finite, got {bias}")
        self._next_rid += 1
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, extras=extras,
                      seed_digest=request_seed_digest(extras),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed),
                      rep_penalty=rep_penalty,
                      logit_bias=dict(logit_bias) if logit_bias else None,
                      t_enqueue=time.time(), submit_tick=self._tick,
                      ttl_ticks=ttl_ticks)
        if ttl_ticks is not None:
            self._any_ttl = True
        self._queue.append(req)
        return req

    def _check_extras(self, extras, plen: int):
        return check_extras(self.cfg, extras, plen)

    def _pages_for(self, plen: int, max_new: int) -> int:
        """Pages reserved at admission (`reserve_page_count`). A paged
        monolithic window engine never backs the pages below the window's
        floor at the first decode step; a chunked one maps from page 0 and
        recycles forward between chunks."""
        lo = 0 if (self.chunked or not self._window) else self._live_lo(plen)
        return reserve_page_count(plen, max_new, max_len=self.max_len,
                                  page_size=self.page_size,
                                  window=self._window, lo=lo)

    def _live_lo(self, plen: int) -> int:
        """First logical page a window request can still read or write at its
        first decode step (the replay writes position plen - 1)."""
        return max(0, plen - 1 - self._window) // self.page_size

    def _window_pages(self) -> int:
        return window_page_budget(self._window, self.page_size)

    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self._cache))

    def _sample_state(self, slot: int, r: Request):
        self._temp[slot] = r.temperature
        self._topk[slot] = r.top_k
        self._topp[slot] = r.top_p
        self._sseed[slot] = r.seed
        self._rep_pen[slot] = r.rep_penalty
        self._bias[slot] = 0.0
        for tok, bias in (r.logit_bias or {}).items():
            self._bias[slot, int(tok)] = bias
        self._bias_on[slot] = bool(r.logit_bias)
        self._seen[slot] = False
        self._seen[slot, r.live_prompt()] = True

    def _admit(self):
        """Admit queued requests into free slots, FIFO. Paged engines reserve
        the request's pages up front, minus the prefix-cache hits it shares;
        if the allocatable pages cannot cover the queue head, admission
        waits. Chunked engines prefill the prompt one chunk per tick in
        `_prefill_tick`, from the first page the cache did not hold; a full
        hit goes live at once. Monolithic engines prefill it here, padded to
        its bucket, paste its rows and replay its last token at position
        plen - 1 in the next decode step. A resumed (preempted) request
        admits on its live prompt and remaining budget, which reserve the
        pages it first reserved. A head short of pages while a slot is free
        sets `_page_blocked`, which step() counts toward preemption."""
        self._page_blocked = False
        for slot in [i for i, r in enumerate(self._slots) if r is None]:
            if not self._queue:
                return
            r = self._queue[0]
            lp = r.live_prompt()
            plen = lp.shape[0]
            rem = r.remaining_new()
            page_row = None
            r.cached_prompt_tokens = 0
            digs, hits = None, []
            if self.paged:
                need = self._pages_for(plen, rem)
                hits = self._prefix_lookup(r, lp)
                n_cand = plen // self.page_size if self.prefix_cache else 0
                if len(hits) < n_cand:
                    digs = prefix_digests(lp, self.page_size, n_cand,
                                          r.seed_digest)
                    owner = self._pending_digest.get(digs[len(hits)])
                    if owner is not None and owner != r.rid:
                        # in-flight dedup: a live slot is prefilling the
                        # head's first missing page right now; wait for it
                        return
                n_shared, cow_src = prefix_share_plan(plen, hits,
                                                      self.page_size)
                shared = hits[:n_shared]
                n_private = need - n_shared
                # hit pages in the LRU leave the allocatable set when they
                # are increfed (cow_src too, pinned during the clone)
                pinned = sum(1 for p in shared if self._ref[p] == 0)
                if cow_src is not None and self._ref[cow_src] == 0:
                    pinned += 1
                if self.pages_allocatable() - pinned < n_private:
                    self._page_blocked = True
                    return
                for p in shared:
                    self._incref(p)
                if cow_src is not None:
                    self._incref(cow_src)
                pages = [self._alloc_page() for _ in range(n_private)]
                if cow_src is not None:
                    # copy-on-write: the replay decode writes row plen - 1,
                    # so a fully cached tail page is cloned, not shared
                    self.stats.cow_copies += 1
                    copy_pool_page(self._cache, cow_src, pages[0])
                    self._decref_page(cow_src)
                lo = self._live_lo(plen) \
                    if (self._window and not self.chunked) else 0
                mapping = {j: p for j, p in enumerate(shared)}
                for i, p in enumerate(pages):
                    mapping[lo + n_shared + i] = p
                self._slot_pages[slot] = mapping
                self._slot_cap[slot] = -(-min(self.max_len, plen + rem)
                                         // self.page_size)
                cached = (n_shared + (cow_src is not None)) * self.page_size
                r.cached_prompt_tokens = cached
                if self.prefix_cache:
                    if cached:
                        self.stats.prefix_hits += 1
                        self.stats.prefix_hit_tokens += cached
                    else:
                        self.stats.prefix_misses += 1
                page_row = self._page_row(slot)
            self._queue.pop(0)
            self.stats.prefills += 1
            self.stats.prefill_tokens += plen - r.cached_prompt_tokens
            self._sample_state(slot, r)
            self._slots[slot] = r
            if self.chunked:
                # the slot's cache table row stays on the null page
                # (decode's writes for it cannot touch reserved pages) until
                # _go_live
                self._active[slot] = False
                self._fresh[slot] = False
                self._chunk_next[slot] = r.cached_prompt_tokens
                if self.model.prefill_cross is not None:
                    # the encoder and cross K/V, once a request (a full
                    # prefix hit too): every chunk and decode step reads
                    # the slot's cross rows
                    self.steps["cross"](frames=r.extras["frames"],
                                        slot=slot)
                if r.cached_prompt_tokens >= plen:
                    # full hit: every prompt page is in the pool (shared run
                    # + cloned tail); zero chunks, the first token comes
                    # from this tick's decode
                    self._register_prefix(slot, r, lp)
                    self._go_live(slot, lp, page_row)
                else:
                    self._prefill_fifo.append(slot)
                    if digs is not None:
                        # claim the pages this slot will register
                        mine = self._pending_by_rid.setdefault(r.rid, [])
                        for d in digs[len(hits):]:
                            if d not in self._pending_digest:
                                self._pending_digest[d] = r.rid
                                mine.append(d)
                continue
            blen = bucket_length(plen, self.max_len) if self.bucket_prompts \
                else plen
            toks = np.zeros((1, blen), np.int32)
            toks[0, :plen] = lp
            # the step's signature: the bucket of tokens and the extras'
            # shapes (a vlm prompt's patch count), as the reference's
            # prefill jit is keyed
            spec = {"tokens": ((1, blen), torch.int32)}
            values = {"tokens": toks}
            for name, arr in sorted((r.extras or {}).items()):
                spec[name] = ((1, *arr.shape), torch.float32)
                values[name] = arr
            key = tuple((name, shape) for name, (shape, _) in spec.items())
            out = self.steps["prefill"](key, spec, **values)
            self._tick_prefill_tokens += blen
            if not self._replay:
                self._admit_recurrent(slot, r, lp, *out)
                continue
            self.stats.prefill_pad_tokens += blen - plen
            # rows [0, plen) are exact under trailing padding; pad rows >=
            # plen are masked by kv_len until decode overwrites them. The
            # paste stamps the slot's page row and replay position.
            spec = {"slot": ((1,), torch.int64), "pos": ((1,), torch.int32)}
            values = {"slot": slot, "pos": plen - 1}
            if page_row is not None:
                spec["page_row"] = ((self.pages_per_seq,), torch.int32)
                values["page_row"] = page_row
            self.steps["paste"](blen, spec, **values)
            self._go_live(slot, lp, page_row, stamped=True)

    def _admit_recurrent(self, slot: int, r: Request, lp: np.ndarray,
                         logits: torch.Tensor, pf) -> None:
        """The recurrent families' admission after the exact-length prefill:
        the first token from the prefill logits (the logit processors, then
        the sampler at counter 0; greedy takes the argmax), the state pasted
        whole into the slot at position plen, and a request done at
        admission (its budget spent, or no row left) retired without a
        decode step."""
        plen = lp.shape[0]
        lv = logits[:, -1, :self.cfg.vocab_size].float()
        if r.rep_penalty != 1.0 or r.logit_bias:
            lv = apply_logit_processors(
                lv, self._tensor([r.rep_penalty], torch.float32),
                self._tensor(self._seen[slot][None], torch.bool),
                self._tensor(self._bias[slot][None], torch.float32))
        if r.temperature > 0:
            first = int(sample_tokens(
                lv, self._tensor([r.temperature], torch.float32),
                self._tensor([r.top_k]),
                self._tensor([r.top_p], torch.float32),
                self._tensor([r.seed]), self._tensor([0]))[0])
        else:
            first = int(torch.argmax(lv[0]))
        # the state's hand-off: the paste step reads it at fixed addresses
        leaves = []
        for path, _, _ in self._state_leaves():
            leaf = pf
            for k in path:
                leaf = leaf[k]
            leaves.append(leaf)
        key = tuple((tuple(t.shape), t.dtype) for t in leaves)
        hand = self._handoff.get(key)
        if hand is None:
            hand = self._handoff[key] = [torch.empty_like(t) for t in leaves]
        for dst, src in zip(hand, leaves):
            dst.copy_(src)
        self.steps["paste"](key, {"slot": ((1,), torch.int64),
                                  "pos": ((1,), torch.int32)},
                            slot=slot, pos=plen)
        r.out_tokens.append(first)
        if self.keep_logits:
            r.logits.append(logits[0, -1, :self.cfg.vocab_size].float().cpu())
        if r.t_first_token is None:
            r.t_first_token = time.time()
            r.first_token_tick = self._tick
        self._next_tok[slot, 0] = first
        self._seen[slot, first] = True
        self.stats.tokens_out += 1
        if plen >= self.max_len or len(r.out_tokens) >= r.max_new_tokens:
            # done at admission: no writable row for a decode step, or the
            # prefill's token spent the budget; never occupy a decode slot
            r.done = True
            r.t_done = time.time()
            self.stats.record_request(r)
            self._release(slot)
            return
        self._fresh[slot] = False
        self._active[slot] = True

    # ------------------------------------------- monolithic prefill, paste
    def _prefill_step(self, inp, key):
        """The monolithic prefill of signature `key`: the bucket's tokens
        (and the request's patch rows or frames) through the cache-only
        prefill; int8 and other lossy KV attend the rounded values the cache
        will hold. Writes the rows the paste reads into the bucket's hand-off
        buffers, allocated by the first call, outside every graph."""
        batch = dict(inp)
        if self.kv_dtype != torch.float32:
            batch["kv_round"] = self.kv_dtype
        pf = self.model.prefill_cache(self.params, batch)
        blen = inp["tokens"].shape[1]
        keys = [k for k in (*pool_data_keys(pf), "ck", "cv") if k in pf]
        rows = self._handoff.get(blen)
        if rows is None:
            # buffers by shape: the cross rows (cross_len, not blen) are one
            # pair for every bucket
            rows = {}
            for k in keys:
                buf = (k, tuple(pf[k].shape), pf[k].dtype)
                if buf not in self._handoff_bufs:
                    self._handoff_bufs[buf] = torch.empty_like(pf[k])
                rows[k] = self._handoff_bufs[buf]
            self._handoff[blen] = rows
        for k in keys:
            rows[k].copy_(pf[k])

    def _prefill_state(self, key):
        """What a prefill step reads and writes: the weights and its bucket's
        hand-off buffers."""
        blen = key[0][1][1]
        return tree_leaves([self.params, self._handoff.get(blen) or {}])

    def _paste_step(self, inp, blen):
        """The paste of bucket length `blen`: the hand-off rows into the
        slot (`inp['slot']`, (1,) int64), its page row and replay position
        stamped."""
        self._paste(self._handoff[blen], inp["slot"], inp.get("page_row"))
        if "page_row" in inp:
            self._cache["page_table"].index_copy_(0, inp["slot"],
                                                  inp["page_row"][None])
        self._cache["pos"].index_copy_(0, inp["slot"], inp["pos"])

    def _paste_state(self, key):
        """What a paste step reads and writes: the cache and the hand-off
        buffers of its signature."""
        return tree_leaves([self._cache, self._handoff.get(key) or {}])

    def _recurrent_prefill_step(self, inp, key):
        """The recurrent families' exact-length prefill (per op): (logits,
        state)."""
        return self.model.prefill(self.params, dict(inp))

    def _state_paste_step(self, inp, key):
        """Copy the hand-off of a (B=1) recurrent prefill state whole into
        the slot, in the cache's dtypes, and stamp its position: ssm
        {'h', 'conv': {x, b, c}} (L, B, ...) leaves, hybrid each layer's
        {'h', 'conv'} or ring {'k', 'v'} (B, ...)."""
        slot = inp["slot"]
        for (_, dst, dim), src in zip(self._state_leaves(),
                                      self._handoff[key]):
            dst.index_copy_(dim, slot, src.to(dst.dtype))
        self._cache["pos"].index_copy_(0, slot, inp["pos"])

    def _state_leaves(self):
        """The recurrent state leaves a slot owns, as (path in the prefill
        state, cache tensor, slot axis)."""
        cache = self._cache
        if self.cfg.family == "ssm":
            return [(("h",), cache["h"], 1)] + [
                (("conv", k), cache["conv"][k], 1)
                for k in sorted(cache["conv"])]
        return [(("layers", i, k), layer[k], 0)
                for i, layer in enumerate(cache["layers"])
                for k in sorted(layer)]

    def _cross_step(self, inp):
        """The encoder and every layer's cross K/V of a chunked
        encoder-decoder admission, pasted into the slot's dense cross rows
        in the cross cache's dtype."""
        cross = self.model.prefill_cross(self.params,
                                         {"frames": inp["frames"]})
        for key in ("ck", "cv"):
            dst = self._cache[key]
            dst.index_copy_(1, inp["slot"], cross[key].to(dst.dtype))

    def _paste(self, pf, slot: torch.Tensor,
               page_row: Optional[torch.Tensor]):
        """Write a (B=1) prefill cache's rows into the slot's rows (dense:
        rows [0, blen) of the slot; paged: page by page into the mapped
        pages of `page_row`, rows of unmapped pages on null page 0). `slot`
        is a (1,) int64 and `page_row` a (pages_per_seq,) int32 tensor on
        the device. int8 caches quantize the rows per (position, kv head),
        the map the decode write applies, so every layout holds the same
        bytes. An encdec prefill's cross K/V ('ck', 'cv') go whole into the
        slot's dense cross rows, in the cross cache's dtype."""
        for key in ("ck", "cv"):
            if key in pf:
                dst = self._cache[key]
                dst.index_copy_(1, slot, pf[key].to(dst.dtype))
        if "k" not in pf:
            return
        blen = pf["k"].shape[2]
        if page_row is not None:
            idx = torch.arange(blen, device=self.device)
            dst = (slice(None), page_row[idx // self.page_size].long(),
                   idx % self.page_size)
        for key in pool_data_keys(pf):
            rows = pf[key][:, 0]                        # (L, blen, KV, D)
            pairs = [(key, rows)]
            if key + "s" in self._cache:
                q, sc = quantize_kv_rows(rows)
                pairs = [(key, q), (key + "s", sc)]
            for name, val in pairs:
                pool = self._cache[name]
                val = val.to(pool.dtype)
                if page_row is None:
                    # e5m2 rows as their bytes (no index_copy_ of fp8)
                    rows_of = (lambda t: t.view(torch.uint8)) \
                        if pool.dtype == torch.float8_e5m2 else (lambda t: t)
                    rows_of(pool[:, :, :blen]).index_copy_(
                        1, slot, rows_of(val[:, None]))
                else:
                    pool[dst] = val

    def _go_live(self, slot: int, lp: np.ndarray,
                 page_row: Optional[np.ndarray], stamped: bool = False):
        """Prefill done: stamp the slot's real page row (paged) and its
        replay position plen - 1 (a paste step has `stamped` them); the
        next decode step replays lp[-1] there and emits the first token."""
        if not stamped:
            if page_row is not None:
                self._cache["page_table"][slot] = self._tensor(page_row)
            self._cache["pos"][slot] = lp.shape[0] - 1
        self._next_tok[slot, 0] = int(lp[-1])
        self._fresh[slot] = True
        self._active[slot] = True
        r = self._slots[slot]
        pe = (r.extras or {}).get("patch_embeds")
        self._replay_writes[slot] = pe is not None \
            and pe.shape[0] >= lp.shape[0]

    def cancel(self, req: Request) -> None:
        """Retire a request at any stage with exact pool accounting."""
        if req.done:
            return
        if req in self._queue:
            self._queue.remove(req)
        elif req in self._slots:
            self._release(self._slots.index(req))
        req.done = True
        req.t_done = time.time()

    def _release(self, slot: int):
        """Free a finished slot: drop its in-flight claims and sampling
        state; a paged slot returns its page references and points its
        table row at the null page."""
        if self._slots[slot] is not None:
            self._clear_pending(self._slots[slot].rid)
        self._slots[slot] = None
        self._active[slot] = False
        self._fresh[slot] = False
        self._replay_writes[slot] = False
        self._temp[slot], self._topk[slot] = 0.0, 0
        self._topp[slot], self._sseed[slot] = 1.0, 0
        self._rep_pen[slot] = 1.0
        self._bias[slot], self._bias_on[slot] = 0.0, False
        self._seen[slot] = False
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        self._chunk_next[slot] = 0
        if not self.paged:
            return
        for phys in self._slot_pages[slot].values():
            self._decref_page(phys)
        self._slot_pages[slot] = {}
        self._cache["page_table"][slot] = 0

    # ------------------------------------------------ ref-counted allocator
    def pages_allocatable(self) -> int:
        """Pages an admission can obtain now: the free list plus every
        refcount-zero cached page (evictable on demand)."""
        return len(self._free_pages) + len(self._lru)

    def _unregister(self, phys: int):
        h = self._page_hash.pop(phys, None)
        if h is not None and self._by_hash.get(h) == phys:
            del self._by_hash[h]

    def _page_live(self, d: int):
        self.stats.pages_in_use += d
        if d > 0:
            self.stats.peak_pages_in_use = max(
                self.stats.peak_pages_in_use, self.stats.pages_in_use)
        self.stats.prefix_cached_pages = len(self._lru)

    def _alloc_page(self) -> int:
        """One private page: pop the free list, else evict the least
        recently used cached page. Callers check `pages_allocatable()`
        first."""
        if self._free_pages:
            p = self._free_pages.pop()
        else:
            p, _ = self._lru.popitem(last=False)    # oldest first
            self._unregister(p)
            self.stats.prefix_evictions += 1
        self._ref[p] = 1
        self._page_live(+1)
        return p

    def _incref(self, phys: int):
        if self._ref[phys] == 0:
            # a cached page comes back live: out of the LRU
            self._lru.pop(phys, None)
            self._page_live(+1)
        self._ref[phys] += 1

    def _decref_page(self, phys: int):
        self._ref[phys] -= 1
        assert self._ref[phys] >= 0, int(phys)
        if self._ref[phys] == 0:
            self._page_live(-1)
            if self.prefix_cache and phys in self._page_hash:
                # registered content survives at refcount zero in the LRU
                self._lru[phys] = None
            else:
                self._unregister(phys)
                self._free_pages.append(phys)
        self.stats.prefix_cached_pages = len(self._lru)

    def _prefix_lookup(self, r: Request, lp: np.ndarray) -> List[int]:
        if not self.prefix_cache:
            return []
        return lookup_prefix_hits(self._by_hash, lp, self.page_size,
                                  seed=r.seed_digest)

    def _register_prefix(self, slot: int, r: Request, lp: np.ndarray):
        """Register the slot's fully prefilled full prompt pages. Decode
        writes only positions >= plen - 1, so pages below the tail never
        change again; a plen % page_size == 0 tail page takes the replay's
        rewrite of row plen - 1."""
        self._clear_pending(r.rid)
        if not self.prefix_cache:
            return
        register_prefix_pages(self._slot_pages[slot], lp, self.page_size,
                              r.seed_digest, self._page_hash, self._by_hash)

    def _clear_pending(self, rid: int) -> None:
        """Drop a request's in-flight dedup claims (registered, or the slot
        died mid-prefill) so identical requests stop waiting on it."""
        for d in self._pending_by_rid.pop(rid, ()):
            if self._pending_digest.get(d) == rid:
                del self._pending_digest[d]

    def assert_accounting(self):
        """Every non-null page is in exactly one of {free list, live (mapped
        by >= 1 slot), cached LRU, stolen stash}; mapping references equal
        the refcounts; the pages_in_use gauge equals the live count; every
        LRU page is registered. Paged engines only."""
        assert self.paged, "a dense engine has no page pool"
        free, lru = set(self._free_pages), set(self._lru)
        live = {p for m in self._slot_pages for p in m.values()}
        stolen = set(self._stolen_pages)
        assert len(free) == len(self._free_pages), "free list duplicates"
        sets = (free, lru, live, stolen)
        for i, a in enumerate(sets):
            assert 0 not in a, "null page leaked into the pool"
            for b in sets[i + 1:]:
                assert not (a & b), (free, lru, live, stolen)
        assert len(free) + len(lru) + len(live) + len(stolen) \
            == self.n_pages - 1, (len(free), len(lru), len(live),
                                  len(stolen), self.n_pages)
        refs = np.zeros_like(self._ref)
        for m in self._slot_pages:
            for p in m.values():
                refs[p] += 1
        assert np.array_equal(refs, self._ref), (refs, self._ref)
        assert self.stats.pages_in_use == len(live), \
            (self.stats.pages_in_use, len(live))
        for p in self._lru:
            assert p in self._page_hash, p

    # ---------------------------------------------------------------- prefill
    def _page_row(self, slot: int) -> np.ndarray:
        return page_row_of(self._slot_pages[slot], self.pages_per_seq)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _prefill_tick(self) -> bool:
        """Run AT MOST ONE fixed-size prefill chunk (FIFO over mid-prefill
        slots; the head slot finishes all its chunks first)."""
        if not self._prefill_fifo:
            return False
        slot = self._prefill_fifo[0]
        r = self._slots[slot]
        s = self._chunk_next[slot]
        lp = r.live_prompt()
        plen = lp.shape[0]
        C = self.chunk_tokens
        if self._window and s:
            # free or remap pages no chunk row >= s can read; the cache's
            # table row is still null, so this is host bookkeeping only
            self._recycle_slot_pages(slot, s, in_cache=False)
        n = min(C, plen - s)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = lp[s:s + n]
        page_row = self._page_row(slot)
        inputs = {"tokens": toks, "start": s, "length": n,
                  "page_row": page_row}
        if self.cfg.family == "vlm":
            inputs.update(chunk_patch_rows(r, s, C, self.cfg.d_model))
        if self.cfg.family == "encdec":
            inputs["slot"] = slot
        self.steps["chunk"](**inputs)
        self.stats.prefill_chunks += 1
        self.stats.prefill_pad_tokens += C - n
        self._tick_prefill_tokens += C
        if s + C >= plen:                      # final chunk — slot goes live
            self._prefill_fifo.pop(0)
            # the slot's full prompt pages are final: register them before
            # decode starts appending
            self._register_prefix(slot, r, lp)
            self._go_live(slot, lp, page_row)
        else:
            self._chunk_next[slot] = s + C
        return True

    # ----------------------------------------------------------------- decode
    def _write_mask(self) -> np.ndarray:
        """(B,) bool: the slots whose K/V row this decode step writes. A
        slot replaying its prompt's last token finds row plen - 1 already
        in its pages, written by prefill (or by the request that registered
        a cloned tail page); the replay does not rewrite it, so a
        registered page holds prefill's bytes, the ones a request that
        shares it would have computed itself (ROADMAP C2). A vlm prompt
        whose last position is a patch row is the exception: the replay
        computes that row from the last token's embedding and writes it,
        as every replay of the reference does."""
        return ~np.asarray(self._fresh) | self._replay_writes

    def _chunk_step(self, inp):
        """The captured chunk step: one fixed-size chunk of the slot whose
        page row, start and length are in `inp`, written into the pools in
        place."""
        self.model.prefill_chunk(self.params, dict(inp), self._cache)

    def _decode_core(self, inp) -> torch.Tensor:
        """Batched decode; freed slots keep their stream position (an idle
        tick is a no-op for them), written in place. Returns the (B, vocab)
        logits."""
        pos = self._cache["pos"]
        logits, _ = self.model.decode(
            self.params, {"tokens": inp["tokens"], "write": inp["write"]},
            self._cache)
        new = self._cache["pos"]
        self._cache["pos"] = pos
        pos.copy_(torch.where(inp["active"], new, pos))
        return logits[:, -1, :self.cfg.vocab_size]

    def _greedy_step(self, inp):
        """The captured greedy decode step: (tokens and positions (2, B)
        int32, logits (B, vocab))."""
        logits = self._decode_core(inp)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack([toks, self._cache["pos"]]), logits

    def _sampled_step(self, inp):
        """The captured sampled decode step: the logit processors (the
        identity for a slot with penalty 1 and no bias, so its row is
        greedy's), then the batched sampler; greedy rows take the argmax of
        the processed logits. The counter is each slot's output-token
        index."""
        logits = self._decode_core(inp)
        lv = apply_logit_processors(logits.float(), inp["rep_pen"],
                                    inp["seen"], inp["bias"])
        toks = sample_tokens(lv, inp["temp"], inp["topk"], inp["topp"],
                             inp["seed"], inp["counter"])
        return torch.stack([toks, self._cache["pos"]]), logits

    def _sampled(self) -> StepGraph:
        """The sampled decode step, built on the first tick that samples."""
        step = self.steps.get("decode_sampled")
        if step is None:
            B, V = self.n_slots, self.cfg.vocab_size
            spec = dict(self._decode_spec,
                        temp=((B,), torch.float32), topk=((B,), torch.int32),
                        topp=((B,), torch.float32), seed=((B,), torch.int32),
                        counter=((B,), torch.int32),
                        rep_pen=((B,), torch.float32),
                        seen=((B, V), torch.bool), bias=((B, V), torch.float32))
            step = self.steps["decode_sampled"] = self._step(
                ServeEngine._sampled_step, spec, "decode")
        return step

    def step(self) -> bool:
        """One tick: apply the fault plan's events, retire expired TTLs,
        admit (preempting a younger decoding slot once the head has starved
        on pages for PREEMPT_AFTER ticks), at most one prefill chunk, one
        batched decode."""
        self._tick += 1
        if self.fault_plan is not None:
            self._apply_faults()
        if self._any_ttl:
            self._expire_ttl()
        had_decode = bool(np.any(self._active))
        self._tick_prefill_tokens = 0
        self._admit()
        if self._page_blocked:
            self._starved += 1
            if self._starved >= PREEMPT_AFTER and self._preempt_once():
                self._admit()
        else:
            self._starved = 0
        chunk_ran = self._prefill_tick() if self.chunked else False
        if had_decode and self._tick_prefill_tokens > self.chunk_tokens:
            self.stats.decode_stall_ticks += \
                -(-self._tick_prefill_tokens // self.chunk_tokens) - 1
        decoding = [i for i, r in enumerate(self._slots)
                    if r is not None and self._active[i]]
        if not decoding:
            return chunk_ran
        inputs = {"tokens": self._next_tok, "active": self._active,
                  "write": self._write_mask()}
        if any(self._temp[i] > 0 or self._rep_pen[i] != 1.0
               or self._bias_on[i] for i in decoding):
            inputs.update(
                temp=self._temp, topk=self._topk, topp=self._topp,
                seed=self._sseed, rep_pen=self._rep_pen, seen=self._seen,
                bias=self._bias,
                counter=[len(r.out_tokens) if r is not None else 0
                         for r in self._slots])
            tok_pos, logits = self._sampled()(**inputs)
        else:
            tok_pos, logits = self.steps["decode"](**inputs)
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(decoding) / self.n_slots
        # ONE host sync per step: tokens and positions together
        nxt, pos = tok_pos.cpu().numpy()
        if self.keep_logits:
            rows = logits.float().cpu()
        for slot in decoding:
            r = self._slots[slot]
            r.out_tokens.append(int(nxt[slot]))
            if self.keep_logits:
                r.logits.append(rows[slot])
            self._next_tok[slot, 0] = nxt[slot]
            self._seen[slot, int(nxt[slot])] = True   # rep-penalty tracking
            self.stats.tokens_out += 1
            if self._fresh[slot]:
                if r.t_first_token is None:
                    r.t_first_token = time.time()
                    r.first_token_tick = self._tick
                self._fresh[slot] = False
            if len(r.out_tokens) >= r.max_new_tokens \
                    or int(pos[slot]) >= self.max_len:
                r.done = True
                r.t_done = time.time()
                self.stats.record_request(r)
                self._release(slot)
        if self._window:
            self._recycle_window_pages(pos)
        return True

    def _recycle_window_pages(self, pos):
        """Free pages that fell fully out of the attention window of every
        decoding slot, on the already-synced `pos` (mid-prefill slots
        recycle on chunk progress in `_prefill_tick`)."""
        for slot, r in enumerate(self._slots):
            if r is None or not self._active[slot] \
                    or not self._slot_pages[slot]:
                continue
            self._recycle_slot_pages(slot, int(pos[slot]), in_cache=True)

    def _recycle_slot_pages(self, slot: int, progress: int, *, in_cache: bool):
        """Recycle one slot's dead pages given `progress`, the next write
        index. A dead page remaps to the slot's next logical page (its stale
        rows sit at positions >= kv_len until overwritten) or, once the
        request's span is mapped, returns to the pool. `in_cache` mirrors the
        change into the cache's page-table row (False while the slot is
        mid-prefill and its row is still null)."""
        remaps, unmaps = recycle_dead_pages(
            self._slot_pages[slot], self._slot_cap[slot],
            self.page_size, self._window, progress)
        for _, phys in unmaps:
            self._decref_page(phys)
        if in_cache:
            table = self._cache["page_table"]
            for j, nxt, phys in remaps:
                table[slot, j] = 0
                table[slot, nxt] = phys
            for j, _ in unmaps:
                table[slot, j] = 0

    # ------------------------------------------------------ fault tolerance
    def _apply_faults(self):
        """Apply this tick's FaultPlan events. The single-host engine is
        shard 0 of a one-shard fleet: it honours the page-pool events and
        ignores the shard-level ones."""
        for e in self.fault_plan.events_at(self._tick):
            if not self.paged or e.shard != 0:
                continue
            if e.kind == "page_squeeze":
                # free pages first; once the free list is dry, evict
                # refcount-zero cached pages, oldest first
                take = min(e.pages, self.pages_allocatable())
                for _ in range(take):
                    if self._free_pages:
                        p = self._free_pages.pop()
                    else:
                        p, _ = self._lru.popitem(last=False)
                        self._unregister(p)
                        self.stats.prefix_evictions += 1
                    self._stolen_pages.append(p)
                self.stats.prefix_cached_pages = len(self._lru)
                self.stats.faults_injected += 1
            elif e.kind == "page_restore":
                self._free_pages.extend(self._stolen_pages)
                self._stolen_pages.clear()
                self.stats.faults_injected += 1

    def _expire_ttl(self):
        """Retire queued and live requests past their TTL (ticks since
        submit); they release their slot and pages as a completed request
        does, and `timed_out` marks them."""
        def expired(r: Request) -> bool:
            ttl = r.ttl_ticks if r.ttl_ticks is not None else self.ttl_ticks
            return ttl is not None and self._tick - r.submit_tick > ttl

        for r in [q for q in self._queue if expired(q)]:
            self._queue.remove(r)
            r.done = r.timed_out = True
            r.t_done = time.time()
            self.stats.timeouts += 1
        for slot, r in enumerate(self._slots):
            if r is not None and expired(r):
                r.done = r.timed_out = True
                r.t_done = time.time()
                self.stats.timeouts += 1
                self._release(slot)

    def _requeue(self, r: Request):
        """Re-enqueue a preempted request in rid order: ahead of anything
        younger."""
        i = 0
        while i < len(self._queue) and self._queue[i].rid < r.rid:
            i += 1
        self._queue.insert(i, r)

    def _preempt_once(self) -> bool:
        """Evict one decoding slot so the starving queue head can admit: the
        youngest live decoding slot that is younger than the head, under its
        preemption budget, and whose exclusively owned pages (plus the
        allocatable ones) cover the head's need. Only younger slots are
        victims, so a preempted request that becomes head never preempts an
        older one (no livelock). The victim's tokens ride along in
        out_tokens and re-enter as prefill (`Request.live_prompt`)."""
        if not self._queue:
            return False
        head = self._queue[0]
        hlp = head.live_prompt()
        need = self._pages_for(hlp.shape[0], head.remaining_new())
        # only the head's private pages must come out of the victim and the
        # allocatable set; shared hits in the LRU are pinned at admission
        hits = self._prefix_lookup(head, hlp)
        n_shared, cow_src = prefix_share_plan(hlp.shape[0], hits,
                                              self.page_size)
        need -= n_shared
        need += sum(1 for p in hits[:n_shared] if self._ref[p] == 0)
        if cow_src is not None and self._ref[cow_src] == 0:
            need += 1
        best = None
        for slot, r in enumerate(self._slots):
            if r is None or not self._active[slot] \
                    or slot in self._prefill_fifo:
                continue
            if r.rid <= head.rid or r.preemptions >= MAX_PREEMPTIONS:
                continue
            # a shared page only drops a reference at release
            exclusive = sum(1 for p in self._slot_pages[slot].values()
                            if self._ref[p] == 1)
            if exclusive + self.pages_allocatable() < need:
                continue
            if best is None or r.rid > self._slots[best].rid:
                best = slot
        if best is None:
            return False
        victim = self._slots[best]
        victim.preemptions += 1
        self._release(best)
        self._requeue(victim)
        self.stats.preemptions += 1
        self.stats.retries += 1
        self._starved = 0
        return True

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        ticks = 0
        while (self._queue or any(r is not None for r in self._slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.stats


def generate_greedy(model, params, prompt: np.ndarray, n_tokens: int,
                    max_len: int = 128, paged: bool = False,
                    wdtype: Optional[str] = None,
                    kv_dtype: Optional[str] = None,
                    extras=None) -> List[int]:
    """Single-request reference path (the oracle for engine equivalence),
    on the model's device.

    Bucketing OFF (exact-length prefill) and a DENSE cache by default, so
    that a bucketed, paged or chunked engine held to it runs its padded-
    prefill + replay, page-table and chunk-streaming paths against another
    path. With wdtype/kv_dtype this is the dense int8 oracle: row
    quantization does not depend on layout or schedule (prefill attends the
    rounded rows the cache stores), so a paged or chunked int8 engine must
    reproduce its tokens exactly. It runs per op (`eager=True`), so a
    captured engine is held to an execution that shares none of its
    graphs."""
    eng = ServeEngine(model, n_slots=1, max_len=max_len, params=params,
                      bucket_prompts=False, paged=paged, wdtype=wdtype,
                      kv_dtype=kv_dtype, eager=True, device=model.device)
    req = eng.submit(prompt, max_new_tokens=n_tokens, extras=extras)
    eng.run_to_completion()
    return req.out_tokens


def chunk_patch_rows(r: Request, start: int, C: int, d: int):
    """A vlm chunk's patch inputs: the request's patch embeddings of the
    chunk's positions below n_patch as (1, C, d) f32 rows (zeros past
    them), and n_patch."""
    pe = (r.extras or {}).get("patch_embeds")
    n_patch = 0 if pe is None else pe.shape[0]
    rows = np.zeros((1, C, d), np.float32)
    if start < n_patch:
        m = min(C, n_patch - start)
        rows[0, :m] = pe[start:start + m]
    return {"patch_rows": rows, "n_patch": n_patch}


def check_extras(cfg, extras, plen: int):
    """The extra prefill inputs the model's family takes, as numpy arrays
    (None without any); ValueError on anything else."""
    d = cfg.d_model
    want = {"vlm": {"patch_embeds"}, "encdec": {"frames"}}.get(
        cfg.family, set())
    extras = {k: np.asarray(v) for k, v in (extras or {}).items()}
    if set(extras) - want:
        raise ValueError(f"extras {sorted(set(extras) - want)}: family "
                         f"{cfg.family!r} takes {sorted(want)}")
    if cfg.family == "encdec" and "frames" not in extras:
        raise ValueError("an encdec request needs extras['frames'] "
                         f"({cfg.cross_len}, {d})")
    pe = extras.get("patch_embeds")
    if pe is not None and (pe.ndim != 2 or pe.shape[1] != d
                           or pe.shape[0] > plen):
        raise ValueError(f"patch_embeds {pe.shape}: (P, {d}) with P <= "
                         f"the prompt length {plen}")
    fr = extras.get("frames")
    if fr is not None and fr.shape != (cfg.cross_len, d):
        raise ValueError(f"frames {fr.shape}: ({cfg.cross_len}, {d})")
    return extras or None


def engine_params(params, cfg, wdtype: Optional[str], device):
    """An engine's weights on `device`: with wdtype "int8" the projections
    quantized (`quantize_params`; already quantized leaves as they are),
    with "bf16" the float leaves in bf16. Leaves already on the device in
    their dtype are used as they are, not copied."""
    params = _to_device(params, device)
    if wdtype == "int8":
        from repro_torch.models.quantized import quantize_params
        return quantize_params(params, cfg)
    if wdtype == "bf16":
        return _map_float(params, torch.bfloat16)
    return params


def _map_float(tree, dtype):
    """Float leaves to `dtype`; int8 leaves and their scales as they are."""
    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _map_float(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
