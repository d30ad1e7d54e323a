"""Single-host continuous-batching serving engine (port of
`repro/serve/engine.py`, the paged chunked-prefill path).

Each tick (`step`) admits queued requests into free slots by reserving their
pages up front (`_admit`), runs at most one fixed-size prefill chunk
(`_prefill_tick`: the chunk's K/V stream straight into the shared page pool
and chunk attention reads the slot's live pages), then one batched greedy
decode step over the live slots. Physical page 0 is the null page: retired
and mid-prefill slots point their page-table rows at it, so the batched
decode's writes for them can never touch a reserved page.

Pools and the page table are torch tensors on the engine's device, written
in place; the host keeps the authoritative free list and page mappings
(numpy / Python). One host sync per decode step brings back the tokens and
positions together.

Not in this slice (each raises NotImplementedError naming its ROADMAP item):
the prefix cache (A7; `prefix_cache=None` resolves to off), sampling and
logit processors (A8), fault plans / TTL / preemption (A11), the dense
`paged=False` and monolithic `chunked_prefill=False` engines (A6) and
sliding-window configs (A6).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import alloc_cache

_KV_DTYPES = {None: torch.float32, "f32": torch.float32,
              "float32": torch.float32, "bf16": torch.bfloat16,
              "bfloat16": torch.bfloat16, "int8": torch.int8}


def bucket_length(plen: int, max_len: int) -> int:
    """Next power of two ≥ plen, clipped to max_len."""
    b = 1
    while b < plen:
        b <<= 1
    return min(b, max_len)


def window_page_budget(window: int, page_size: int) -> int:
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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_enqueue: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    first_token_tick: Optional[int] = None
    # f32 logits rows of every decode step (only with keep_logits=True)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list,
                                                   repr=False)

    def live_prompt(self) -> np.ndarray:
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
    prefill_chunks: int = 0     # chunk-prefill invocations
    pages_in_use: int = 0       # currently reserved pages
    peak_pages_in_use: int = 0
    decode_stall_ticks: int = 0
    prefill_tokens: int = 0     # real prompt tokens prefilled
    prefill_pad_tokens: int = 0  # padded prefill rows (chunk waste)
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
        for name in ("ttft_s", "tpot_s"):
            samples = d.pop(name)
            d[f"{name[:-2]}_p50_s"] = (
                float(np.percentile(samples, 50)) if samples else 0.0)
            d[f"{name[:-2]}_p99_s"] = (
                float(np.percentile(samples, 99)) if samples else 0.0)
        assert all(math.isfinite(v) for v in d.values()
                   if isinstance(v, (int, float))), d
        return d


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not in this port yet (ROADMAP {item})")


class ServeEngine:
    def __init__(self, model, *, n_slots: int = 4, max_len: int = 128,
                 params=None, paged: Optional[bool] = None, page_size: int = 32,
                 n_pages: Optional[int] = None,
                 wdtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 chunked_prefill: Optional[bool] = None,
                 chunk_pages: int = 2,
                 prefix_cache: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 ttl_ticks: Optional[int] = None,
                 fault_plan=None,
                 keep_logits: bool = False,
                 device=None):
        self.model = model
        self.cfg = model.cfg
        self.device = resolve_device(device)
        if params is None:
            raise ValueError("ServeEngine needs params (model.init(seed) or "
                             "bridge.params_from_numpy)")
        if paged is False:
            _unported("the dense paged=False engine", "A6")
        if chunked_prefill is False:
            _unported("monolithic chunked_prefill=False prefill", "A6")
        if prefix_cache:
            _unported("the prefix cache", "A7")
        if fault_plan is not None or ttl_ticks is not None \
                or max_queue is not None:
            _unported("fault plans, TTLs and queue caps", "A11")
        if self.cfg.window:
            _unported("sliding-window page recycling", "A6")
        self.n_slots = n_slots
        self.max_len = max_len
        params = _to_device(params, self.device)
        if wdtype not in (None, "bf16", "int8"):
            raise ValueError(f"wdtype must be None/'bf16'/'int8', got {wdtype!r}")
        if wdtype == "int8":
            from repro_torch.models.quantized import quantize_params
            params = quantize_params(params, self.cfg)
        elif wdtype == "bf16":
            params = _map_float(params, torch.bfloat16)
        self.wdtype = wdtype
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.kv_dtype = _KV_DTYPES[kv_dtype]
        self.params = params
        self.keep_logits = keep_logits
        self.stats = EngineStats()
        self._queue: List[Request] = []
        self._tick = 0
        self._slots: List[Optional[Request]] = [None] * n_slots
        self._fresh: List[bool] = [False] * n_slots
        self._active = np.zeros((n_slots,), bool)
        self._next_rid = 0
        if max_len % page_size != 0:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"page_size {page_size}")
        self.paged = self.chunked = True
        self.prefix_cache = False
        self.page_size = page_size
        self.pages_per_seq = max_len // page_size
        self.n_pages = (1 + n_slots * self.pages_per_seq
                        if n_pages is None else n_pages)
        if self.n_pages < 1 + n_slots * self.pages_per_seq:
            # a pool below the worst case can starve the queue head, which
            # the reference answers by preempting a decoding slot
            _unported("pools below the worst case (preemption)", "A11")
        self._free_pages = list(range(self.n_pages - 1, 0, -1))
        self._slot_pages: List[Dict[int, int]] = [{} for _ in range(n_slots)]
        self._slot_cap = [0] * n_slots
        # ref-counted allocator: every non-null page is free (ref 0) or
        # mapped by >= 1 slot; slots hold references
        self._ref = np.zeros((self.n_pages,), np.int32)
        self.chunk_pages = max(1, int(chunk_pages))
        self.chunk_tokens = self.chunk_pages * page_size
        self._prefill_fifo: List[int] = []
        self._chunk_next = [0] * n_slots
        self._tick_prefill_tokens = 0
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        shapes = model.cache_shape(n_slots, max_len, self.kv_dtype,
                                   page_size=page_size, n_pages=self.n_pages)
        self._cache = alloc_cache(shapes, self.device)

    # ------------------------------------------------------------- lifecycle
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               extras=None, sample_params=None,
               ttl_ticks: Optional[int] = None, rep_penalty: float = 1.0,
               logit_bias=None) -> Request:
        """Queue a greedy request. Malformed requests raise ValueError."""
        if sample_params is not None or rep_penalty != 1.0 or logit_bias:
            _unported("sampling and logit processors", "A8")
        if extras:
            _unported("extra prefill inputs (vlm/encdec)", "A10")
        if ttl_ticks is not None:
            _unported("per-request TTLs", "A11")
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
        need = self._pages_for(prompt.shape[0], max_new_tokens)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages; pool has {self.n_pages - 1}")
        self._next_rid += 1
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, t_enqueue=time.time())
        self._queue.append(req)
        return req

    def _pages_for(self, plen: int, max_new: int) -> int:
        return reserve_page_count(plen, max_new, max_len=self.max_len,
                                  page_size=self.page_size, window=0)

    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._cache.values())

    def _admit(self):
        """Admit queued requests into free slots, FIFO. Each admission
        reserves the request's worst-case pages up front; if the free list
        cannot cover the queue head, admission waits. The prompt itself
        prefills one chunk per tick in `_prefill_tick`."""
        for slot in [i for i, r in enumerate(self._slots) if r is None]:
            if not self._queue:
                return
            r = self._queue[0]
            plen = r.live_prompt().shape[0]
            need = self._pages_for(plen, r.remaining_new())
            if len(self._free_pages) < need:
                return
            pages = [self._alloc_page() for _ in range(need)]
            self._slot_pages[slot] = dict(enumerate(pages))
            self._slot_cap[slot] = -(-min(self.max_len, plen + r.remaining_new())
                                     // self.page_size)
            self._queue.pop(0)
            self.stats.prefills += 1
            self.stats.prefill_tokens += plen
            # the slot's cache table row stays on the null page (decode's
            # writes for it cannot touch reserved pages) until _finalize
            self._slots[slot] = r
            self._active[slot] = False
            self._fresh[slot] = False
            self._chunk_next[slot] = 0
            self._prefill_fifo.append(slot)

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
        """Return a finished slot's pages and point its row at the null page."""
        self._slots[slot] = None
        self._active[slot] = False
        self._fresh[slot] = False
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        self._chunk_next[slot] = 0
        for phys in self._slot_pages[slot].values():
            self._decref_page(phys)
        self._slot_pages[slot] = {}
        self._cache["page_table"][slot] = 0

    # ------------------------------------------------ ref-counted allocator
    def _page_live(self, d: int):
        self.stats.pages_in_use += d
        if d > 0:
            self.stats.peak_pages_in_use = max(
                self.stats.peak_pages_in_use, self.stats.pages_in_use)

    def _alloc_page(self) -> int:
        p = self._free_pages.pop()
        self._ref[p] = 1
        self._page_live(+1)
        return p

    def _decref_page(self, phys: int):
        self._ref[phys] -= 1
        assert self._ref[phys] >= 0, int(phys)
        if self._ref[phys] == 0:
            self._page_live(-1)
            self._free_pages.append(phys)

    def pages_allocatable(self) -> int:
        return len(self._free_pages)

    def assert_accounting(self):
        """Every non-null page is in exactly one of {free list, live}; the
        per-page mapping references equal the refcounts; the pages_in_use
        gauge equals the live count."""
        free = set(self._free_pages)
        live = {p for m in self._slot_pages for p in m.values()}
        assert len(free) == len(self._free_pages), "free list duplicates"
        assert 0 not in free and 0 not in live, "null page leaked"
        assert not (free & live), (free, live)
        assert len(free) + len(live) == self.n_pages - 1, \
            (len(free), len(live), self.n_pages)
        refs = np.zeros_like(self._ref)
        for m in self._slot_pages:
            for p in m.values():
                refs[p] += 1
        assert np.array_equal(refs, self._ref), (refs, self._ref)
        assert self.stats.pages_in_use == len(live), \
            (self.stats.pages_in_use, len(live))

    # ---------------------------------------------------------------- prefill
    def _page_row(self, slot: int) -> np.ndarray:
        return page_row_of(self._slot_pages[slot], self.pages_per_seq)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _finalize(self, slot: int, pos: int, page_row: np.ndarray):
        """Last chunk done: stamp the slot's real page row and its replay
        position — only now does the slot become visible to decode."""
        self._cache["page_table"][slot] = self._tensor(page_row)
        self._cache["pos"][slot] = pos

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
        n = min(C, plen - s)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = lp[s:s + n]
        page_row = self._page_row(slot)
        batch = {"tokens": self._tensor(toks),
                 "start": self._tensor([s]),
                 "length": self._tensor([n]),
                 "page_row": self._tensor(page_row)}
        self._cache = self.model.prefill_chunk(self.params, batch, self._cache)
        self.stats.prefill_chunks += 1
        self.stats.prefill_pad_tokens += C - n
        self._tick_prefill_tokens += C
        if s + C >= plen:                      # final chunk — slot goes live
            self._prefill_fifo.pop(0)
            self._finalize(slot, plen - 1, page_row)
            self._next_tok[slot, 0] = int(lp[-1])
            self._fresh[slot] = True
            self._active[slot] = True
        else:
            self._chunk_next[slot] = s + C
        return True

    # ----------------------------------------------------------------- decode
    def _decode(self, tokens: torch.Tensor, active: torch.Tensor):
        """Batched greedy decode; freed slots keep their stream position
        (an idle tick is a no-op for them). Returns (tokens, pos, logits)."""
        old_pos = self._cache["pos"]
        logits, self._cache = self.model.decode(
            self.params, {"tokens": tokens}, self._cache)
        self._cache["pos"] = torch.where(active, self._cache["pos"], old_pos)
        logits = logits[:, -1, :self.cfg.vocab_size]
        return torch.argmax(logits, dim=-1).to(torch.int32), \
            self._cache["pos"], logits

    def step(self) -> bool:
        """One tick: admit, at most one prefill chunk, one batched decode."""
        self._tick += 1
        had_decode = bool(np.any(self._active))
        self._tick_prefill_tokens = 0
        self._admit()
        chunk_ran = self._prefill_tick()
        if had_decode and self._tick_prefill_tokens > self.chunk_tokens:
            self.stats.decode_stall_ticks += \
                -(-self._tick_prefill_tokens // self.chunk_tokens) - 1
        decoding = [i for i, r in enumerate(self._slots)
                    if r is not None and self._active[i]]
        if not decoding:
            return chunk_ran
        toks, pos, logits = self._decode(
            self._tensor(self._next_tok),
            torch.as_tensor(self._active).to(self.device))
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(decoding) / self.n_slots
        # ONE host sync per step: tokens and positions together
        nxt, pos = torch.stack([toks, pos]).cpu().numpy()
        if self.keep_logits:
            rows = logits.float().cpu()
        for slot in decoding:
            r = self._slots[slot]
            r.out_tokens.append(int(nxt[slot]))
            if self.keep_logits:
                r.logits.append(rows[slot])
            self._next_tok[slot, 0] = nxt[slot]
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
        return True

    def run_to_completion(self, max_ticks: int = 10_000) -> EngineStats:
        ticks = 0
        while (self._queue or any(r is not None for r in self._slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.stats


def _map_float(tree, dtype):
    if isinstance(tree, dict):
        return {k: _map_float(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
