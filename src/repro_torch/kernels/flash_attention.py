"""Blockwise attention kernels: dense self-attention and chunk-prefill
attention through the page table. Each has two paths, chosen by a plan
function from q's dtype: bf16 q runs on the bf16 tensor cores (`mma.sync`
m16n8k16, f32 accumulators), f32 q keeps a CUDA-core f32 body, since bf16
fragments would round an f32 q beyond the f32 tolerance (1e-4). The
tensor-core path holds a warp's Q fragments and (16, D) accumulator in
registers up to head_dim 128; above it (head_dim 160-256) and for MLA
latent rows (keys 576 wide, values their first 512 columns, one pool as
k and v) it runs "wide": Q stays in shared memory and a block of
`WIDE_WARPS` = 8 warps computes each score of its row tile once, warps w
and w + 4 each scoring half of a 64-key tile's keys for the same 16 rows
and sharing P through shared memory, then each accumulating half of the
value columns, so a block writes every output column of its rows and no
grid dimension counts output columns. The CUDA-core path takes up to 8
query heads a kv head and head_dim 128.

`flash_attention_cuda` replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention` (dense (B, H, Sq, D)
queries against (B, H, Sk, D) keys and values: self-attention, causal
and/or windowed, or unmasked with Sq != Sk, the encoder-decoder's cross
attention). The CUDA kernel is
`csrc/flash_attention.cu`. Tensor-core path (`dense_plan`): the chunk
kernel's design over contiguous K/V, one 4-warp block per (split of
`SPLIT` = 128 keys, 64 query rows, batch·head), row tiles launched heaviest
first, the splits merged in order by the last block of a row tile (scratch
and semaphores as below), the mask applied only on tiles that cross a
diagonal, window edge or S; at head_dim 160-256 one wide block per (64
rows, batch·head) walks the row tile's splits and merges them itself.
CUDA-core path: one block per (batch·head, 16 query rows) over 32-key f32
tiles. Splits follow Sk and row tiles Sq, so an unmasked row's splits are
those of all Sk keys whatever Sq is: a row's result depends on its query
and the keys only. Both take any S (ragged tail tiles are zero-filled and
masked), where the TPU kernel needs S to be
a multiple of its block. The serving engine's monolithic prefill reaches it
through `models.attention.attention`.

`flash_attention_paged_cuda` replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention_paged`. The CUDA kernel
is `csrc/flash_attention_paged.cu`. Tensor-core path (`chunk_plan`): the C
chunk rows × G query heads of a kv head are packed into 64-row tiles, and a
4-warp block takes one row tile and one split of `SPLIT` = 128 keys (two
64-key tiles, copied by `cp.async` after one page-table read per page);
with more than one live split the last block of a row tile merges the
splits' (m, l, acc) from scratch allocated here in split order, in the same
launch (`_build.semaphores`). CUDA-core path: one block per (sequence, kv
head, four chunk rows) over 32-key f32 tiles. Masks: causal by global
position `q_offset[b] + i`, bounded by the live `kv_len`, optional window;
rows with no valid key give zeros. At the serving chunk it is bound by the
bytes of the live K/V rows.

Tiles and splits lie at absolute key positions and their length is a
constant, and both tensor-core paths run the same tile and merge code
(`csrc/attn_mma.cuh`), so a row's sums run in an order fixed by its own
positions: a chunk row equals the same row run alone as a one-row chunk,
the first S' rows of a causal dense run equal a run at S', and a row of a
dense causal run equals the chunk kernel's row over the same K/V values
(a float pool holding them, or an int8 pool whose rows dequantize to them
in bf16), bit for bit.

The plain PyTorch versions are `repro_torch.kernels.ref.flash_attention_ref`
(dense) and `flash_attention_paged_plain` below: the oracles on the card and
the paths for CPU tensors (via `kernels.ops.flash_attention` and
`models.attention.chunk_attention_paged`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    _KVDT, _KVNAME, _QDT, MAX_HEAD_DIM, NARROW_GROUP, NEG_INF, _ptr,
    check_attention_operands, gathered_kv, rounded_probs)

# launches of the paged CUDA kernel, keyed by pool dtype ("f32", "int8",
# ...); only `flash_attention_paged_cuda` adds to it
LAUNCHES: Counter = Counter()
# launches of the dense CUDA kernel, keyed by q dtype ("f32", "bf16"), with
# "/unmasked" appended for a call with no causal mask and no window (the
# encoder-decoder's encoder and cross attention); only
# `flash_attention_cuda` adds to it
DENSE_LAUNCHES: Counter = Counter()
# the head dims csrc/flash_attention.cu takes (bf16: all; f32: up to 128)
DENSE_HEAD_DIMS = tuple(range(32, MAX_HEAD_DIM + 1, 32))
NARROW_HEAD_DIM = 128   # the tensor-core paths hold Q and O in registers
KEY_TILE = 64      # keys per K/V tile of both tensor-core paths (MT_KEYS)
ROW_TILE = 64      # rows of a tensor-core block, both kernels (CROWS, MQ)
SPLIT = 128        # keys per split of both tensor-core paths (MT_SPLIT)
WIDE_WARPS = 8     # warps of a wide block: four pairs (WT_WARPS)
_PATHS = {"cuda_core": 0, "mma": 1, "wide": 2}
_fn = None
_dense_fn = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _path(dtype: torch.dtype, d: int, dv: int) -> str:
    """bf16 q → tensor cores: "mma" for head_dim up to 128 (Q and O in
    registers), "wide" above it and for latent rows (Q in shared memory,
    pairs of warps splitting a tile's keys, then its value columns); f32 q
    → CUDA cores (bf16 fragments would round it beyond the f32
    tolerance)."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "mma" if d <= NARROW_HEAD_DIM and dv == d else "wide"


class ChunkPlan(NamedTuple):
    path: str        # "mma"/"wide" (tensor cores) or "cuda_core"
    row_tiles: int   # tiles of ROW_TILE packed (chunk row, query head) rows
    splits: int      # splits of SPLIT keys over the pool's depth (tensor cores)
    dv: int = 0      # output columns a block accumulates: all (tensor cores)

    @property
    def warps(self) -> int:
        """Warps a block: WIDE_WARPS on the wide path, 4 otherwise."""
        return WIDE_WARPS if self.path == "wide" else 4

    def grid(self, b: int, kv: int, c: int):
        """The launch grid: (splits, row tiles, B·KV) on the tensor cores,
        (B·KV, four chunk rows a block) on the CUDA cores."""
        if self.path != "cuda_core":
            return (max(self.splits, 1), self.row_tiles, b * kv)
        return (b * kv, _cdiv(c, 4))

    def scratch_floats(self, b: int, kv: int) -> int:
        """f32 partials of every packed row of every split: acc[dv], then
        (m, l)."""
        if self.path == "cuda_core":
            return 0
        return b * kv * self.row_tiles * max(self.splits, 1) * ROW_TILE \
            * (self.dv + 2)

    def semaphores(self, b: int, kv: int) -> int:
        if self.path == "cuda_core":
            return 0
        return b * kv * self.row_tiles


def chunk_plan(c: int, g: int, depth: int, dtype: torch.dtype, d: int = 64,
               dv: Optional[int] = None) -> ChunkPlan:
    """The path, row tiles and splits of a chunk of `c` rows with `g` query
    heads per kv head and head_dim `d` (values `dv` wide, latent rows)
    against a pool `depth` = pages_per_seq × page_size rows deep. The
    split length is the constant SPLIT: never a function of the batch, the
    chunk or a row."""
    dv = d if dv is None else dv
    path = _path(dtype, d, dv)
    tiles, splits = _cdiv(c * g, ROW_TILE), _cdiv(depth, SPLIT)
    return ChunkPlan(path, tiles, splits, dv if path != "cuda_core" else 0)


def row_tile_keys(q_offset: int, kv_len: int, c: int, g: int, window: int,
                  tile: int):
    """[lo, hi) of the keys that some row of packed row tile `tile` sees, as
    the chunk kernel computes it (hi <= lo: no row has a valid key)."""
    first = tile * ROW_TILE // g
    last = (min(c * g, (tile + 1) * ROW_TILE) - 1) // g
    hi = min(q_offset + last + 1, kv_len)
    lo = max(0, q_offset + first - window + 1) if window > 0 else 0
    return lo, hi


def live_splits(lo: int, hi: int) -> range:
    """The splits a row tile with keys [lo, hi) runs: those that hold one of
    its keys, merged in this order."""
    if hi <= lo:
        return range(0)
    return range(lo // SPLIT, _cdiv(hi, SPLIT))


class DensePlan(NamedTuple):
    path: str        # "mma"/"wide" (tensor cores) or "cuda_core"
    grid: tuple      # the launch grid
    splits: int      # splits of SPLIT keys over S (tensor cores)
    dv: int = 0      # output columns a block accumulates: all (tensor cores)

    @property
    def warps(self) -> int:
        """Warps a block: WIDE_WARPS on the wide path, 4 otherwise."""
        return WIDE_WARPS if self.path == "wide" else 4

    def scratch_floats(self) -> int:
        """f32 partials of every row of every split: acc[dv], then (m, l)."""
        if self.path == "cuda_core":
            return 0
        # (row tiles x batch·heads): the grid without its split dimension
        tiles_bh = self.grid[1] * self.grid[2] if self.path == "mma" \
            else self.grid[0] * self.grid[1]
        return self.splits * tiles_bh * ROW_TILE * (self.dv + 2)

    def semaphores(self) -> int:
        """One a (row tile, batch·head) whose splits are separate blocks
        ("mma"); the wide path's block walks its own splits and needs
        none."""
        return self.grid[1] * self.grid[2] if self.path == "mma" else 0


def dense_plan(bh: int, sq: int, sk: int, dtype: torch.dtype, d: int = 64
               ) -> DensePlan:
    """Tensor cores, the chunk kernel's cut (`chunk_plan`), so that a row is
    summed in the same SPLIT-key groups and merged alike: up to head_dim
    128 one 4-warp block per (split, ROW_TILE rows, batch·head) ("mma");
    above it one WIDE_WARPS block per (batch·head, ROW_TILE rows) that
    walks the row tile's splits ("wide"); CUDA cores: one block per (16
    rows, batch·head). Splits come from the `sk` keys, row tiles from the
    `sq` query rows."""
    path = _path(dtype, d, d)
    splits, tiles = _cdiv(sk, SPLIT), _cdiv(sq, ROW_TILE)
    if path == "mma":
        return DensePlan(path, (splits, tiles, bh), splits, d)
    if path == "wide":
        return DensePlan(path, (bh, tiles), splits, d)
    return DensePlan(path, (_cdiv(sq, 16), bh), 0)


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention_paged").flash_attention_paged
        f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _dense_kernel():
    global _dense_fn
    if _dense_fn is None:
        f = _build.load("flash_attention").flash_attention
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _dense_fn = f
    return _dense_fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dense CUDA kernel (CUDA tensors only; no fallback).

    q (B, H, Sq, D), k/v (B, H, Sk, D), contiguous, one dtype (f32 or
    bf16), D in `DENSE_HEAD_DIMS`; query row i and key j are positions i and
    j from one origin. Sq != Sk only unmasked (`causal=False`, no window):
    a causal or windowed call over two lengths raises ValueError. Returns
    (B, H, Sq, D) in q.dtype."""
    if q.dtype not in _QDT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} (one of f32/bf16 for all three)")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: operands must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (q (B, H, "
                         "Sq, D), k and v (B, H, Sk, D), Sk >= 1)")
    b, h, s, d = q.shape
    sk = k.shape[2]
    if sk != s and (causal or window):
        raise ValueError(f"flash_attention: Sq {s} != Sk {sk} takes no mask "
                         f"(causal {causal}, window {window})")
    plan = dense_plan(b * h, s, sk, q.dtype, d)
    narrow = plan.path == "cuda_core" and d > NARROW_HEAD_DIM
    if d not in DENSE_HEAD_DIMS or narrow or max(plan.grid[1:]) > 65535:
        raise ValueError(f"flash_attention: head_dim {d} (takes "
                         f"{DENSE_HEAD_DIMS}, f32 up to {NARROW_HEAD_DIM}) or "
                         f"grid {plan.grid} (y and z at most 65535)")
    if plan.path != "cuda_core" and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention: bf16 operands must be 16-byte "
                         "aligned")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    part = sem = None
    if plan.path != "cuda_core":
        part = torch.empty(plan.scratch_floats(), dtype=torch.float32,
                           device=q.device)
        sem = _build.semaphores(q.device, plan.semaphores())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _dense_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(part),
        _ptr(sem), b * h, s, sk, d, int(bool(causal)), int(window), scale,
        _QDT[q.dtype], _PATHS[plan.path], plan.splits, stream)
    _build.check(status, "flash_attention")
    DENSE_LAUNCHES[_KVNAME[q.dtype]
                   + ("" if causal or window else "/unmasked")] += 1
    return out


def flash_attention_paged_cuda(q, k_pool, v_pool, page_table, q_offset,
                               kv_len, *, k_scale=None, v_scale=None,
                               window: int = 0,
                               scale: Optional[float] = None,
                               v_dim: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback).

    q (B,C,KV,G,D) f32|bf16; pools (n_pages,ps,KV,D) f32|bf16|int8 (int8
    with f16 `k_scale`/`v_scale` (n_pages,ps,KV)); page_table (B,pps),
    q_offset and kv_len (B,) int32. `v_dim` (MLA): one latent pool passed
    as both, values its rows' first v_dim columns (bf16 q). f32 q takes G
    <= 8 and head_dim <= 128. Returns (B,C,KV,G,v_dim or D) in q.dtype."""
    b, cq, nkv, g, d = q.shape
    q_offset = q_offset.to(torch.int32).reshape(-1).expand(b).contiguous()
    kv_len = kv_len.to(torch.int32).reshape(-1).expand(b).contiguous()
    check_attention_operands("flash_attention_paged", q, k_pool, v_pool,
                             k_scale, v_scale, [page_table, q_offset, kv_len],
                             v_dim=v_dim)
    if page_table.shape[0] != b:
        raise ValueError("page table batch differs from q")
    dv = d if v_dim is None else v_dim
    pps, ps = page_table.shape[1], k_pool.shape[1]
    plan = chunk_plan(cq, g, pps * ps, q.dtype, d, dv)
    if plan.path == "cuda_core" and (g > NARROW_GROUP or d > NARROW_HEAD_DIM
                                     or dv != d):
        raise ValueError(f"flash_attention_paged: f32 q takes at most "
                         f"{NARROW_GROUP} query heads per kv head and "
                         f"head_dim {NARROW_HEAD_DIM} (got G {g}, D {d}, "
                         f"v_dim {v_dim}); bf16 q takes all")
    if plan.path != "cuda_core" and (q.data_ptr() | k_pool.data_ptr()
                                     | v_pool.data_ptr()) % 16:
        raise ValueError("flash_attention_paged: q and pools must be 16-byte "
                         "aligned")
    if plan.row_tiles > 65535 or b * nkv > 65535:
        raise ValueError(f"flash_attention_paged: grid {plan.grid(b, nkv, cq)}"
                         " (y and z at most 65535)")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty((b, cq, nkv, g, dv), dtype=q.dtype, device=q.device)
    if cq == 0:
        return out
    part = sem = None
    if plan.path != "cuda_core":
        part = torch.empty(plan.scratch_floats(b, nkv), dtype=torch.float32,
                           device=q.device)
        sem = _build.semaphores(q.device, plan.semaphores(b, nkv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), page_table.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), _ptr(part), _ptr(sem), b, cq, nkv,
        g, d, dv, pps, ps, int(window), scale, _QDT[q.dtype],
        _KVDT[k_pool.dtype], _PATHS[plan.path], plan.splits, stream)
    _build.check(status, "flash_attention_paged")
    LAUNCHES[_KVNAME[k_pool.dtype]] += 1
    return out


def dense_and_chunked(q, k, v, pool_dtype, page_table, *, chunk: int = 64,
                      window: int = 0, v_dim: Optional[int] = None):
    """Causal attention of one prompt (under a sliding `window` if > 0)
    computed twice by the kernels (CUDA tensors): as a monolithic prefill
    and by the chunk kernel in S / `chunk` chunks against pools of
    `pool_dtype` holding the same rows through `page_table`. The
    monolithic side is the dense kernel over (1, KV·G, S, D) with K/V
    expanded per query head or, for MLA latent rows (`v_dim`: k the (S, 1,
    Dk) latent rows, v None), `models.attention.latent_attention`.

    q (1, S, KV, G, D) bf16; k, v (S, KV, D) f32 rows; page_table
    (1, S / page) int32 of physical pages from 1 (page = S / its width).
    The monolithic side attends what a monolithic prefill attends: the
    rows in bf16, or for an int8 pool the rows the pool stores, dequantized
    to bf16. Returns both as (1, S, KV, G, v_dim or D)."""
    from repro_torch.models.attention import latent_attention
    from repro_torch.models.quantized import (
        dequantize_kv_rows, quantize_kv_rows)
    _, s, nkv, g, d = q.shape
    pps = page_table.shape[1]
    ps = s // pps
    j = torch.arange(s, device=q.device)
    page, slot = page_table[0].long()[j // ps], j % ps
    pools, scales, dense = [], [], []
    for r in ((k,) if v_dim is not None else (k, v)):
        pool = torch.zeros(1 + pps, ps, nkv, d, dtype=pool_dtype,
                           device=q.device)
        if pool_dtype == torch.int8:
            rq, rs = quantize_kv_rows(r)
            sp = torch.zeros(1 + pps, ps, nkv, dtype=torch.float16,
                             device=q.device)
            pool[page, slot], sp[page, slot] = rq, rs
            scales.append(sp)
            dense.append(dequantize_kv_rows(rq, rs, torch.bfloat16))
        else:
            rb = r.to(torch.bfloat16)
            pool[page, slot] = rb.to(pool_dtype)
            scales.append(None)
            dense.append(rb)
        pools.append(pool)
    if v_dim is not None:
        pools, scales = pools * 2, scales * 2
        out_d = latent_attention(q, dense[0][None], v_dim, window=window)
    else:
        qd = q.reshape(1, s, nkv * g, d).transpose(1, 2).contiguous()
        kd, vd = (t.repeat_interleave(g, dim=1).transpose(0, 1)[None]
                  .contiguous() for t in dense)
        out_d = flash_attention_cuda(qd, kd, vd, window=window).transpose(
            1, 2).reshape(1, s, nkv, g, d)
    out_c = torch.empty_like(out_d)
    for c0 in range(0, s, chunk):
        out_c[:, c0:c0 + chunk] = flash_attention_paged_cuda(
            q[:, c0:c0 + chunk].contiguous(), pools[0], pools[1], page_table,
            torch.tensor([c0], dtype=torch.int32, device=q.device),
            torch.tensor([c0 + chunk], dtype=torch.int32, device=q.device),
            k_scale=scales[0], v_scale=scales[1], window=window, v_dim=v_dim)
    return out_d, out_c


def flash_attention_paged_plain(q, k_pool, v_pool, page_table, q_offset,
                                kv_len, *, k_scale=None, v_scale=None,
                                window: int = 0,
                                scale: Optional[float] = None,
                                v_dim: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain PyTorch chunk attention (port of the JAX reference branch,
    `repro/models/attention.py:292-317`), except that rows with no valid key
    give zeros, as the kernels on both machines do. fp8 pools are upcast
    after the gather; `v_dim`: values are the first v_dim columns of each
    row (MLA), and the probabilities round as `rounded_probs` says."""
    b, cq, nkv, g, d = q.shape
    kf, vf = gathered_kv(k_pool, v_pool, k_scale, v_scale, page_table, b,
                         nkv, v_dim)
    scale = scale if scale is not None else d ** -0.5
    smax = kf.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), kf) * scale
    dev = q.device
    q_pos = (q_offset.reshape(-1, 1).to(dev)
             + torch.arange(cq, device=dev)[None, :])              # (B, C)
    k_pos = torch.arange(smax, device=dev)
    ok = k_pos[None, None, :] <= q_pos[:, :, None]                 # causal
    ok &= k_pos[None, None, :] < kv_len.reshape(-1, 1, 1).to(dev)  # live rows
    if window > 0:
        ok &= q_pos[:, :, None] - k_pos[None, None, :] < window
    s = torch.where(ok[:, None, None, :, :], s,
                    torch.tensor(NEG_INF, device=dev))
    p = rounded_probs(torch.softmax(s, dim=-1)
                      * ok.any(-1)[:, None, None, :, None], v_pool, v_dim)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return o.to(q.dtype)
