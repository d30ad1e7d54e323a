"""Single-query (decode) attention against a ragged KV cache.

Replaces the TPU kernel `repro/kernels/decode_attention.py::decode_attention`
(all four pallas_call variants). The CUDA kernel is
`csrc/decode_attention.cu`, a split-KV (flash-decoding) design bound by the
bytes of the live K/V rows, which it reads once in their storage type:

1. One block per (split of `SPLIT` = 256 keys, sequence, kv head); splits
   outside `[kv_len - window, kv_len)` exit at once. Its four warps take two
   32-key tiles each, copied by 16-byte `cp.async` into a per-warp ring (the
   second tile is in flight while the first is scored), read the page table
   themselves (once per tile for a page-32 pool), dequantize int8 rows with
   their f16 scales on the shared-memory → register step, and keep an f32
   online softmax for the G query heads of the kv head. The block merges its
   warps in warp order and writes the split's (m, l, acc) to scratch.
2. The last live split of each (sequence, kv head) to finish, found with an
   atomic count on `_build.semaphores`, merges the live splits in
   split-index order into the output, in the same kernel.

The split length is a constant, never a function of the batch or of the
longest sequence: a sequence's output is bit-identical whether it is decoded
alone or in a batch, and the dense and paged layouts, which load the same
rows in the same order, give bit-identical outputs. One call is one kernel
launch and counts as one in `LAUNCHES`.

`decode_attention_plain` is the plain PyTorch version (the oracle on the card
and the path for CPU tensors, via `models.attention.decode_attention`).

Up to 8 query heads a kv head and head_dim up to 128 run the kernel above
(the narrow path). More heads (G <= 16), head_dim 160-256 and MLA latent
rows (one pool as k and v, keys 576 wide, values their first 512 columns)
run its wide path (`decode_plan`): one block per (split, sequence, kv head)
holds every query head, so each K/V row is read once. Rounds of 32-128
keys come through a two-stage `cp.async` ring; its warps score a round's
keys (four lanes a key on the CUDA cores, or, at 16 heads with bf16 q and
a bf16, int8 or e5m2 pool, as the 16 rows of m16n8k16 tensor-core
products, the pool's values being exact in bf16), the block keeps one f32
online softmax a head, and the warps accumulate p·v for their share of
the value columns. The splits and their merge are the narrow path's. fp8
(e5m2) caches are read by both paths, upcast exactly in the load.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel, keyed by variant ("paged/int8", "dense/f32",
# ...); only `decode_attention_cuda` adds to it
LAUNCHES: Counter = Counter()

NEG_INF = -1e30
SPLIT = 256        # keys per split (SPLIT in csrc/decode_attention.cu)
MAX_GROUP = 16     # query heads per kv head, any kernel
MAX_HEAD_DIM = 256  # head_dim, a multiple of 32 (or the latent row below)
NARROW_GROUP = 8   # the narrow decode path's heads (MAXG, csrc/attn_common.cuh)
NARROW_HEAD_DIM = 128   # ... and head_dim (32 · MAXE)
LATENT = (576, 512)     # MLA latent rows: key width, value width (v_dim)
_QDT = {torch.float32: 0, torch.bfloat16: 1}
_KVDT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
         torch.float8_e5m2: 3}
_KVNAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8",
           torch.float8_e5m2: "fp8"}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("decode_attention").decode_attention
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def n_splits(depth: int) -> int:
    """Splits of a cache `depth` rows deep (dense Smax, or pages_per_seq x
    page_size): the second dimension of the kernel's grid and scratch."""
    return -(-depth // SPLIT)


class DecodePlan(NamedTuple):
    path: str        # "narrow" or "wide" (csrc/decode_attention.cu)
    splits: int      # splits of SPLIT keys over the cache's depth
    groups: int      # blocks a (split, sequence, kv head): one, every head

    def semaphores(self, b: int, kv: int) -> int:
        return b * kv * self.groups


def decode_plan(g: int, d: int, dv: int, depth: int) -> DecodePlan:
    """The narrow path for G <= 8 and head_dim <= 128; the wide path for
    more heads, wider heads or latent rows (dv < d). On both, one block per
    (split, sequence, kv head) holds every head, and the split length is
    the constant SPLIT."""
    path = "narrow" if g <= NARROW_GROUP and d <= NARROW_HEAD_DIM and \
        dv == d else "wide"
    return DecodePlan(path, n_splits(depth), 1)


def check_attention_operands(name, q, k, v, k_scale, v_scale, ints,
                             v_dim: Optional[int] = None, fp8: bool = False):
    """Device/dtype/contiguity/shape checks shared by the attention kernels:
    G <= 16 query heads a kv head, head_dim a multiple of 32 up to 256, or
    MLA latent rows (`v_dim`: k and v one pool, LATENT's widths); fp8
    (e5m2) caches only where `fp8` (the decode kernel)."""
    if q.dtype not in _QDT:
        raise TypeError(f"{name}: q dtype {q.dtype} (f32/bf16 only)")
    if k.dtype not in _KVDT or v.dtype != k.dtype or \
            (k.dtype == torch.float8_e5m2 and not fp8):
        raise TypeError(f"{name}: cache dtypes {k.dtype}/{v.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise TypeError(f"{name}: int8 caches need f16 scales and only they")
    tensors = [q, k, v, *ints]
    if k_scale is not None:
        if k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16:
            raise TypeError(f"{name}: scales must be float16")
        if k_scale.shape != k.shape[:-1] or v_scale.shape != v.shape[:-1]:
            raise ValueError(f"{name}: scale shapes {tuple(k_scale.shape)} "
                             f"vs cache {tuple(k.shape)}")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index operands must be int32")
    d, g = q.shape[-1], q.shape[-2]
    if v_dim is None:
        ok = d % 32 == 0 and d <= MAX_HEAD_DIM
    else:
        ok = (d, v_dim) == LATENT and v is k and v_scale is k_scale
    if not ok or g > MAX_GROUP or k.shape != v.shape \
            or k.shape[-1] != d or k.shape[-2] != q.shape[-3]:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v_dim {v_dim} (head_dim a "
                         f"multiple of 32 up to {MAX_HEAD_DIM}, or latent "
                         f"rows {LATENT} as one pool; at most {MAX_GROUP} "
                         "query heads per kv head)")


def decode_attention_cuda(q, k_cache, v_cache, kv_len, *, page_table=None,
                          k_scale=None, v_scale=None, window: int = 0,
                          scale: Optional[float] = None,
                          v_dim: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback).

    q (B,1,KV,G,D) f32|bf16; caches (B,Smax,KV,D) dense or, with
    `page_table` (B,pages_per_seq) int32, (n_pages,ps,KV,D) pools, in
    f32|bf16|int8|float8_e5m2; int8 caches take f16 `k_scale`/`v_scale`
    shaped like the cache minus D; kv_len (B,) int32. `v_dim` (MLA): one
    latent pool passed as both caches, values its rows' first v_dim
    columns. Returns (B,1,KV,G,v_dim or D) in q.dtype."""
    b, sq, nkv, g, d = q.shape
    if sq != 1:
        raise ValueError(f"decode kernel takes one query position, got {sq}")
    kv_len = kv_len.to(torch.int32).reshape(-1).expand(b).contiguous()
    ints = [kv_len] if page_table is None else [kv_len, page_table]
    check_attention_operands("decode_attention", q, k_cache, v_cache,
                             k_scale, v_scale, ints, v_dim=v_dim, fp8=True)
    if page_table is None:
        smax, pps, ps = k_cache.shape[1], 0, 1
        if k_cache.shape[0] != b:
            raise ValueError("dense cache batch differs from q")
    else:
        smax, pps, ps = 0, page_table.shape[1], k_cache.shape[1]
        if page_table.shape[0] != b:
            raise ValueError("page table batch differs from q")
    if (k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: caches must be 16-byte aligned")
    dv = d if v_dim is None else v_dim
    plan = decode_plan(g, d, dv, smax or pps * ps)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty((b, 1, nkv, g, dv), dtype=q.dtype, device=q.device)
    part = torch.empty((b * nkv, max(plan.splits, 1), g, dv + 2),
                       dtype=torch.float32, device=q.device)
    sem = _build.semaphores(q.device, plan.semaphores(b, nkv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), _ptr(page_table), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), sem.data_ptr(), b, nkv, g, d, dv,
        smax, pps, ps, int(window), scale, plan.splits, _QDT[q.dtype],
        _KVDT[k_cache.dtype], int(plan.path == "wide"), stream)
    _build.check(status, "decode_attention")
    layout = "dense" if page_table is None else "paged"
    LAUNCHES[f"{layout}/{_KVNAME[k_cache.dtype]}"] += 1
    return out


def _gathered(cache, scale, page_table, b, nkv):
    """A cache (or pool through `page_table`) as a dense f32 view
    (B, S, KV, D), int8 rows dequantized with their scales."""
    d = cache.shape[-1]
    if page_table is not None:
        pt = page_table.long()
        cache = cache[pt].reshape(b, -1, nkv, d)
        if scale is not None:
            scale = scale[pt].reshape(b, -1, nkv)
    out = cache.float()
    if scale is not None:
        out = out * scale.float()[..., None]
    return out


def gathered_kv(k, v, k_scale, v_scale, page_table, b, nkv,
                v_dim: Optional[int] = None):
    """(keys, values) as dense f32 views (`_gathered`). One pool passed as
    both k and v (MLA latent rows) is gathered once, and `v_dim` keeps each
    value row's first v_dim columns."""
    kf = _gathered(k, k_scale, page_table, b, nkv)
    if v is k and v_scale is k_scale:
        vf = kf
    else:
        vf = _gathered(v, v_scale, page_table, b, nkv)
    return kf, (vf if v_dim is None else vf[..., :v_dim])


def rounded_probs(p, v, v_dim: Optional[int] = None):
    """The JAX branch rounds the probabilities to the value cache's dtype
    before PV (`repro/models/attention.py:234,315`): a bf16 (or f16) cache
    rounds them, an int8 (dequantized) or fp8 (upcast) view is f32 and does
    not. For MLA latent rows (`v_dim`) this plain path is the one the CPU
    serves (the JAX engine's comparison), so it rounds as the JAX branch;
    the kernels round a latent bf16 pool's probabilities too (the prefill
    kernels' bf16 P, the wide decode path's `round_p`), though unnormalized.
    For GQA it is the kernels' plain version and keeps f32 probabilities,
    as the decode kernel does."""
    if v_dim is None or v.dtype not in (torch.bfloat16, torch.float16):
        return p
    return p.to(v.dtype).float()


def decode_attention_plain(q, k_cache, v_cache, kv_len, *, page_table=None,
                           k_scale=None, v_scale=None, window: int = 0,
                           scale: Optional[float] = None,
                           v_dim: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch decode attention (port of the JAX reference branch,
    `repro/models/attention.py:200-236`): gather the page table to a dense
    view, dequantize (or upcast fp8), f32 masked softmax; kv_len == 0 gives
    zeros. `v_dim`: values are the first v_dim columns of each row (MLA),
    and the probabilities round as `rounded_probs` says."""
    b, _, nkv, g, d = q.shape
    kf, vf = gathered_kv(k_cache, v_cache, k_scale, v_scale, page_table, b,
                         nkv, v_dim)
    smax = kf.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), kf) * scale
    cur = kv_len.reshape(-1, 1).to(q.device)
    pos = torch.arange(smax, device=q.device)[None, :]
    valid = pos < cur
    if window > 0:
        valid &= pos >= cur - window
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = rounded_probs(p * (cur.reshape(-1, 1, 1, 1, 1) > 0), v_cache, v_dim)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return o.to(q.dtype)
