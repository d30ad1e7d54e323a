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
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel, keyed by variant ("paged/int8", "dense/f32",
# ...); only `decode_attention_cuda` adds to it
LAUNCHES: Counter = Counter()

NEG_INF = -1e30
SPLIT = 256        # keys per split (SPLIT in csrc/decode_attention.cu)
MAX_GROUP = 8      # query heads per kv head (MAXG in csrc/attn_common.cuh)
_QDT = {torch.float32: 0, torch.bfloat16: 1}
_KVDT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KVNAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("decode_attention").decode_attention
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def n_splits(depth: int) -> int:
    """Splits of a cache `depth` rows deep (dense Smax, or pages_per_seq x
    page_size): the second dimension of the kernel's grid and scratch."""
    return -(-depth // SPLIT)


def check_attention_operands(name: str, q, k, v, k_scale, v_scale, ints):
    """Device/dtype/contiguity/shape checks shared by the attention kernels."""
    if q.dtype not in _QDT:
        raise TypeError(f"{name}: q dtype {q.dtype} (f32/bf16 only)")
    if k.dtype not in _KVDT or v.dtype != k.dtype:
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
    if d % 32 or d > 128 or g > MAX_GROUP or k.shape != v.shape \
            or k.shape[-1] != d or k.shape[-2] != q.shape[-3]:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (head_dim a multiple of 32 up "
                         f"to 128, at most {MAX_GROUP} query heads per kv "
                         "head)")


def decode_attention_cuda(q, k_cache, v_cache, kv_len, *, page_table=None,
                          k_scale=None, v_scale=None, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback).

    q (B,1,KV,G,D) f32|bf16; caches (B,Smax,KV,D) dense or, with
    `page_table` (B,pages_per_seq) int32, (n_pages,ps,KV,D) pools, in
    f32|bf16|int8; int8 caches take f16 `k_scale`/`v_scale` shaped like the
    cache minus D; kv_len (B,) int32. Returns (B,1,KV,G,D) in q.dtype."""
    b, sq, nkv, g, d = q.shape
    if sq != 1:
        raise ValueError(f"decode kernel takes one query position, got {sq}")
    kv_len = kv_len.to(torch.int32).reshape(-1).expand(b).contiguous()
    ints = [kv_len] if page_table is None else [kv_len, page_table]
    check_attention_operands("decode_attention", q, k_cache, v_cache,
                             k_scale, v_scale, ints)
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
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    splits = n_splits(smax or pps * ps)
    part = torch.empty((b * nkv, max(splits, 1), g, d + 2),
                       dtype=torch.float32, device=q.device)
    sem = _build.semaphores(q.device, b * nkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), _ptr(page_table), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), sem.data_ptr(), b, nkv, g, d, smax,
        pps, ps, int(window), scale, splits, _QDT[q.dtype],
        _KVDT[k_cache.dtype], stream)
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
    not. No kernel reads MLA latent rows (`v_dim`), so there this plain path
    is the served one and rounds as the JAX branch; elsewhere it is the
    kernels' plain version and keeps f32 probabilities, as they do."""
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
