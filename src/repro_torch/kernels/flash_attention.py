"""Blockwise attention kernels: dense self-attention and chunk-prefill
attention through the page table.

`flash_attention_cuda` replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention` (dense (B, H, S, D)
self-attention, causal and/or windowed). The CUDA kernel is
`csrc/flash_attention.cu`: one block per (batch·head, 16 query rows) streams
the 32-key K/V tiles its rows can see (dead tiles under the causal or window
mask are skipped) through shared memory, and each warp keeps an f32 online
softmax for four rows. It takes any S (ragged tail tiles are masked), where
the TPU kernel needs S to be a multiple of its block. The serving engine's
monolithic prefill reaches it through `models.attention.attention`.

`flash_attention_paged_cuda` replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention_paged`. The CUDA kernel
is `csrc/flash_attention_paged.cu`: one block per (sequence, kv head, four
chunk rows) loads each 32-key tile of the rows' key range from the page pool
into shared memory once (int8 rows dequantized with their f16 scales on the
way), and each warp keeps an f32 online softmax for one row's G query heads.
Masks: causal by global position `q_offset[b] + i`, bounded by the live
`kv_len`, optional window; rows with no valid key give zeros. At the serving
chunk it is bound by the bytes of the live K/V rows.

The plain PyTorch versions are `repro_torch.kernels.ref.flash_attention_ref`
(dense) and `flash_attention_paged_plain` below: the oracles on the card and
the paths for CPU tensors (via `kernels.ops.flash_attention` and
`models.attention.chunk_attention_paged`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    _KVDT, _KVNAME, _QDT, NEG_INF, _ptr, check_attention_operands)

# launches of the paged CUDA kernel, keyed by pool dtype ("f32", "int8",
# ...); only `flash_attention_paged_cuda` adds to it
LAUNCHES: Counter = Counter()
# launches of the dense CUDA kernel, keyed by q dtype ("f32", "bf16"); only
# `flash_attention_cuda` adds to it
DENSE_LAUNCHES: Counter = Counter()
DENSE_HEAD_DIMS = (32, 64, 128)   # the head dims csrc/flash_attention.cu takes
_fn = None
_dense_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention_paged").flash_attention_paged
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _dense_kernel():
    global _dense_fn
    if _dense_fn is None:
        f = _build.load("flash_attention").flash_attention
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _dense_fn = f
    return _dense_fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dense CUDA kernel (CUDA tensors only; no fallback).

    q/k/v (B, H, S, D), contiguous, one dtype (f32 or bf16), D in
    `DENSE_HEAD_DIMS`; query row i and key j are positions i and j of one
    sequence. Returns (B, H, S, D) in q.dtype."""
    if q.dtype not in _QDT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} (one of f32/bf16 for all three)")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: operands must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (one (B, H, "
                         "S, D) shape: self-attention, Sq == Sk)")
    b, h, s, d = q.shape
    if d not in DENSE_HEAD_DIMS or b * h > 65535:
        raise ValueError(f"flash_attention: head_dim {d} (takes "
                         f"{DENSE_HEAD_DIMS}) or B*H {b * h} (at most 65535)")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _dense_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, s,
        d, int(bool(causal)), int(window), scale, _QDT[q.dtype], stream)
    _build.check(status, "flash_attention")
    DENSE_LAUNCHES[_KVNAME[q.dtype]] += 1
    return out


def flash_attention_paged_cuda(q, k_pool, v_pool, page_table, q_offset,
                               kv_len, *, k_scale=None, v_scale=None,
                               window: int = 0,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; no fallback).

    q (B,C,KV,G,D) f32|bf16; pools (n_pages,ps,KV,D) f32|bf16|int8 (int8
    with f16 `k_scale`/`v_scale` (n_pages,ps,KV)); page_table (B,pps),
    q_offset and kv_len (B,) int32. Returns (B,C,KV,G,D) in q.dtype."""
    b, cq, nkv, g, d = q.shape
    q_offset = q_offset.to(torch.int32).reshape(-1).expand(b).contiguous()
    kv_len = kv_len.to(torch.int32).reshape(-1).expand(b).contiguous()
    check_attention_operands("flash_attention_paged", q, k_pool, v_pool,
                             k_scale, v_scale, [page_table, q_offset, kv_len])
    if page_table.shape[0] != b:
        raise ValueError("page table batch differs from q")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    if cq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), page_table.data_ptr(), q_offset.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, cq, nkv, g, d,
        page_table.shape[1], k_pool.shape[1], int(window), scale,
        _QDT[q.dtype], _KVDT[k_pool.dtype], stream)
    _build.check(status, "flash_attention_paged")
    LAUNCHES[_KVNAME[k_pool.dtype]] += 1
    return out


def flash_attention_paged_plain(q, k_pool, v_pool, page_table, q_offset,
                                kv_len, *, k_scale=None, v_scale=None,
                                window: int = 0,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch chunk attention (port of the JAX reference branch,
    `repro/models/attention.py:292-317`), except that rows with no valid key
    give zeros, as the kernels on both machines do."""
    b, cq, nkv, g, d = q.shape
    pt = page_table.long()
    kf = k_pool[pt].reshape(b, -1, nkv, d).float()
    vf = v_pool[pt].reshape(b, -1, nkv, d).float()
    if k_scale is not None:
        kf = kf * k_scale[pt].reshape(b, -1, nkv).float()[..., None]
        vf = vf * v_scale[pt].reshape(b, -1, nkv).float()[..., None]
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
    p = torch.softmax(s, dim=-1) * ok.any(-1)[:, None, None, :, None]
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return o.to(q.dtype)
