"""Attention dispatch (port of `repro/models/attention.py`).

Shapes: q (B, Sq, KV, G, D) where G = n_heads // n_kv_heads; k/v
(B, Sk, KV, D); paged pools (n_pages, page_size, KV, D).

`decode_attention` and `chunk_attention_paged` are dispatchers: CPU tensors
take the plain PyTorch path, CUDA tensors launch the hand-written kernel
(`kernels/decode_attention`, `kernels/flash_attention`) or raise. The TPU
dispatch predicates (`_pallas_decode_ok`/`_pallas_chunk_ok`) have no
counterpart: the CUDA kernels take every page size and chunk length.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention_paged_cuda, flash_attention_paged_plain)

NEG_INF = -1e30   # finite: a fully-masked row never produces NaN


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """(Tq, Tk) additive bias from absolute positions."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return torch.where(ok, 0.0, NEG_INF).float()


def reference_attention(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0, kv_len: Optional[torch.Tensor] = None):
    """Oracle. q: (B,Sq,KV,G,D); k,v: (B,Sk,KV,D) → (B,Sq,KV,G,D)."""
    b, sq, nkv, g, d = q.shape
    sk = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=dev)
    k_pos = torch.arange(sk, device=dev)
    s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    if kv_len is not None:
        s = torch.where(k_pos[None, None, None, None, :]
                        < kv_len.to(dev)[:, None, None, None, None],
                        s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, scale=None):
    """Full attention over the sequence. Only the reference branch is ported:
    the JAX `chunked_attention` serves training and dry-run shapes."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def _unported(v_dim, k_cache):
    if v_dim is not None:
        raise NotImplementedError(
            "MLA latent rows (v_dim) come with ROADMAP A10 (models/mla.py)")
    if k_cache.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        raise NotImplementedError(
            "fp8 KV caches come with ROADMAP A9 (int8/bf16/fp8 serving)")


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0, scale=None,
                     page_table=None, k_scale=None, v_scale=None,
                     v_dim: Optional[int] = None):
    """Single-position attention against a cache.

    q: (B,1,KV,G,D); caches (B,Smax,KV,D), or (n_pages,ps,KV,D) pools read
    through `page_table` (B,pages_per_seq); cur_len () or (B,) — valid rows
    (this step's row already written). int8 caches carry f16 `k_scale`/
    `v_scale` shaped like the cache minus D. kv_len == 0 gives zeros."""
    assert (k_scale is None) == (v_scale is None)
    _unported(v_dim, k_cache)
    b = q.shape[0]
    kv_len = torch.as_tensor(cur_len, device=q.device).reshape(-1).expand(b)
    kw = dict(page_table=page_table, k_scale=k_scale, v_scale=v_scale,
              window=window, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, **kw)
    return decode_attention_cuda(q, k_cache, v_cache, kv_len, **kw)


def chunk_attention_paged(q, k_pool, v_pool, page_table, q_offset, *, kv_len,
                          window=0, scale=None, k_scale=None, v_scale=None,
                          v_dim: Optional[int] = None):
    """Chunk-prefill attention: q (B, C, KV, G, D), row i at global position
    q_offset[b] + i, against the (n_pages, page_size, KV, D) pools through
    `page_table`; kv_len (B,) is the live length (this chunk already
    written). Rows with no valid key give zeros."""
    assert (k_scale is None) == (v_scale is None)
    _unported(v_dim, k_pool)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_paged_plain(q, k_pool, v_pool, page_table,
                                           q_offset, kv_len, **kw)
    return flash_attention_paged_cuda(q, k_pool, v_pool, page_table,
                                      q_offset, kv_len, **kw)
