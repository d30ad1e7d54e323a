"""Attention dispatch (port of `repro/models/attention.py`).

Shapes: q (B, Sq, KV, G, D) where G = n_heads // n_kv_heads; k/v
(B, Sk, KV, D); paged pools (n_pages, page_size, KV, D).

`reference_attention` is the oracle; `chunked_attention` is the plain
flash-style online softmax over (q-block, kv-block) tiles, ported as
written. `attention` is the full-sequence dispatcher of the train and
prefill modes: short sequences and `impl="reference"` take the oracle; long
ones on a CUDA device with G == 1 and no autograd launch the dense CUDA
kernel (`kernels/flash_attention.flash_attention_cuda`), everything else
(the CPU, training) takes `chunked_attention`.

`decode_attention` and `chunk_attention_paged` are dispatchers: CPU tensors
take the plain PyTorch path, CUDA tensors launch the hand-written kernel
(`kernels/decode_attention`, `kernels/flash_attention`) or raise. The
kernels take G <= 16 query heads per kv head, head_dim up to 256, MLA
latent rows (`v_dim`: one pool as k and v, values its rows' first v_dim
columns) and, for decode, fp8 (e5m2) caches; `latent_attention` sends an
MLA model's monolithic prefill through the chunk kernel, so that its rows
equal chunked prefill's. The one cache format no kernel reads is an fp8
pool in chunk attention (`_plain_only`; a paged fp8 engine is refused, as
the reference's is). Otherwise the TPU dispatch predicates
(`_pallas_decode_ok`/`_pallas_chunk_ok`) have no counterpart: the CUDA
kernels take every page size and chunk length.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
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


def _block_attn(q, k, v, bias, scale, m, l, acc):
    """One online-softmax tile update. q:(B,Tq,KV,G,D) k/v:(B,Tk,KV,D)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    s = s + bias                                  # (Tq, Tk) broadcast
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def chunked_attention(q, k, v, *, causal=True, window=0, scale=None,
                      q_chunk=1024, kv_chunk=1024):
    """Flash-style attention in plain PyTorch: a loop over q blocks, and per
    block over exactly the kv blocks that can contribute (causal → lower
    triangle; window → the trailing `window` band). Any S: the last q and
    kv blocks may be ragged, where the reference asserts S % chunk == 0; at
    the multiples it takes, the blocks and sums are its own."""
    b, sq, nkv, g, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]      # MLA values are the latent's leading slice: dv < d
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    n_q, n_kv = -(-sq // q_chunk), -(-sk // kv_chunk)
    outs = []
    for iq in range(n_q):
        q0 = iq * q_chunk
        qi = q[:, q0:q0 + q_chunk]
        tq = qi.shape[1]
        q_pos = q0 + torch.arange(tq, device=dev)
        # contributing kv block range
        hi = n_kv if not causal else min(
            n_kv, (q0 + tq + kv_chunk - 1) // kv_chunk)
        lo = 0
        if window > 0:
            lo = max(0, (q0 - window) // kv_chunk)
        m = torch.full((b, nkv, g, tq), NEG_INF, device=dev)
        l = torch.zeros((b, nkv, g, tq), device=dev)
        acc = torch.zeros((b, nkv, g, tq, dv), device=dev)
        for j in range(lo, hi):
            k0 = j * kv_chunk
            kj, vj = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            k_pos = k0 + torch.arange(kj.shape[1], device=dev)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
            m, l, acc = _block_attn(qi, kj, vj, bias, scale, m, l, acc)
        o = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,KV,G,Tq,D)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q, k, v, *, causal=True, window=0, scale=None, impl="chunked",
              q_chunk=1024, kv_chunk=1024):
    """Full attention over the sequence, dispatched as the JAX package does
    (`repro/models/attention.py:320-325`) except on the card:
    `impl="reference"` takes `reference_attention`. On a CUDA device with
    one query head per K/V head (the model expands K/V first) and no
    autograd graph to record, every S goes to the dense CUDA kernel, which
    has no backward (nor has the TPU kernel). The JAX package's short-
    sequence cut (S <= max(256, q_chunk // 4) to the oracle) fits the TPU
    kernel's blocks; the CUDA kernel takes any S, and sending every
    monolithic prefill through it keeps each row equal to the chunk
    kernel's row. Elsewhere the JAX rule holds: short sequences take the
    oracle, longer ones `chunked_attention`.

    Keys may outnumber or undershoot the queries (Sk != Sq: the
    encoder-decoder's cross attention) only unmasked, as the TPU kernel
    computes them: every query row over all Sk keys. A causal or windowed
    call over two lengths raises ValueError (nothing asks for one)."""
    if k.shape[1] != q.shape[1] and (causal or window):
        raise ValueError(f"attention: Sq {q.shape[1]} != Sk {k.shape[1]} "
                         f"takes no mask (causal {causal}, window {window})")
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.is_cuda and q.shape[3] == 1 and not _needs_grad(q, k, v):
        # (B, S, H, 1, D) and (B, S, H, D) → the kernel's (B, H, S, D)
        o = ops.flash_attention(
            q[:, :, :, 0].transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            causal=causal, window=window, scale=scale)
        return o.transpose(1, 2)[:, :, :, None, :]
    if q.shape[1] <= max(256, q_chunk // 4):
        return reference_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk)


def latent_attention(q, lat, v_dim: int, *, window=0, scale=None,
                     impl="chunked", q_chunk=1024, kv_chunk=1024):
    """Causal self-attention over MLA latent rows (the monolithic prefill):
    q (B, S, 1, G, Dk), lat (B, S, 1, Dk), values each row's first v_dim
    columns → (B, S, 1, G, v_dim). On the card with no autograd graph to
    record, the chunk kernel runs over the rows as a pool of one S-row page
    a sequence (q_offset 0, kv_len S): the latent-row code, 128-key splits
    at absolute positions and merge order of chunked prefill, so a row of a
    monolithic prefill equals the same row of a chunked one. Elsewhere
    `attention` as the JAX package dispatches it."""
    if q.is_cuda and impl != "reference" and not _needs_grad(q, lat):
        b, s = lat.shape[:2]
        pool = lat.contiguous()
        table = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
        return flash_attention_paged_cuda(
            q.contiguous(), pool, pool, table,
            torch.zeros(b, dtype=torch.int32, device=q.device),
            torch.full((b,), s, dtype=torch.int32, device=q.device),
            window=window, scale=scale, v_dim=v_dim)
    return attention(q, lat, lat[..., :v_dim], causal=True, window=window,
                     scale=scale, impl=impl, q_chunk=q_chunk,
                     kv_chunk=kv_chunk)


def _plain_only(k_pool) -> bool:
    """The one pool format the chunk kernel does not read: one-byte float
    (fp8) storage (`repro/models/attention.py:245`). The engine refuses a
    paged fp8 pool, as the reference's does."""
    dt = k_pool.dtype
    return dt.is_floating_point and dt.itemsize == 1


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0, scale=None,
                     page_table=None, k_scale=None, v_scale=None,
                     v_dim: Optional[int] = None):
    """Single-position attention against a cache.

    q: (B,1,KV,G,D); caches (B,Smax,KV,D), or (n_pages,ps,KV,D) pools read
    through `page_table` (B,pages_per_seq); cur_len () or (B,) — valid rows
    (this step's row already written). int8 caches carry f16 `k_scale`/
    `v_scale` shaped like the cache minus D. kv_len == 0 gives zeros.
    `v_dim` (MLA): k_cache and v_cache are the same latent pool and the
    values are each row's first v_dim columns; the output is
    (B,1,KV,G,v_dim)."""
    assert (k_scale is None) == (v_scale is None)
    b = q.shape[0]
    if isinstance(cur_len, int):
        # a fixed depth (the cross rows): filled on the device, no upload
        kv_len = torch.full((b,), cur_len, dtype=torch.int32, device=q.device)
    else:
        kv_len = torch.as_tensor(cur_len, device=q.device).reshape(-1).expand(b)
    kw = dict(page_table=page_table, k_scale=k_scale, v_scale=v_scale,
              window=window, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len,
                                      v_dim=v_dim, **kw)
    return decode_attention_cuda(q, k_cache, v_cache, kv_len, v_dim=v_dim,
                                 **kw)


def chunk_attention_paged(q, k_pool, v_pool, page_table, q_offset, *, kv_len,
                          window=0, scale=None, k_scale=None, v_scale=None,
                          v_dim: Optional[int] = None):
    """Chunk-prefill attention: q (B, C, KV, G, D), row i at global position
    q_offset[b] + i, against the (n_pages, page_size, KV, D) pools through
    `page_table`; kv_len (B,) is the live length (this chunk already
    written). Rows with no valid key give zeros. `v_dim` as in
    `decode_attention`."""
    assert (k_scale is None) == (v_scale is None)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window, scale=scale)
    if q.device.type == "cpu" or _plain_only(k_pool):
        return flash_attention_paged_plain(q, k_pool, v_pool, page_table,
                                           q_offset, kv_len, v_dim=v_dim,
                                           **kw)
    return flash_attention_paged_cuda(q, k_pool, v_pool, page_table,
                                      q_offset, kv_len, v_dim=v_dim, **kw)
