"""Decoder-only transformer, dense, moe and vlm families, GQA or MLA
attention (port of `repro/models/transformer.py`). The vlm family is the
dense decoder whose leading positions take precomputed patch embeddings
(the modality frontend is a stub in both packages).

Parameters are stacked `(L, ...)` tensors; each layer indexes its slice (a
view, no copy) in a Python loop in place of `lax.scan`. Caches are dicts of
layer-stacked pools. Where the JAX package returned updated pools (`.at[].set`
plus donation), this port writes the K/V pools IN PLACE through their
per-layer views (`index_put_`) and returns the same dict.

GQA runs with q grouped as (B, S, KV, G, D) against (B, S, KV, D) K/V; the
distribution-time head padding (`ArchConfig.tp_pad`) is kept for parity and
is 1 (no padding) on one GPU.

Training (`train_loss`) runs the same layers in 'train' mode under autograd;
remat 'full' becomes `torch.utils.checkpoint` around each layer and each CE
chunk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (  # contract: allow(R2) the one attention core
    ParamDef, act_fn, apply_rope, glu_act, rms_norm, softcap)
from repro_torch.models.quantized import (
    SCALE_DTYPE, decode_products, dequantize_kv_rows, fixed_row_blocks,
    qeinsum, quantize_kv_rows)


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """Execution-strategy knobs: the full-sequence attention fields of the
    JAX `ExecOptions` and its `moe_group`. `attn_impl`: "chunked"
    (blockwise for long sequences: the dense CUDA kernel on the card,
    `chunked_attention` elsewhere) or "reference". `moe_group` overrides
    `cfg.moe_group`, the MoE token group size."""
    attn_impl: str = "chunked"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    moe_group: Optional[int] = None


DEFAULT_OPTS = ExecOptions()


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def attn_schema(cfg, L: int, prefix: str = "") -> Dict[str, Any]:
    """QKV/O projections of L layers, keys prefixed by `prefix` (the
    encoder-decoder's cross attention: "c"); biases only unprefixed."""
    d, hd = cfg.d_model, cfg.head_dim
    hp, kvp = cfg.n_heads_padded, cfg.kv_pad
    sch = {
        prefix + "wq": ParamDef((L, d, hp, hd),
                                ("layers", "embed", "heads", None)),
        prefix + "wk": ParamDef((L, d, kvp, hd),
                                ("layers", "embed", "heads", None)),
        prefix + "wv": ParamDef((L, d, kvp, hd),
                                ("layers", "embed", "heads", None)),
        prefix + "wo": ParamDef((L, hp, hd, d),
                                ("layers", "heads", None, "embed")),
    }
    if cfg.qkv_bias and not prefix:
        sch["bq"] = ParamDef((L, hp, hd), ("layers", "heads", None), init="zeros")
        sch["bk"] = ParamDef((L, kvp, hd), ("layers", "heads", None), init="zeros")
        sch["bv"] = ParamDef((L, kvp, hd), ("layers", "heads", None), init="zeros")
    return sch


def head_mask(cfg, dtype=torch.float32, device=None) -> torch.Tensor:
    """(Hp,) — 1 for real heads (kv < n_kv_heads and g < q_per_kv), else 0."""
    kvp, gp = cfg.padded_kv_group
    idx = torch.arange(kvp * gp, device=device)
    kvi, gi = idx // gp, idx % gp
    return ((kvi < cfg.n_kv_heads) & (gi < cfg.q_per_kv)).to(dtype)


def schema(cfg) -> Dict[str, Any]:
    if cfg.family not in ("dense", "moe", "vlm") \
            or cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"family {cfg.family!r}/{cfg.attn_kind!r} comes with ROADMAP A10")
    d, f = cfg.d_model, cfg.d_ff
    L, v = cfg.n_layers, cfg.padded_vocab
    norm_init = "zeros" if cfg.norm_plus_one else "ones"
    layers: Dict[str, Any] = {
        "attn_norm": ParamDef((L, d), ("layers", None), init=norm_init),
        "ffn_norm": ParamDef((L, d), ("layers", None), init=norm_init),
    }
    if cfg.attn_kind == "mla":
        layers.update(mla_mod.mla_schema(cfg, L))
    else:
        layers.update(attn_schema(cfg, L))
    if cfg.family == "moe":
        layers.update(moe_mod.moe_schema(cfg, L))
    else:
        layers["w1"] = ParamDef((L, d, f), ("layers", "embed", "ff"))
        layers["w3"] = ParamDef((L, d, f), ("layers", "embed", "ff"))
        layers["w2"] = ParamDef((L, f, d), ("layers", "ff", "embed"))
    sch = {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": ParamDef((d,), (None,), init=norm_init),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamDef((v, d), ("vocab", "embed"), init="small_normal")
    return sch


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's slice of the stacked params (views; quantized leaves too)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i])
            for k, v in layers.items()}


def layer_views(layers: Dict[str, Any]):
    """Every layer's slice of the stacked (float) params, from ONE
    `unbind(0)` per stacked leaf. Under autograd `v[i]` would give each
    stacked leaf one full-size zero-padded gradient per layer (O(L²) memory
    and traffic); unbind's backward stacks the L gradients once."""
    per_leaf = {k: v.unbind(0) for k, v in layers.items()}
    return [dict(zip(per_leaf, views)) for views in zip(*per_leaf.values())]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg):
    q = qeinsum("bsd,dhk->bshk", x, p["wq"])
    k = qeinsum("bsd,dhk->bshk", x, p["wk"])
    v = qeinsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _expand_kv(k, v, cfg):
    """(B,S,KVp,D) → (B,S,Hp,D) by repeating each kv head g_pad times."""
    gp = cfg.g_pad
    if gp > 1:
        k = torch.repeat_interleave(k, gp, dim=2)
        v = torch.repeat_interleave(v, gp, dim=2)
    return k, v


def _round_rows(rows, kv_round):
    """Round K/V (or MLA latent) rows through the cache storage dtype: int8
    takes the full quantize→dequantize trip, float storage (bf16, fp8
    e5m2) a cast round trip with no scales."""
    if kv_round is None:
        return rows
    if kv_round == torch.int8:
        q, s = quantize_kv_rows(rows)
        return dequantize_kv_rows(q, s, rows.dtype)
    return rows.to(kv_round).to(rows.dtype)


def _round_kv(k, v, kv_round):
    """Prefill attends the values the cache will hold, so monolithic and
    chunked prefill (which reads the pool) see identical numerics."""
    return _round_rows(k, kv_round), _round_rows(v, kv_round)


def _pool_entry(**pools):
    return {key: val for key, val in pools.items() if val is not None}


def attn_block(x, p, cfg, *, positions, mode: str,
               cache: Optional[dict] = None, kv_round=None,
               chunk: Optional[dict] = None,
               opts: ExecOptions = DEFAULT_OPTS, causal: bool = True):
    """Self-attention — THE per-layer attention core. Returns
    (out, cache entry).

      'train'   full attention over S positions (`attention` as `opts`
                says; differentiable: never the kernel); no cache entry.
      'prefill' full attention (long prompts through the dense CUDA kernel
                on the card); emits this layer's K/V rows.
      'decode'  one position per sequence; writes the new row into the dense
                cache or the paged pool (via cache['page_table']) in place and
                attends the stored rows.
      'chunk'   chunked prefill (B=1): writes C rows into the pool through the
                slot's page row in place, then chunk attention against the
                slot's live pages.
    `causal=False` ('train'/'prefill' only) serves the encoder-decoder's
    encoder (`models/encdec.py`). int8 storage is detected by the scale
    pools ('ks'/'vs') riding in `cache`; fp8 (e5m2) storage is a bare
    dtype, no scales. `cfg.attn_kind == "mla"` runs `models/mla.py`'s block
    under the same contract, on one latent pool (causal only)."""
    if cfg.attn_kind == "mla":
        return mla_mod.mla_attn_block(
            x, p, cfg, opts, positions=positions, mode=mode, cache=cache,
            kv_round=kv_round, chunk=chunk)
    q, k, v = _project_qkv(x, p, cfg)  # contract: allow(R2) the one core
    q = apply_rope(q, positions, fraction=cfg.rope_fraction,  # contract: allow(R2)
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction,  # contract: allow(R2)
                   theta=cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    kvp, gp = cfg.padded_kv_group

    if mode in ("train", "prefill"):
        ka, va = (k, v) if mode == "train" else _round_kv(k, v, kv_round)
        kx, vx = _expand_kv(ka, va, cfg)
        o = attn_mod.attention(q[:, :, :, None, :], kx, vx, causal=causal,
                               window=cfg.window, scale=scale,
                               impl=opts.attn_impl, q_chunk=opts.q_chunk,
                               kv_chunk=opts.kv_chunk)
        o = o[:, :, :, 0, :]
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    elif mode == "chunk":
        assert cache is not None and chunk is not None
        b, C = x.shape[:2]
        pk, psk = _write_chunk(cache, "k", k[0], chunk)
        pv, psv = _write_chunk(cache, "v", v[0], chunk)
        qg = q.reshape(b, C, kvp, gp, cfg.head_dim)
        o = attn_mod.chunk_attention_paged(
            qg, pk, pv, chunk["page_row"][None], chunk["start"],
            kv_len=chunk["start"] + chunk["length"],
            window=cfg.window, scale=scale, k_scale=psk, v_scale=psv)
        o = o.reshape(b, C, cfg.n_heads_padded, cfg.head_dim)
        new_cache = _pool_entry(k=pk, v=pv, ks=psk, vs=psv)
    elif mode == "decode":
        assert cache is not None
        b = x.shape[0]
        pos_b = positions.reshape(-1)
        page_table = cache.get("page_table")
        # rows the step does not write are routed to the null page (paged)
        # or past the cache (dense); see decode_step
        wpos = cache.get("write_pos", pos_b)
        wtable = cache.get("write_table", page_table)
        k_cache, k_scale = _write_row(cache, "k", k, wpos, wtable)
        v_cache, v_scale = _write_row(cache, "v", v, wpos, wtable)
        qg = q.reshape(b, 1, kvp, gp, cfg.head_dim)
        o = attn_mod.decode_attention(
            qg, k_cache, v_cache, pos_b + 1, window=cfg.window, scale=scale,
            page_table=page_table, k_scale=k_scale, v_scale=v_scale)
        o = o.reshape(b, 1, cfg.n_heads_padded, cfg.head_dim)
        new_cache = _pool_entry(k=k_cache, v=v_cache, ks=k_scale, vs=v_scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    if cfg.n_heads_padded != cfg.n_heads:    # dead pad heads contribute 0
        o = o * head_mask(cfg, o.dtype, o.device)[None, None, :, None]
    return qeinsum("bshk,hkd->bsd", o, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# In-place K/V writes (dense rows, paged pools, int8 with f16 scales)
# ---------------------------------------------------------------------------

def _dense_rows(cache, positions):
    """(sequence, row, in range) of each sequence's row positions[b] in a
    dense (B, Smax, ...) cache, without a host sync: a position past Smax
    clamps onto row Smax - 1, which `_put_rows` then leaves as it is."""
    smax = cache.shape[1]
    b = torch.arange(cache.shape[0], device=cache.device)
    return b, torch.clamp(positions, max=smax - 1).long(), positions < smax


def _put_rows(cache, b, row, ok, new):
    """cache[b, row] = new where `ok`, else the row's own bits."""
    keep = ok.view(-1, *([1] * (new.dim() - 1)))
    if cache.dtype.is_floating_point and cache.element_size() == 1:
        # one-byte float (e5m2) storage: select on the raw bytes
        cache, new = cache.view(torch.uint8), new.view(torch.uint8)
    cache[b, row] = torch.where(keep, new, cache[b, row])


def _write_cache(cache, kv_new, positions):
    """Dense (B, Smax, KV, D) cache: row positions[b] of sequence b takes
    kv_new[b, 0]; positions past Smax write nothing (the JAX one-hot)."""
    b, row, ok = _dense_rows(cache, positions)
    _put_rows(cache, b, row, ok, kv_new[:, 0].to(cache.dtype))
    return cache


def _write_cache_q(cache, scales, kv_new, positions):
    q, s = quantize_kv_rows(kv_new)
    b, row, ok = _dense_rows(cache, positions)
    _put_rows(cache, b, row, ok, q[:, 0])
    _put_rows(scales, b, row, ok, s[:, 0])
    return cache, scales


def _row_pages(pool, positions, page_table):
    """(page, row) targets of each sequence's row `positions[b]`. Positions
    past the table's depth clamp onto its last entry (retired slots point
    at the null page, so their drift lands there)."""
    ps = pool.shape[1]
    logical = torch.clamp(positions // ps, max=page_table.shape[1] - 1)
    page = page_table.gather(1, logical[:, None].long())[:, 0]
    return page.long(), (positions % ps).long()


def _write_cache_paged(pool, kv_new, positions, page_table):
    page, row = _row_pages(pool, positions, page_table)
    pool[page, row] = kv_new[:, 0].to(pool.dtype)
    return pool


def _write_cache_paged_q(pool, spool, kv_new, positions, page_table):
    q, s = quantize_kv_rows(kv_new)
    page, row = _row_pages(pool, positions, page_table)
    pool[page, row] = q[:, 0]
    spool[page, row] = s[:, 0]
    return pool, spool


def _chunk_pages(pos, length, page_row, ps, null=0):
    """(page, row) targets for a prefill chunk's rows: rows past `length`
    (chunk padding) route to the null page `null` (page 0 of a one-shard
    pool), positions past the table onto the table's last entry."""
    logical = torch.clamp(pos // ps, max=page_row.shape[0] - 1)
    real = torch.arange(pos.shape[0], device=pos.device) < length
    page = torch.where(real, page_row[logical.long()], null)
    return page.long(), (pos % ps).long()


def _write_chunk_paged(pool, rows, start, length, page_row, null=0):
    pos = start + torch.arange(rows.shape[0], device=rows.device)
    page, r = _chunk_pages(pos, length, page_row, pool.shape[1], null)
    pool[page, r] = rows.to(pool.dtype)
    return pool


def _write_chunk_paged_q(pool, spool, rows, start, length, page_row, null=0):
    q, s = quantize_kv_rows(rows)
    pos = start + torch.arange(rows.shape[0], device=rows.device)
    page, r = _chunk_pages(pos, length, page_row, pool.shape[1], null)
    pool[page, r] = q
    spool[page, r] = s
    return pool, spool


def _write_row(cache, key, kv_new, positions, page_table):
    """One decode row into `cache[key]`, dense or paged, any storage dtype.
    Returns (pool, scales-or-None)."""
    if key + "s" in cache:
        if page_table is None:
            return _write_cache_q(cache[key], cache[key + "s"], kv_new,
                                  positions)
        return _write_cache_paged_q(cache[key], cache[key + "s"], kv_new,
                                    positions, page_table)
    if page_table is None:
        return _write_cache(cache[key], kv_new, positions), None
    return _write_cache_paged(cache[key], kv_new, positions, page_table), None


def _write_chunk(cache, key, rows, chunk):
    start, length = chunk["start"][0], chunk["length"][0]
    null = chunk.get("null_page", 0)
    if key + "s" in cache:
        return _write_chunk_paged_q(cache[key], cache[key + "s"], rows,
                                    start, length, chunk["page_row"], null)
    return _write_chunk_paged(cache[key], rows, start, length,
                              chunk["page_row"], null), None


_POOL_KEYS = ("k", "v", "ks", "vs")


def _pools_of(cache):
    """The layer-stacked K/V pools present in a cache."""
    return {key: cache[key] for key in _POOL_KEYS if key in cache}


def pool_data_keys(cache) -> Tuple[str, ...]:
    """Base (unscaled) pool keys present in a cache or prefill dict — THE way
    engine code iterates pools (contract R6)."""
    return tuple(key for key in ("k", "v") if key in cache)  # contract: allow(R6)


def _page_pool_keys(cache) -> Tuple[str, ...]:
    """Every pool with a page axis: each data pool, then its int8 scale
    pool where there is one."""
    return tuple(k for key in pool_data_keys(cache)
                 for k in (key, key + "s") if k in cache)


def copy_pool_page(cache, src: int, dst: int):
    """Copy physical page `src` onto `dst` across every pool, all layers, in
    place. Returns the cache."""
    for key in _page_pool_keys(cache):
        cache[key][:, dst] = cache[key][:, src]
    return cache


def gather_pool_pages(cache, page_ids):
    """Snapshot physical pages `page_ids` ((M,) int64 tensor) out of every
    pool: {key: (L, M, page_size, ...)} copies, the migration outbox.
    Pool-native bytes: an int8 pool's int8 rows with their f16 scale rows,
    MLA's one latent pool. Taken before any `set_pool_page` of a move wave
    writes, so a page may be exported and overwritten in the same wave."""
    return {key: cache[key].index_select(1, page_ids)
            for key in _page_pool_keys(cache)}


def set_pool_page(cache, dst, rows):
    """Write gathered pages into physical page(s) `dst` across every pool,
    in place: an int with `rows` {key: (L, page_size, ...)}, or an (M,)
    int64 tensor of distinct pages with `rows` {key: (L, M, page_size,
    ...)} (a `gather_pool_pages` outbox). A write to a null page lands on
    the page that absorbs garbage by contract. Returns the cache."""
    for key in _page_pool_keys(cache):
        cache[key][:, dst] = rows[key]
    return cache


# ---------------------------------------------------------------------------
# Layers, embedding
# ---------------------------------------------------------------------------

def dense_ffn(x, p, cfg):
    act = act_fn(glu_act(cfg.activation))
    h = act(qeinsum("bsd,df->bsf", x, p["w1"])) \
        * qeinsum("bsd,df->bsf", x, p["w3"])
    return qeinsum("bsf,fd->bsd", h, p["w2"])


def layer_fn(x, lp, cfg, *, positions, mode, cache: Optional[dict] = None,
             kv_round=None, chunk=None, opts: ExecOptions = DEFAULT_OPTS):
    a, new_cache = attn_block(
        rms_norm(x, lp["attn_norm"], plus_one=cfg.norm_plus_one),
        lp, cfg, positions=positions, mode=mode, cache=cache,
        kv_round=kv_round, chunk=chunk, opts=opts)
    x = x + a
    h = rms_norm(x, lp["ffn_norm"], plus_one=cfg.norm_plus_one)
    if cfg.family != "moe":
        return x + dense_ffn(h, lp, cfg), new_cache
    return x + moe_mod.moe_ffn(h, lp, _maybe_group(cfg, opts)), new_cache


def _maybe_group(cfg, opts):
    if opts.moe_group and opts.moe_group != cfg.moe_group:
        return dataclasses.replace(cfg, moe_group=opts.moe_group)
    return cfg


def embed_tokens(params, tokens, cfg, patch_embeds=None):
    """Token embeddings; `patch_embeds` (B, P, d) (vlm) overwrite the
    leading P positions, in the embeddings' dtype."""
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = (x.float() * (cfg.d_model ** 0.5)).to(x.dtype)
    if patch_embeds is not None:
        p = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(device=x.device, dtype=x.dtype),
                       x[:, p:]], dim=1)
    return x


def lm_head_weights(params, cfg):
    return params.get("lm_head", params["embed"])


def lm_logits(params, hidden, cfg):
    """(B, S, d) final hidden → (B, S, V) f32 logits (plain torch, as the JAX
    package leaves the LM head to XLA; on the card in fixed row blocks, so
    a row's logits do not depend on the rows beside it)."""
    w = lm_head_weights(params, cfg)
    b, s, d = hidden.shape
    logits = fixed_row_blocks(hidden.reshape(b * s, d), lambda r: r @ w.T
                              ).reshape(b, s, -1)
    return softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

def _kv_round_of(batch):
    """Storage dtype of a lossy KV cache from the batch's `kv_round` marker
    (a torch dtype or a tensor of it; absent = lossless storage)."""
    marker = batch.get("kv_round")
    if marker is None or isinstance(marker, torch.dtype):
        return marker
    return marker.dtype


def _remat(fn, remat: str):
    """remat 'full' (the JAX `jax.checkpoint`): save only fn's inputs and
    recompute its insides in the backward pass; 'none': save everything."""
    if remat == "none":
        return fn
    if remat != "full":
        raise ValueError(f"remat {remat!r}: the port has 'none' and 'full'")
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def _train_layer(x, lp, cfg, positions, opts):
    return layer_fn(x, lp, cfg, positions=positions, mode="train",
                    opts=opts)[0]


def forward_hidden(params, tokens, cfg, *, mode: str = "train",
                   kv_round=None, remat: str = "none",
                   opts: ExecOptions = DEFAULT_OPTS, patch_embeds=None):
    """Cacheless full-sequence pass: (final-normed hidden (B,S,d), per-layer
    K/V stacked on axis 0 in 'prefill' mode, None in 'train' mode).
    `patch_embeds` (vlm) take the leading positions (`embed_tokens`).

    'train' is differentiable: the layer slices come from one unbind per
    stacked leaf (`layer_views`), and remat='full' checkpoints each layer.
    `opts` picks the full-sequence attention and the MoE group
    (`ExecOptions`)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, patch_embeds)
    positions = torch.arange(s, device=tokens.device)[None, :]
    kv = None
    if mode == "train":
        layer = _remat(functools.partial(_train_layer, opts=opts), remat)
        for lp in layer_views(params["layers"]):
            x = layer(x, lp, cfg, positions)
    elif mode == "prefill":
        rows = {}
        for i in range(cfg.n_layers):
            x, kv_i = layer_fn(x, layer_params(params["layers"], i), cfg,
                               positions=positions, mode="prefill",
                               kv_round=kv_round, opts=opts)
            for key in pool_data_keys(kv_i):
                rows.setdefault(key, []).append(kv_i[key])
        kv = {key: torch.stack(val) for key, val in rows.items()}
    else:
        raise ValueError(f"forward_hidden mode {mode!r}")
    hidden = rms_norm(x, params["final_norm"], plus_one=cfg.norm_plus_one)
    return hidden, kv


def _ce_chunk(h, emb, y, cfg):
    """(Σ CE over the chunk's labelled rows, their count), f32 logsumexp.
    Labels < 0 are unlabelled."""
    logits = softcap(torch.einsum("bsd,vd->bsv", h, emb).float(),
                     cfg.logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(y, min=0).long()[..., None])[..., 0]
    w = (y >= 0).float()
    return torch.sum(w * (lse - ll)), torch.sum(w)


def chunked_ce_loss(hidden, emb, labels, cfg, *, ce_chunk: int = 512,
                    remat: str = "none"):
    """Mean CE over labelled positions, in sequence chunks of `ce_chunk` so
    only one chunk's (B, chunk, V) f32 logits live at a time; remat 'full'
    recomputes each chunk's logits in the backward pass."""
    b, s, d = hidden.shape
    chunk = min(ce_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of ce_chunk {chunk}")
    body = _remat(_ce_chunk, remat)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        part, n = body(hidden[:, i:i + chunk], emb, labels[:, i:i + chunk], cfg)
        loss, cnt = loss + part, cnt + n
    return loss / torch.clamp(cnt, min=1.0)


def train_loss(params, batch, cfg, *, ce_chunk: int = 512,
               remat: str = "none", opts: ExecOptions = DEFAULT_OPTS):
    """(mean next-token CE, {"loss": it}) of batch {'tokens','labels'}
    (B, S) int, with 'patch_embeds' (B, P, d) for the vlm family, whose
    image positions carry no label. `ce_chunk` and `remat` are the JAX
    `ExecOptions` knobs of the train shape (`launch/steps.py` sets remat
    'full')."""
    pe = batch.get("patch_embeds")
    hidden, _ = forward_hidden(params, batch["tokens"], cfg, mode="train",
                               remat=remat, opts=opts, patch_embeds=pe)
    labels = batch["labels"]
    if cfg.family == "vlm" and pe is not None:
        image = torch.arange(labels.shape[1], device=labels.device) \
            < pe.shape[1]
        labels = torch.where(image[None, :], -1, labels)
    loss = chunked_ce_loss(hidden, lm_head_weights(params, cfg),
                           labels, cfg, ce_chunk=ce_chunk, remat=remat)
    return loss, {"loss": loss}


def prefill_cache(params, batch, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """Cache-only prefill (no LM head): {'k','v': (L,B,S,KV,D), 'pos'}
    (MLA: {'k': (L,B,S,1,r+p), 'pos'})."""
    _, kv = forward_hidden(params, batch["tokens"], cfg, mode="prefill",
                           kv_round=_kv_round_of(batch), opts=opts,
                           patch_embeds=batch.get("patch_embeds"))
    b, s = batch["tokens"].shape
    return dict(kv, pos=torch.full((b,), s, dtype=torch.int32,
                                   device=batch["tokens"].device))


def prefill(params, batch, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """Returns (last-position logits (B,1,V) f32, cache dict)."""
    hidden, kv = forward_hidden(params, batch["tokens"], cfg, mode="prefill",
                                kv_round=_kv_round_of(batch), opts=opts,
                                patch_embeds=batch.get("patch_embeds"))
    logits = lm_logits(params, hidden[:, -1:, :], cfg)
    b, s = batch["tokens"].shape
    return logits, dict(kv, pos=torch.full((b,), s, dtype=torch.int32,
                                           device=batch["tokens"].device))


def prefill_chunk(params, batch, cache, cfg):
    """One fixed-size chunk of page-granular prefill, written in place.

    batch: tokens (1, C) int32 zero-padded past `length`; start (1,) global
    position of tokens[:, 0]; length (1,) real rows; page_row
    (pages_per_seq,) the slot's physical page per logical page (null page 0
    beyond the reservation); vlm: patch_rows (1, C, d) the patch embeddings
    of the chunk's positions below n_patch (1,), which take those
    positions; optionally null_page, the page padding rows go to (default
    0; a shard of the sharded engine's global pool passes its own). Only
    the K/V pools (and int8 scale pools) change; returns the same cache
    dict."""
    tokens = batch["tokens"]
    start, length = batch["start"], batch["length"]
    b, C = tokens.shape
    positions = start[:, None] + torch.arange(C, device=tokens.device)[None, :]
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "vlm" and "patch_rows" in batch:
        image = (positions < batch["n_patch"][:, None])[..., None]
        x = torch.where(image, batch["patch_rows"].to(x.dtype), x)
    chunk = {"start": start, "length": length, "page_row": batch["page_row"],
             "null_page": batch.get("null_page", 0)}
    pools = _pools_of(cache)
    for i in range(cfg.n_layers):
        layer_cache = {key: val[i] for key, val in pools.items()}
        x, _ = layer_fn(x, layer_params(params["layers"], i), cfg,
                        positions=positions, mode="chunk", cache=layer_cache,
                        chunk=chunk)
    return cache


def decode_step(params, batch, cache, cfg):
    """One token step. batch: {'tokens': (B,1)}, optionally 'write': (B,)
    bool, False for sequences whose row at `pos` is already in the cache
    (the engine's replay of a prompt's last token): their new K/V row goes
    to the null page (paged) or nowhere (dense), and attention reads the
    stored row; 'null_page' (B,) int32 names each sequence's null page
    for that (default 0; the sharded engine's shards each have their own).
    The pools are written in place; returns (logits (B,1,V)
    f32, cache) with cache['pos'] replaced by pos + 1 (a new tensor: the
    caller may keep the old one). Its products are a decode step's
    (`quantized.decode_products`)."""
    with decode_products():
        return _decode_step(params, batch, cache, cfg)


def _decode_step(params, batch, cache, cfg):
    tokens = batch["tokens"]
    positions = cache["pos"]
    page_table = cache.get("page_table")
    write = batch.get("write")
    extra = {}
    if page_table is not None:
        extra["page_table"] = page_table
        if write is not None:
            null = batch.get("null_page")
            extra["write_table"] = torch.where(
                write[:, None], page_table,
                0 if null is None else null[:, None])
    elif write is not None:
        extra["write_pos"] = torch.where(write, positions,
                                         cache["k"].shape[2])
    x = embed_tokens(params, tokens, cfg)
    pools = _pools_of(cache)
    for i in range(cfg.n_layers):
        layer_cache = {key: val[i] for key, val in pools.items()}
        layer_cache.update(extra)
        x, _ = layer_fn(x, layer_params(params["layers"], i), cfg,
                        positions=positions[:, None], mode="decode",
                        cache=layer_cache)
    x = rms_norm(x, params["final_norm"], plus_one=cfg.norm_plus_one)
    cache["pos"] = positions + 1
    return lm_logits(params, x, cfg), cache


def paged_kv_shapes(L: int, batch: int, max_len: int, kv: int, hd: int,
                    dtype, page_size: int, n_pages: Optional[int],
                    keys: Tuple[str, ...] = ("k", "v")):  # contract: allow(R6)
    """{name: (shape, dtype)}: (L, n_pages, page_size, KV, D) pools, a
    (B, max_len // page_size) page table and pos; int8 adds f16 scale pools.
    Page 0 is the engine's null page, so `n_pages` defaults to one more
    than the dense worst case."""
    assert max_len % page_size == 0, (max_len, page_size)
    pages_per_seq = max_len // page_size
    if n_pages is None:
        n_pages = 1 + batch * pages_per_seq
    shapes = {key: ((L, n_pages, page_size, kv, hd), dtype) for key in keys}
    shapes["page_table"] = ((batch, pages_per_seq), torch.int32)
    shapes["pos"] = ((batch,), torch.int32)
    if dtype == torch.int8:
        for key in keys:
            shapes[key + "s"] = ((L, n_pages, page_size, kv), SCALE_DTYPE)
    return shapes


def cache_shape(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                page_size: Optional[int] = None,
                n_pages: Optional[int] = None):
    """{name: (shape, dtype)} of the layer-stacked KV cache. GQA: kv_pad
    heads x head_dim K and V rows; MLA: ONE latent pool "k" of
    (kv_lora_rank + qk_rope_dim)-wide rows, KV-head dim 1. Dense (default):
    (L, B, max_len, KV, D) rows; paged (`page_size=`): `paged_kv_shapes`.
    int8 adds per-row f16 scales ('ks'/'vs'); fp8 (e5m2) is bare rows, no
    scales."""
    L = cfg.n_layers
    if cfg.attn_kind == "mla":
        kv, hd, keys = 1, cfg.mla_latent_dim, ("k",)
    else:
        kv, hd, keys = cfg.kv_pad, cfg.head_dim, ("k", "v")  # contract: allow(R6)
    if page_size is not None:
        return paged_kv_shapes(L, batch, max_len, kv, hd, dtype, page_size,
                               n_pages, keys)
    shapes = {key: ((L, batch, max_len, kv, hd), dtype) for key in keys}
    shapes["pos"] = ((batch,), torch.int32)
    if dtype == torch.int8:
        for key in keys:
            shapes[key + "s"] = ((L, batch, max_len, kv), SCALE_DTYPE)
    return shapes


def alloc_cache(shapes, device):
    """Zero tensors for a `cache_shape` tree: dicts and lists (the hybrid
    family's per-layer states) of (shape, dtype) leaves."""
    if isinstance(shapes, dict):
        return {k: alloc_cache(v, device) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [alloc_cache(v, device) for v in shapes]
    shape, dtype = shapes
    return torch.zeros(shape, dtype=dtype, device=device)
