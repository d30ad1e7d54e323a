"""MLA, multi-head latent attention (DeepSeek-V2; port of
`repro/models/mla.py`).

The cache holds ONE latent row per token instead of per-head K/V rows:

    latent = [ rms_norm(x @ wkv_a)[:r] ; rope(x @ wkv_a)[r:] ]   (r + p wide)

with r = kv_lora_rank and p = qk_rope_dim. Keys and values are never made
per head: the key up-projection `wk_b` is folded into the query and the
value up-projection `wv_b` into the output (the absorbed form):

    q_eff[h] = [ q_nope[h] @ wk_b[:, h, :].T ; rope(q_pe[h]) ]   (r + p wide)
    scores   = q_eff · latent * (qk_nope_dim + qk_rope_dim) ** -0.5
    values   = latent[..., :r]           (shared by every head: MQA shape)
    out[h]   = (scores-weighted values) @ wv_b[:, h, :] @ wo[h]

Decode and chunk attention read one (r + p)-wide row per token, KV-head dim
1, passing the single pool as both k and v with `v_dim=r`. On the card the
attention kernels read the latent rows themselves (the JAX package sends
them to its jnp path), and monolithic prefill runs the chunk kernel over
its rows (`models.attention.latent_attention`), so that chunked and
monolithic prefill are row-equal; the CPU takes the plain versions.

The family shares the GQA core's mode contract and cache write helpers
(`_write_row`/`_write_chunk`/`_round_rows` in `models/transformer.py`), so
the engine's pools, int8 scales, prefix cache and window recycling work on
its single "k" pool (plus "ks" for int8) unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (  # contract: allow(R2) MLA's core
    ParamDef, apply_rope, rms_norm)
from repro_torch.models.quantized import qeinsum


def mla_schema(cfg, L: int) -> Dict[str, Any]:
    """Per-layer MLA projections (layer-stacked, head-padded like GQA): wq,
    or the wq_a/q_norm/wq_b low-rank pair when q_lora_rank > 0, to per-head
    [qk_nope ; qk_rope] queries; wkv_a to the shared latent row; wk_b/wv_b
    the absorbed key/value up-projections; wo from per-head v_head_dim
    outputs back to d_model."""
    d, hp = cfg.d_model, cfg.n_heads_padded
    r, qk, vd = cfg.kv_lora_rank, cfg.mla_qk_dim, cfg.mla_v_dim
    assert r > 0 and cfg.qk_nope_dim > 0 and cfg.qk_rope_dim > 0, cfg.name
    sch: Dict[str, Any] = {}
    if cfg.q_lora_rank > 0:
        sch["wq_a"] = ParamDef((L, d, cfg.q_lora_rank),
                               ("layers", "embed", None))
        sch["q_norm"] = ParamDef((L, cfg.q_lora_rank), ("layers", None),
                                 init="ones")
        sch["wq_b"] = ParamDef((L, cfg.q_lora_rank, hp, qk),
                               ("layers", None, "heads", None))
    else:
        sch["wq"] = ParamDef((L, d, hp, qk), ("layers", "embed", "heads", None))
    sch["wkv_a"] = ParamDef((L, d, cfg.mla_latent_dim),
                            ("layers", "embed", None))
    sch["kv_norm"] = ParamDef((L, r), ("layers", None), init="ones")
    sch["wk_b"] = ParamDef((L, r, hp, cfg.qk_nope_dim),
                           ("layers", None, "heads", None))
    sch["wv_b"] = ParamDef((L, r, hp, vd), ("layers", None, "heads", None))
    sch["wo"] = ParamDef((L, hp, vd, d), ("layers", "heads", None, "embed"))
    return sch


def mla_attn_block(x, p, cfg, opts, *, positions, mode, cache=None,
                   kv_round=None, chunk=None):
    """MLA self-attention under the `attn_block` mode contract: the same
    four modes and (out, cache entry) return, with a single latent pool
    under "k" ("ks" scales when int8). Decode writes through the engine's
    write mask (`write_pos`/`write_table`) as the GQA core does."""
    from repro_torch.models.transformer import (
        _pool_entry, _round_rows, _write_chunk, _write_row, head_mask)
    r, pdim = cfg.kv_lora_rank, cfg.qk_rope_dim
    hp = cfg.n_heads_padded
    b = x.shape[0]

    # shared latent row: [rms_norm(compressed kv) ; rope(shared k_pe)]
    ckv = qeinsum("bsd,dr->bsr", x, p["wkv_a"])
    k_pe = apply_rope(ckv[..., None, r:], positions,  # contract: allow(R2)
                      theta=cfg.rope_theta)
    latent = torch.cat(
        [rms_norm(ckv[..., :r], p["kv_norm"])[:, :, None, :], k_pe], dim=-1)

    # absorbed queries: (B, S, Hp, r + p)
    if "wq_a" in p:
        qc = rms_norm(qeinsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
        q = qeinsum("bsr,rhk->bshk", qc, p["wq_b"])
    else:
        q = qeinsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_pe = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_pe = apply_rope(q_pe, positions,  # contract: allow(R2)
                      theta=cfg.rope_theta)
    q_eff = torch.cat(
        [torch.einsum("bshn,rhn->bshr", q_nope, p["wk_b"]), q_pe], dim=-1)
    scale = cfg.mla_qk_dim ** -0.5          # the uncompressed qk width

    if mode in ("train", "prefill"):
        lat = latent if mode == "train" else _round_rows(latent, kv_round)
        o = attn_mod.latent_attention(
            q_eff[:, :, None, :, :], lat, r, window=cfg.window, scale=scale,
            impl=opts.attn_impl, q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
        o = o[:, :, 0, :, :]
        new_cache = {"k": latent} if mode == "prefill" else None
    elif mode == "chunk":
        assert cache is not None and chunk is not None
        C = x.shape[1]
        pool, scales = _write_chunk(cache, "k", latent[0], chunk)
        o = attn_mod.chunk_attention_paged(
            q_eff.reshape(b, C, 1, hp, r + pdim), pool, pool,
            chunk["page_row"][None], chunk["start"],
            kv_len=chunk["start"] + chunk["length"], window=cfg.window,
            scale=scale, k_scale=scales, v_scale=scales, v_dim=r)
        o = o.reshape(b, C, hp, r)
        new_cache = _pool_entry(k=pool, ks=scales)
    elif mode == "decode":
        assert cache is not None
        pos_b = positions.reshape(-1)
        page_table = cache.get("page_table")
        wpos = cache.get("write_pos", pos_b)
        wtable = cache.get("write_table", page_table)
        pool, scales = _write_row(cache, "k", latent, wpos, wtable)
        o = attn_mod.decode_attention(
            q_eff.reshape(b, 1, 1, hp, r + pdim), pool, pool, pos_b + 1,
            window=cfg.window, scale=scale, page_table=page_table,
            k_scale=scales, v_scale=scales, v_dim=r)
        o = o.reshape(b, 1, hp, r)
        new_cache = _pool_entry(k=pool, ks=scales)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    # latent-space head outputs → per-head values → d_model
    if hp != cfg.n_heads:                   # dead pad heads contribute 0
        o = o * head_mask(cfg, o.dtype, o.device)[None, None, :, None]
    heads = torch.einsum("bshr,rhv->bshv", o, p["wv_b"])
    return qeinsum("bshv,hvd->bsd", heads, p["wo"]), new_cache
