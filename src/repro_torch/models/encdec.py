"""Encoder-decoder transformer, the encdec family (seamless-m4t-medium
backbone; port of `repro/models/encdec.py`).

The audio frontend is a stub in both packages: the encoder takes frame
embeddings (B, cross_len, d_model). A bidirectional encoder of
`n_enc_layers` feeds a causal decoder of `n_dec_layers`, each decoder
layer with self-attention, cross attention over the encoder's rows and a
GLU FFN. Both self-attentions go through the one attention core
(`transformer.attn_block`: causal=False for the encoder). Cross attention
has no rope, no causal mask and writes no cache: its K/V depend on the
frames alone, are computed once a request (`prefill_cross`, or inside a
monolithic `prefill`) and stay dense, one (cross_len, KV, D) block a slot
and layer, beside the decoder's self-attention pools, which are dense or
paged as the engine's layout says.

Cross-attention rows run through `attention(causal=False)` (the dense CUDA
kernel on the card, with Sq != Sk) in prefill and chunk mode, and through
`decode_attention` over the slot's cross rows at depth `cross_len` in
decode mode. The dense kernel's row depends on its query and the keys
only, so a chunk's cross row equals a monolithic prefill's. The encoder
and the cross K/V always run `cross_len` rows, so their products run as
one call each (`quantized.one_product`), with the bits of any path that
runs them.

The frames are cast to the embeddings' dtype before the encoder: on the
card the kernels take one dtype for q, k and v.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ParamDef, rms_norm
from repro_torch.models.quantized import (
    SCALE_DTYPE, decode_products, one_product, qeinsum)
from repro_torch.models.transformer import (
    DEFAULT_OPTS, ExecOptions, _expand_kv, _kv_round_of, _pools_of, _remat,
    attn_block, attn_schema, chunked_ce_loss, dense_ffn, embed_tokens,
    head_mask, layer_params, layer_views, lm_head_weights, lm_logits,
    paged_kv_shapes, pool_data_keys)

_CROSS_KEYS = ("ck", "cv")


def _ffn_params(L, d, f):
    return {
        "w1": ParamDef((L, d, f), ("layers", "embed", "ff")),
        "w3": ParamDef((L, d, f), ("layers", "embed", "ff")),
        "w2": ParamDef((L, f, d), ("layers", "ff", "embed")),
    }


def schema(cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    Le, Ld, v = cfg.n_enc_layers, cfg.n_dec_layers, cfg.padded_vocab
    enc = {"attn_norm": ParamDef((Le, d), ("layers", None), init="ones"),
           "ffn_norm": ParamDef((Le, d), ("layers", None), init="ones")}
    enc.update(attn_schema(cfg, Le))
    enc.update(_ffn_params(Le, d, f))
    dec = {"attn_norm": ParamDef((Ld, d), ("layers", None), init="ones"),
           "cross_norm": ParamDef((Ld, d), ("layers", None), init="ones"),
           "ffn_norm": ParamDef((Ld, d), ("layers", None), init="ones")}
    dec.update(attn_schema(cfg, Ld))
    dec.update(attn_schema(cfg, Ld, prefix="c"))
    dec.update(_ffn_params(Ld, d, f))
    return {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small_normal"),
        "enc_norm": ParamDef((d,), (None,), init="ones"),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "enc": enc,
        "dec": dec,
    }


def _layers(stacked, n: int, train: bool):
    """Every layer's parameter slices: one unbind a leaf under autograd
    (`layer_views`), views of the stacked leaves otherwise."""
    if train:
        return layer_views(stacked)
    return [layer_params(stacked, i) for i in range(n)]


def _head_masked(o, cfg):
    if cfg.n_heads_padded != cfg.n_heads:    # dead pad heads contribute 0
        o = o * head_mask(cfg, o.dtype, o.device)[None, None, :, None]
    return o


def _cross_kv(enc_out, p):
    """A layer's cross K/V rows (B, cross_len, KVp, D) of the encoder's
    output, each product one call."""
    with one_product():
        return (qeinsum("bsd,dhk->bshk", enc_out, p["cwk"]),
                qeinsum("bsd,dhk->bshk", enc_out, p["cwv"]))


def _cross_attn_full(x, p, cfg, opts, enc_out, kv_round=None):
    """Cross attention of train/prefill. Returns (out, (ck, cv)).

    `kv_round` (prefill with a bf16 cross cache; an int8 engine keeps the
    cross cache f32) rounds the attended ck/cv through the storage dtype,
    so the monolithic prefill sees the cross K/V that the decode steps and
    the chunked prefill read back from the cache."""
    q = qeinsum("bsd,dhk->bshk", x, p["cwq"])
    ck, cv = _cross_kv(enc_out, p)
    ka, va = (ck, cv) if kv_round is None else (
        ck.to(kv_round).to(ck.dtype), cv.to(kv_round).to(cv.dtype))
    kx, vx = _expand_kv(ka, va, cfg)
    o = attn_mod.attention(q[:, :, :, None, :], kx, vx, causal=False,
                           scale=cfg.head_dim ** -0.5, impl=opts.attn_impl,
                           q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    o = _head_masked(o[:, :, :, 0, :], cfg)
    return qeinsum("bshk,hkd->bsd", o, p["cwo"]), (ck, cv)


def _cross_attn_cached(x, p, cfg, opts, cache, mode):
    """Cross attention against the slot's cached ck/cv rows: 'decode' runs
    decode attention at the fixed depth cross_len; 'chunk' full unmasked
    attention of the chunk's C rows over them (B = 1)."""
    b = x.shape[0]
    kvp, gp = cfg.padded_kv_group
    scale = cfg.head_dim ** -0.5
    cq = qeinsum("bsd,dhk->bshk", x, p["cwq"])
    if mode == "decode":
        se = cache["ck"].shape[1]
        co = attn_mod.decode_attention(
            cq.reshape(b, 1, kvp, gp, cfg.head_dim), cache["ck"],
            cache["cv"], se, scale=scale)
        co = co.reshape(b, 1, cfg.n_heads_padded, cfg.head_dim)
    else:  # chunk
        ckx, cvx = _expand_kv(cache["ck"].to(x.dtype), cache["cv"].to(x.dtype),
                              cfg)
        co = attn_mod.attention(cq[:, :, :, None, :], ckx, cvx, causal=False,
                                scale=scale, impl=opts.attn_impl,
                                q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
        co = co[:, :, :, 0, :]
    return qeinsum("bshk,hkd->bsd", _head_masked(co, cfg), p["cwo"])


def _enc_layer(h, lp, cfg, positions, opts):
    a, _ = attn_block(rms_norm(h, lp["attn_norm"]), lp, cfg,
                      positions=positions, mode="train", causal=False,
                      opts=opts)
    h = h + a
    return h + dense_ffn(rms_norm(h, lp["ffn_norm"]), lp, cfg)


def encode(params, frames, cfg, opts: ExecOptions = DEFAULT_OPTS, *,
           train: bool = False, remat: str = "none"):
    """The encoder over frames (B, cross_len, d_model): (B, cross_len,
    d_model) normed rows in the embeddings' dtype. Its products run as one
    call each (`one_product`): it always runs cross_len rows. `train`: the
    layer slices for autograd (`layer_views`), each layer under `remat`."""
    x = frames.to(device=params["embed"].device, dtype=params["embed"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layer = _remat(_enc_layer, remat) if train else _enc_layer
    with one_product():
        for lp in _layers(params["enc"], cfg.n_enc_layers, train):
            x = layer(x, lp, cfg, positions, opts)
    return rms_norm(x, params["enc_norm"])


def _dec_layer(h, lp, cfg, opts, positions, enc_out, mode, cache=None,
               kv_round=None, chunk=None):
    # decoder self-attention is the one core (transformer.attn_block)
    a, new_cache = attn_block(rms_norm(h, lp["attn_norm"]), lp, cfg,
                              positions=positions, mode=mode, cache=cache,
                              kv_round=kv_round if mode == "prefill" else None,
                              chunk=chunk, opts=opts)
    h = h + a
    xn = rms_norm(h, lp["cross_norm"])
    if mode in ("train", "prefill"):
        # the cross cache stays f32 under int8 KV (cache_shape), so only a
        # float kv_round rounds the cross attention's inputs
        cross_round = kv_round if (mode == "prefill"
                                   and kv_round not in (None, torch.int8)) \
            else None
        ca, (ck, cv) = _cross_attn_full(xn, lp, cfg, opts, enc_out,
                                        kv_round=cross_round)
        if mode == "prefill":
            new_cache = dict(new_cache, ck=ck, cv=cv)
    else:  # decode / chunk: the slot's cached cross K/V
        ca = _cross_attn_cached(xn, lp, cfg, opts, cache, mode)
    h = h + ca
    return h + dense_ffn(rms_norm(h, lp["ffn_norm"]), lp, cfg), new_cache


def _train_dec_layer(h, lp, enc_out, cfg, positions, opts):
    return _dec_layer(h, lp, cfg, opts, positions, enc_out, "train")[0]


def decode_stack(params, tokens, cfg, opts, enc_out, *, mode: str,
                 kv_round=None, remat: str = "none"):
    """The decoder over whole token rows ('train' or 'prefill'): (final-
    normed hidden, None or the layer-stacked self K/V and cross K/V)."""
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    if mode == "train":
        layer = _remat(_train_dec_layer, remat)
        for lp in _layers(params["dec"], cfg.n_dec_layers, True):
            x = layer(x, lp, enc_out, cfg, positions, opts)
        return rms_norm(x, params["final_norm"]), None
    if mode != "prefill":
        raise ValueError(f"decode_stack mode {mode!r}")
    rows: Dict[str, list] = {}
    for lp in _layers(params["dec"], cfg.n_dec_layers, False):
        x, kv = _dec_layer(x, lp, cfg, opts, positions, enc_out, "prefill",
                           kv_round=kv_round)
        for key in pool_data_keys(kv) + _CROSS_KEYS:
            rows.setdefault(key, []).append(kv[key])
    cache = {key: torch.stack(val) for key, val in rows.items()}
    return rms_norm(x, params["final_norm"]), cache


def train_loss(params, batch, cfg, *, ce_chunk: int = 512,
               remat: str = "none", opts: ExecOptions = DEFAULT_OPTS):
    """(mean next-token CE, {"loss": it}) of batch {'frames' (B, cross_len,
    d), 'tokens', 'labels' (B, S)}."""
    enc_out = encode(params, batch["frames"], cfg, opts, train=True,
                     remat=remat)
    hidden, _ = decode_stack(params, batch["tokens"], cfg, opts, enc_out,
                             mode="train", remat=remat)
    loss = chunked_ce_loss(hidden, lm_head_weights(params, cfg),
                           batch["labels"], cfg, ce_chunk=ce_chunk,
                           remat=remat)
    return loss, {"loss": loss}


def _pos(batch):
    b, s = batch["tokens"].shape
    return torch.full((b,), s, dtype=torch.int32,
                      device=batch["tokens"].device)


def prefill_cache(params, batch, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """Cache-only prefill (no LM head): self K/V (L, B, S, KV, D), cross
    K/V (L, B, cross_len, KV, D) and pos."""
    enc_out = encode(params, batch["frames"], cfg, opts)
    _, cache = decode_stack(params, batch["tokens"], cfg, opts, enc_out,
                            mode="prefill", kv_round=_kv_round_of(batch))
    return dict(cache, pos=_pos(batch))


def prefill(params, batch, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """Returns (last-position logits (B, 1, V) f32, cache dict)."""
    enc_out = encode(params, batch["frames"], cfg, opts)
    hidden, cache = decode_stack(params, batch["tokens"], cfg, opts,
                                 enc_out, mode="prefill",
                                 kv_round=_kv_round_of(batch))
    return lm_logits(params, hidden[:, -1:, :], cfg), dict(cache,
                                                           pos=_pos(batch))


def prefill_cross(params, batch, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """The encoder and every layer's cross K/V: the admission-time half of
    a chunked prefill. {'ck', 'cv': (L, B, cross_len, KVp, D)}; the engine
    pastes them into the slot's cross rows once a request, and every chunk
    and decode step reads them back."""
    enc_out = encode(params, batch["frames"], cfg, opts)
    kv = [_cross_kv(enc_out, lp)
          for lp in _layers(params["dec"], cfg.n_dec_layers, False)]
    return {"ck": torch.stack([k for k, _ in kv]),
            "cv": torch.stack([v for _, v in kv])}


def _layer_cache(pools, cache, i: int, slot=None):
    """Layer i's self pools and cross rows (all slots, or the slot whose
    index is the (1,) tensor `slot`, as a batch of one)."""
    lc = {key: val[i] for key, val in pools.items()}
    for key in _CROSS_KEYS:
        lc[key] = cache[key][i] if slot is None \
            else cache[key][i].index_select(0, slot)
    return lc


def prefill_chunk(params, batch, cache, cfg,
                  opts: ExecOptions = DEFAULT_OPTS):
    """One fixed-size chunk of paged decoder prefill, written in place (the
    contract of `transformer.prefill_chunk`); batch also carries `slot`
    (an int or a (1,) device tensor, so that a captured chunk step serves
    every slot), whose cross rows the chunk's cross attention reads."""
    tokens = batch["tokens"]
    start, length = batch["start"], batch["length"]
    slot = torch.as_tensor(batch["slot"], device=tokens.device).reshape(1)
    C = tokens.shape[1]
    positions = start[:, None] + torch.arange(C, device=tokens.device)[None, :]
    x = embed_tokens(params, tokens, cfg)
    chunk = {"start": start, "length": length, "page_row": batch["page_row"]}
    pools = _pools_of(cache)
    for i, lp in enumerate(_layers(params["dec"], cfg.n_dec_layers, False)):
        x, _ = _dec_layer(x, lp, cfg, opts, positions, None, "chunk",
                          _layer_cache(pools, cache, i, slot), chunk=chunk)
    return cache


def decode_step(params, batch, cache, cfg, opts: ExecOptions = DEFAULT_OPTS):
    """One token step over every slot (the contract of
    `transformer.decode_step`, write mask included, its products a decode
    step's); each layer's cross attention reads the slots' cross rows at
    depth cross_len."""
    with decode_products():
        return _decode_step(params, batch, cache, cfg, opts)


def _decode_step(params, batch, cache, cfg, opts):
    tokens = batch["tokens"]
    positions = cache["pos"]
    page_table = cache.get("page_table")
    write = batch.get("write")
    extra = {}
    if page_table is not None:
        extra["page_table"] = page_table
        if write is not None:
            extra["write_table"] = torch.where(write[:, None], page_table, 0)
    elif write is not None:
        extra["write_pos"] = torch.where(write, positions,
                                         cache["k"].shape[2])
    x = embed_tokens(params, tokens, cfg)
    pools = _pools_of(cache)
    for i, lp in enumerate(_layers(params["dec"], cfg.n_dec_layers, False)):
        lc = _layer_cache(pools, cache, i)
        lc.update(extra)
        x, _ = _dec_layer(x, lp, cfg, opts, positions[:, None], None,
                          "decode", lc)
    x = rms_norm(x, params["final_norm"])
    cache["pos"] = positions + 1
    return lm_logits(params, x, cfg), cache


def cache_shape(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                page_size: Optional[int] = None,
                n_pages: Optional[int] = None):
    """{name: (shape, dtype)}: the decoder's self K/V, dense (L, B,
    max_len, KV, D) or paged (`page_size=`: `transformer.paged_kv_shapes`),
    and the cross K/V, dense per slot (L, B, cross_len, KV, D): written
    once a request at a fixed depth, paging would buy nothing. An int8
    cache quantizes the self K/V only (f16 row scales 'ks'/'vs'); the cross
    K/V stay f32, read every step."""
    L, kv, hd, se = cfg.n_dec_layers, cfg.kv_pad, cfg.head_dim, cfg.cross_len
    cross_dtype = torch.float32 if dtype == torch.int8 else dtype
    cross = {key: ((L, batch, se, kv, hd), cross_dtype) for key in _CROSS_KEYS}
    if page_size is not None:
        return {**paged_kv_shapes(L, batch, max_len, kv, hd, dtype,
                                  page_size, n_pages), **cross}
    shapes = {key: ((L, batch, max_len, kv, hd), dtype)
              for key in ("k", "v")}  # contract: allow(R6) the self pools
    shapes["pos"] = ((batch,), torch.int32)
    if dtype == torch.int8:
        for key in ("ks", "vs"):
            shapes[key] = ((L, batch, max_len, kv), SCALE_DTYPE)
    return {**shapes, **cross}
