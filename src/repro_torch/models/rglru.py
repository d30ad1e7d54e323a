"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention in a (rec, rec, attn) pattern (port of `repro/models/rglru.py`).

The RG-LRU recurrence h_t = a_t·h_{t-1} + √(1−a_t²)·(i_t⊙x_t) with
a_t = exp(−c·softplus(Λ)·r_t) runs in f32 as a log-depth doubling scan
within chunks of `cfg.ssm_chunk` positions, carrying h between chunks (the
JAX package's `jax.lax.associative_scan`; its f32 sums are ordered
otherwise, so the two agree within a tolerance, not bit for bit). Local
attention is causal MQA over a window of `cfg.window` keys: prefill runs
the full-sequence `attention` (the dense flash kernel on the card), decode
writes slot pos mod window of a per-layer ring and attends its
min(pos + 1, window) rows.

The layer pattern is heterogeneous, so params are stacked per block type
('rec', 'attn') and the MLP and norms over all layers ('mlp'); the layer
loop indexes those stacks. The cache is {'layers': [per layer: rec {'h':
(B, w) f32, 'conv': (B, K-1, w)} or attn {'k', 'v': (B, window, KV, D)}],
'pos': (B,)}; decode writes it in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (  # contract: allow(R2) local attention
    ParamDef, act_fn, apply_rope, causal_conv1d, glu_act, rms_norm)
from repro_torch.models.quantized import decode_products, qeinsum
from repro_torch.models.ssm import softplus
from repro_torch.models.transformer import (
    DEFAULT_OPTS, _expand_kv, _remat, attn_schema, chunked_ce_loss,
    embed_tokens, head_mask, layer_params, layer_views, lm_head_weights,
    lm_logits)

LRU_C = 8.0


def _counts(cfg):
    pat = cfg.layer_pattern()
    return sum(1 for b in pat if b == "rec"), sum(1 for b in pat if b == "attn")


def schema(cfg) -> Dict[str, Any]:
    d, w, f = cfg.d_model, cfg.lru_width, cfg.d_ff
    L, v, k = cfg.n_layers, cfg.padded_vocab, cfg.conv_kernel
    nr, na = _counts(cfg)
    ni = "zeros" if cfg.norm_plus_one else "ones"
    rec = {
        "in_x": ParamDef((nr, d, w), ("layers", "embed", "ff")),
        "in_gate": ParamDef((nr, d, w), ("layers", "embed", "ff")),
        "conv_w": ParamDef((nr, k, w), ("layers", None, "ff"), init="small_normal"),
        "gate_a_w": ParamDef((nr, w, w), ("layers", "embed", "ff"), scale=0.5),
        "gate_a_b": ParamDef((nr, w), ("layers", "ff"), init="zeros"),
        "gate_x_w": ParamDef((nr, w, w), ("layers", "embed", "ff"), scale=0.5),
        "gate_x_b": ParamDef((nr, w), ("layers", "ff"), init="zeros"),
        "lam": ParamDef((nr, w), ("layers", "ff"), init="ones"),
        "out": ParamDef((nr, w, d), ("layers", "ff", "embed")),
    }
    mlp = {
        "t_norm": ParamDef((L, d), ("layers", None), init=ni),
        "m_norm": ParamDef((L, d), ("layers", None), init=ni),
        "w1": ParamDef((L, d, f), ("layers", "embed", "ff")),
        "w3": ParamDef((L, d, f), ("layers", "embed", "ff")),
        "w2": ParamDef((L, f, d), ("layers", "ff", "embed")),
    }
    return {
        "embed": ParamDef((v, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": ParamDef((d,), (None,), init=ni),
        "rec": rec,
        "attn": attn_schema(cfg, na),
        "mlp": mlp,
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_gates(x, rp):
    """x: (B,S,w) → decay a (f32), gated input gx (f32)."""
    r = torch.sigmoid(qeinsum("bsw,wv->bsv", x, rp["gate_a_w"]).float()
                      + rp["gate_a_b"].float())
    i = torch.sigmoid(qeinsum("bsw,wv->bsv", x, rp["gate_x_w"]).float()
                      + rp["gate_x_b"].float())
    la = -LRU_C * softplus(rp["lam"].float()) * r
    a = torch.exp(la)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, gx


def rg_lru_scan(a, gx, h0: Optional[torch.Tensor] = None):
    """Linear recurrence h_t = a_t·h_{t-1} + gx_t over axis 1, as a
    log-depth doubling scan: after the step of stride d, position t holds
    the composition of positions (t - 2d, t]."""
    if h0 is not None:
        # fold the initial state into the first input
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], 1)
    av, bv = a, gx
    s, d = a.shape[1], 1
    while d < s:
        bv = torch.cat([bv[:, :d], av[:, d:] * bv[:, :-d] + bv[:, d:]], 1)
        av = torch.cat([av[:, :d], av[:, d:] * av[:, :-d]], 1)
        d *= 2
    return bv  # (B,S,w) hidden states


def rg_lru_scan_chunked(a, gx, h0: Optional[torch.Tensor] = None, *,
                        chunk: int = 256):
    """`rg_lru_scan` within chunks of `chunk` positions (the last one
    ragged), carrying h from chunk to chunk: log2(chunk) doubling steps a
    chunk, each over at most `chunk` rows."""
    s = a.shape[1]
    h, outs = h0, []
    for c0 in range(0, s, min(chunk, s)):
        hs = rg_lru_scan(a[:, c0:c0 + chunk], gx[:, c0:c0 + chunk], h0=h)
        h = hs[:, -1]
        outs.append(hs)
    return torch.cat(outs, 1) if len(outs) > 1 else outs[0]


def rec_block_full(x, rp, cfg):
    """Full-sequence recurrent block. Returns (out, state dict)."""
    gate = act_fn("gelu")(qeinsum("bsd,dw->bsw", x, rp["in_gate"]))
    xr = qeinsum("bsd,dw->bsw", x, rp["in_x"])
    xr, conv_state = causal_conv1d(xr, rp["conv_w"])
    a, gx = _lru_gates(xr, rp)
    h = rg_lru_scan_chunked(a, gx, chunk=cfg.ssm_chunk)
    y = h.to(x.dtype) * gate
    out = qeinsum("bsw,wd->bsd", y, rp["out"])
    return out, {"h": h[:, -1].float(), "conv": conv_state}


def rec_block_decode(x, rp, cfg, state):
    """One-step recurrent block. x: (B,1,d)."""
    gate = act_fn("gelu")(qeinsum("bsd,dw->bsw", x, rp["in_gate"]))
    xr = qeinsum("bsd,dw->bsw", x, rp["in_x"])
    xr, conv_state = causal_conv1d(xr, rp["conv_w"], state=state["conv"])
    a, gx = _lru_gates(xr, rp)
    h = a[:, 0] * state["h"] + gx[:, 0]
    y = h[:, None].to(x.dtype) * gate
    out = qeinsum("bsw,wd->bsd", y, rp["out"])
    return out, {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# Local attention (MQA, window)
# ---------------------------------------------------------------------------

def _qkv(x, ap, cfg, positions):
    q = qeinsum("bsd,dhk->bshk", x, ap["wq"])
    k = qeinsum("bsd,dhk->bshk", x, ap["wk"])
    v = qeinsum("bsd,dhk->bshk", x, ap["wv"])
    q = apply_rope(q, positions, theta=cfg.rope_theta)  # contract: allow(R2)
    k = apply_rope(k, positions, theta=cfg.rope_theta)  # contract: allow(R2)
    return q, k, v


def _out(o, ap, cfg):
    if cfg.n_heads_padded != cfg.n_heads:    # dead pad heads contribute 0
        o = o * head_mask(cfg, o.dtype, o.device)[None, None, :, None]
    return qeinsum("bshk,hkd->bsd", o, ap["wo"])


def ring_of(rows, window: int):
    """(B, S, KV, D) rows → the (B, window, KV, D) ring decode continues
    from (slot = position mod window): the last `window` rows rolled by
    S mod window when S >= window, zero rows past S otherwise."""
    s = rows.shape[1]
    if s >= window:
        return torch.roll(rows[:, s - window:], s % window, dims=1)
    pad = rows.new_zeros((rows.shape[0], window - s) + rows.shape[2:])
    return torch.cat([rows, pad], dim=1)


def attn_block_full(x, ap, cfg, opts, positions, want_cache):
    q, k, v = _qkv(x, ap, cfg, positions)
    kx, vx = _expand_kv(k, v, cfg)
    o = attn_mod.attention(q[:, :, :, None, :], kx, vx, causal=True,
                           window=cfg.window, scale=cfg.head_dim ** -0.5,
                           impl=opts.attn_impl, q_chunk=opts.q_chunk,
                           kv_chunk=opts.kv_chunk)
    cache = None
    if want_cache:
        cache = {"k": ring_of(k, cfg.window), "v": ring_of(v, cfg.window)}
    return _out(o[:, :, :, 0, :], ap, cfg), cache


def attn_block_decode(x, ap, cfg, positions, cache):
    """x: (B,1,d); cache k/v: (B, window, KV, D) rings, written in place at
    slot positions mod window (the JAX package's one-hot blend, which
    equals a row write); attends min(pos + 1, window) rows, no window
    argument: the ring holds exactly the window."""
    b = x.shape[0]
    w = cfg.window
    q, k, v = _qkv(x, ap, cfg, positions[:, None])
    rows = torch.arange(b, device=x.device)
    slot = (positions % w).long()
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    kvp, gp = cfg.padded_kv_group
    qg = q.reshape(b, 1, kvp, gp, cfg.head_dim)
    o = attn_mod.decode_attention(qg, cache["k"], cache["v"],
                                  torch.clamp(positions + 1, max=w),
                                  scale=cfg.head_dim ** -0.5)
    o = o.reshape(b, 1, cfg.n_heads_padded, cfg.head_dim)
    return _out(o, ap, cfg), cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _mlp(x, mp, cfg):
    act = act_fn(glu_act(cfg.activation))
    h = act(qeinsum("bsd,df->bsf", x, mp["w1"])) \
        * qeinsum("bsd,df->bsf", x, mp["w3"])
    return qeinsum("bsf,fd->bsd", h, mp["w2"])


def _layer(x, mp, kind, bp, cfg, opts, positions, mode, lc):
    """One layer (temporal block + MLP). Returns (x, state or None)."""
    xn = rms_norm(x, mp["t_norm"], plus_one=cfg.norm_plus_one)
    if kind == "rec":
        if mode == "decode":
            t_out, st = rec_block_decode(xn, bp, cfg, lc)
        else:
            t_out, st = rec_block_full(xn, bp, cfg)
    elif mode == "decode":
        t_out, st = attn_block_decode(xn, bp, cfg, positions, lc)
    else:
        t_out, st = attn_block_full(xn, bp, cfg, opts, positions,
                                    want_cache=(mode == "prefill"))
    x = x + t_out
    m = _mlp(rms_norm(x, mp["m_norm"], plus_one=cfg.norm_plus_one), mp, cfg)
    return x + m, (st if mode != "train" else None)


def forward(params, tokens, cfg, opts, *, mode: str = "train", cache=None,
            positions=None, remat: str = "none"):
    """mode: train | prefill | decode. Returns (final-normed hidden,
    per-layer states: a new list in prefill mode, `cache` (written in
    place) in decode mode, [] in train mode). The JAX package's train path
    scans over whole (rec, rec, attn) groups only to steer XLA's memory;
    its result is this loop's."""
    opts = opts or DEFAULT_OPTS
    x = embed_tokens(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    if mode == "train":
        views = {key: layer_views(params[key]) for key in ("rec", "attn",
                                                           "mlp")}
        layer = _remat(lambda x, mp, kind, bp: _layer(
            x, mp, kind, bp, cfg, opts, positions, "train", None)[0], remat)
    else:
        nr, na = _counts(cfg)
        views = {key: [layer_params(params[key], i) for i in range(n)]
                 for key, n in (("rec", nr), ("attn", na),
                                ("mlp", cfg.n_layers))}
    states = []
    ri = ai = 0
    for li, kind in enumerate(cfg.layer_pattern()):
        mp = views["mlp"][li]
        bp = views[kind][ri if kind == "rec" else ai]
        if mode == "train":
            x = layer(x, mp, kind, bp)
        else:
            lc = None if cache is None else cache[li]
            x, st = _layer(x, mp, kind, bp, cfg, opts, positions, mode, lc)
            states.append(st)
        ri, ai = ri + (kind == "rec"), ai + (kind == "attn")
    x = rms_norm(x, params["final_norm"], plus_one=cfg.norm_plus_one)
    return x, states


def train_loss(params, batch, cfg, *, ce_chunk: int = 512,
               remat: str = "none", opts=None):
    hidden, _ = forward(params, batch["tokens"], cfg, opts, mode="train",
                        remat=remat)
    loss = chunked_ce_loss(hidden, lm_head_weights(params, cfg),
                           batch["labels"], cfg, ce_chunk=ce_chunk,
                           remat=remat)
    return loss, {"loss": loss}


def prefill(params, batch, cfg, opts=None):
    """Exact-length prefill: (last-position logits (B,1,V) f32, softcapped;
    cache {'layers', 'pos'})."""
    tokens = batch["tokens"]
    hidden, states = forward(params, tokens, cfg, opts, mode="prefill")
    logits = lm_logits(params, hidden[:, -1:, :], cfg)
    b, s = tokens.shape
    return logits, {"layers": states, "pos": torch.full(
        (b,), s, dtype=torch.int32, device=tokens.device)}


def decode_step(params, batch, cache, cfg, opts=None):
    """One token step over batch {'tokens': (B,1)}; every layer's state is
    written in place. Returns (softcapped logits (B,1,V) f32, cache) with
    cache['pos'] replaced by pos + 1. Its products are a decode step's
    (`quantized.decode_products`)."""
    pos = cache["pos"]
    with decode_products():
        hidden, layers = forward(params, batch["tokens"], cfg, opts,
                                 mode="decode", cache=cache["layers"],
                                 positions=pos)
        for dst, src in zip(cache["layers"], layers):
            for key, val in src.items():
                if val is not dst[key]:
                    dst[key].copy_(val)
        logits = lm_logits(params, hidden, cfg)
    cache["pos"] = pos + 1
    return logits, cache


def cache_shape(cfg, batch: int, max_len: int, dtype=torch.float32):
    """{'layers': [per layer {name: (shape, dtype)}], 'pos'}: rec h (B, w)
    f32 and conv (B, K-1, w); attn a (B, window, KV, D) ring each for k and
    v. O(window) in the context length; max_len only bounds positions."""
    del max_len
    w, k = cfg.lru_width, cfg.conv_kernel
    win, kv, hd = cfg.window, cfg.kv_pad, cfg.head_dim
    layers = []
    for kind in cfg.layer_pattern():
        if kind == "rec":
            layers.append({"h": ((batch, w), torch.float32),
                           "conv": ((batch, k - 1, w), dtype)})
        else:
            layers.append({name: ((batch, win, kv, hd), dtype)
                           for name in ("k", "v")})  # contract: allow(R6)
    return {"layers": layers, "pos": ((batch,), torch.int32)}
